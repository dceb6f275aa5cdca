"""Symbol timing recovery.

Implements the four methods named by the reference's (deleted) DSP module's
test contract (ref: test_dsp_functions.py:117-156): `simple_energy`,
`simple_correlation` (vectorized phase pickers) and `gardner`,
`mueller_muller` (sequential error-feedback loops). Quality bar from the
contract: on RRC-shaped QPSK at sps=2 / 20 dB each method recovers ~= the true
symbol count with small mean timing error in samples.

Design notes: the feedback loops are data-dependent recurrences, so they
compile to `lax.scan` with a fixed trip count (n // sps) and a validity mask —
no dynamic shapes ever reach XLA. The phase pickers are pure vector reductions.
Host-facing wrappers return plain numpy index arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _lin_interp(x: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation of 1-D signal x at fractional position(s) pos."""
    n = x.shape[0]
    pos = jnp.clip(pos, 0.0, n - 1.0)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, n - 1)
    frac = pos - lo
    return x[lo] * (1.0 - frac) + x[hi] * frac


# --------------------------------------------------------------------------
# vectorized phase pickers
# --------------------------------------------------------------------------

def simple_timing_recovery(i_signal, q_signal, sps: int, method: str = "energy") -> np.ndarray:
    """Pick the best of the `sps` decimation phases and sample at symbol rate.

    method='energy':       phase maximizing the mean symbol energy |x|^2
                           (the eye is widest where the matched-filter output
                           peaks).
    method='correlation':  phase maximizing symbol-to-symbol correlation
                           sum |x[p] . x[p+sps]| — peaks align consecutive
                           symbol cores rather than transitions.

    Returns integer sample indices, ~len(signal)//sps of them.
    """
    i_sig = np.asarray(i_signal, dtype=np.float64)
    q_sig = np.asarray(q_signal, dtype=np.float64)
    n = len(i_sig)
    num_sym = n // sps
    scores = np.empty(sps)
    for phase in range(sps):
        idx = np.arange(phase, phase + num_sym * sps, sps)
        idx = idx[idx < n]
        si, sq = i_sig[idx], q_sig[idx]
        if method == "energy":
            scores[phase] = np.mean(si * si + sq * sq)
        elif method == "correlation":
            scores[phase] = np.mean(np.abs(si[:-1] * si[1:] + sq[:-1] * sq[1:]))
        else:
            raise ValueError(f"unknown simple timing method {method!r}")
    best = int(np.argmax(scores))
    idx = np.arange(best, best + num_sym * sps, sps)
    return idx[idx < n]


# --------------------------------------------------------------------------
# error-feedback loops (lax.scan)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("sps", "num_steps"))
def _gardner_scan(i_sig, q_sig, sps: int, num_steps: int, gain: float = 0.3,
                  p0=None):
    """Gardner TED: e = (y[k] - y[k-1]) * y[k-1/2] summed over I/Q.

    The error is zero when the mid-symbol sample sits on the zero-crossing /
    symbol transition, i.e. when the strobe sits on the symbol peak.
    `p0` overrides the initial strobe position (hybrid mode starts from the
    coarse energy phase).
    """
    n = i_sig.shape[0]

    def step(pos, _):
        yi = _lin_interp(i_sig, pos)
        yi_prev = _lin_interp(i_sig, pos - sps)
        yi_mid = _lin_interp(i_sig, pos - sps / 2.0)
        yq = _lin_interp(q_sig, pos)
        yq_prev = _lin_interp(q_sig, pos - sps)
        yq_mid = _lin_interp(q_sig, pos - sps / 2.0)
        err = (yi - yi_prev) * yi_mid + (yq - yq_prev) * yq_mid
        next_pos = pos + sps - jnp.clip(gain * err, -0.5 * sps, 0.5 * sps)
        valid = pos <= n - 1
        return next_pos, (pos, valid)

    init = jnp.asarray(float(sps)) if p0 is None else jnp.asarray(p0, jnp.float32)
    _, (positions, valid) = jax.lax.scan(step, init, None, length=num_steps)
    return positions, valid


@functools.partial(jax.jit, static_argnames=("sps", "num_steps"))
def _mueller_muller_scan(i_sig, q_sig, sps: int, num_steps: int,
                         gain: float = 0.1, p0=None):
    """Mueller-Müller TED: e = sign(y[k-1])*y[k] - sign(y[k])*y[k-1], I + Q.

    Decision-directed; works at 1 sample/symbol internally, so the strobe
    advances by sps with the error steering the fractional phase. With this
    operand order the measured S-curve is POSITIVE when sampling early, so the
    correction is ADDED to the strobe position (opposite of Gardner's, whose
    S-curve is positive when late).
    """
    n = i_sig.shape[0]

    def step(pos, _):
        yi = _lin_interp(i_sig, pos)
        yi_prev = _lin_interp(i_sig, pos - sps)
        yq = _lin_interp(q_sig, pos)
        yq_prev = _lin_interp(q_sig, pos - sps)
        err = (jnp.sign(yi_prev) * yi - jnp.sign(yi) * yi_prev) + (
            jnp.sign(yq_prev) * yq - jnp.sign(yq) * yq_prev
        )
        next_pos = pos + sps + jnp.clip(gain * err, -0.5 * sps, 0.5 * sps)
        valid = pos <= n - 1
        return next_pos, (pos, valid)

    init = jnp.asarray(float(sps)) if p0 is None else jnp.asarray(p0, jnp.float32)
    _, (positions, valid) = jax.lax.scan(step, init, None, length=num_steps)
    return positions, valid


def _scan_to_indices(positions, valid, n: int) -> np.ndarray:
    pos = np.asarray(positions)[np.asarray(valid)]
    idx = np.rint(pos).astype(np.int64)
    return np.clip(idx, 0, n - 1)


def batched_timing_positions(i_sig: jnp.ndarray, q_sig: jnp.ndarray, sps: int,
                             method: str):
    """Batched error-feedback timing recovery: [B, L] I/Q -> strobe positions.

    vmaps the per-frame `lax.scan` loops over the frame axis (the scans have a
    fixed trip count L//sps, so the whole batch is one XLA program — the
    device-path twin of timing_recovery_{gardner,mueller_muller}).

    Returns (positions [B, L//sps] float, valid [B, L//sps] bool).
    """
    if sps < 2:
        raise ValueError("error-feedback timing recovery requires sps >= 2")
    scan = {"gardner": _gardner_scan, "mueller_muller": _mueller_muller_scan}[method]
    num_steps = i_sig.shape[1] // sps
    return jax.vmap(lambda i, q: scan(i, q, sps, num_steps))(i_sig, q_sig)


def hybrid_timing_positions(i_sig: jnp.ndarray, q_sig: jnp.ndarray, sps: int,
                            method: str, window: int = 64):
    """HYBRID timing recovery (VERDICT r3 item 7): coarse energy-phase pick
    -> a SHORT error-feedback tracking window -> steady-state fractional
    phase -> vectorized strobes for the whole frame.

    The full feedback loops scan L//sps sequential steps per frame (512 at
    conv-rate frames) — at batch scale that sequential chain IS the e2e
    Gardner floor. But the
    loop's only job on a static-timing frame is to FIND the fractional
    phase; once converged, open-loop extrapolation samples the remaining
    symbols identically. So: start at the best integer decimation phase
    (initial error <= 0.5 sample), track for `window` steps, estimate the
    steady-state strobe phase as the CIRCULAR mean of the second
    half-window's fractional positions (period sps), and emit uniform
    strobes frac + k*sps. Sequential length drops L//sps -> window (8x at
    512/64).

    Caveat: uniform strobes assume intra-frame clock drift << 1 sample
    (true for the DSP contract fixtures and ~0.5 sample at the impairment
    corpus's 500 ppm worst case); drifting channels should use the full
    loops (`batched_timing_positions` / hybrid_window=0).

    Returns (positions [B, L//sps] float32, valid [B, L//sps] all-True).
    """
    if sps < 2:
        raise ValueError("error-feedback timing recovery requires sps >= 2")
    scan = {"gardner": _gardner_scan, "mueller_muller": _mueller_muller_scan}[method]
    B, n = i_sig.shape
    n_sym = n // sps

    def one(i1, q1):
        # coarse: best integer decimation phase by mean symbol energy
        ph = (i1[: n_sym * sps].reshape(n_sym, sps) ** 2
              + q1[: n_sym * sps].reshape(n_sym, sps) ** 2)
        p0 = jnp.argmax(jnp.mean(ph, axis=0)).astype(jnp.float32)
        # short tracking window from the coarse phase (start one symbol in so
        # the TED's pos-sps / pos-sps/2 taps stay in range)
        positions, _ = scan(i1, q1, sps, num_steps=window, p0=p0 + sps)
        # steady-state fractional phase: circular mean (period sps) over the
        # second half-window — the first half is convergence transient
        theta = positions * (2.0 * jnp.pi / sps)
        w = (jnp.arange(window) >= window // 2).astype(theta.dtype)
        frac = jnp.arctan2(jnp.sum(jnp.sin(theta) * w),
                           jnp.sum(jnp.cos(theta) * w))
        frac = (frac * (sps / (2.0 * jnp.pi))) % sps
        pos = frac + sps * jnp.arange(n_sym, dtype=jnp.float32)
        return jnp.clip(pos, 0.0, n - 1.0)

    positions = jax.vmap(one)(i_sig, q_sig)
    return positions, jnp.ones(positions.shape, bool)


def timing_recovery_gardner(i_signal, q_signal, sps: int) -> np.ndarray:
    """Gardner timing recovery -> integer sample indices (~n/sps symbols)."""
    if sps < 2:
        raise ValueError("Gardner timing recovery requires sps >= 2")
    i_sig = jnp.asarray(i_signal, jnp.float32)
    q_sig = jnp.asarray(q_signal, jnp.float32)
    n = i_sig.shape[0]
    positions, valid = _gardner_scan(i_sig, q_sig, sps, num_steps=n // sps)
    return _scan_to_indices(positions, valid, n)


def timing_recovery_mueller_muller(i_signal, q_signal, sps: int) -> np.ndarray:
    """Mueller-Müller timing recovery -> integer sample indices."""
    if sps < 2:
        raise ValueError("Mueller-Müller timing recovery requires sps >= 2")
    i_sig = jnp.asarray(i_signal, jnp.float32)
    q_sig = jnp.asarray(q_signal, jnp.float32)
    n = i_sig.shape[0]
    positions, valid = _mueller_muller_scan(i_sig, q_sig, sps, num_steps=n // sps)
    return _scan_to_indices(positions, valid, n)
