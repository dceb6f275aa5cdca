"""MDF-NET: the multi-domain-fusion CNN-LSTM workload from the reference's
exploratory notebook (ref: ViT/MDF_NET.ipynb).

The notebook trains an external `CNN_LSTM_new.create_multi_domain_model(
num_classes, dropout_rate=0.7)` on triples produced by its
DualStreamRadioMLDataset (cell 7): amplitude image [B, 1, 32, 32] scaled by
the per-sample max, phase image [B, 1, 32, 32] scaled by pi, and the I/Q
sequence [B, 1024, 2] — all derived from the z-scored signal (pass the
dataset stats to `preprocess_batch_mdf(x, stats=...)` for those exact
semantics) (call signature: cell 19, `model(amp, phase, iq_seq)`). The `CNN_LSTM_new` module itself is MISSING
from the reference tree (SURVEY.md §2.7), so the internals below are a
capability-equivalent reconstruction, not a port: two weight-tied-
architecture (separately parameterized) CNN towers for the amplitude/phase
images, a strided-conv front end + LSTM for the I/Q sequence (the stride-8
front end keeps the `lax.scan` at 128 steps instead of 1024 — sequential
scan steps are the one thing the matrix units cannot parallelize), and a fused MLP
head over the concatenated domain features.

Factory API mirrors the notebook's:
    init_fn, apply_fn = create_multi_domain_model(num_classes, dropout_rate)
    params = init_fn(jax.random.PRNGKey(0))
    logits = apply_fn(params, amp, phase, iq_seq, train=..., rng=...)

Input transform: `vitiq.dsp.preprocess_batch_mdf` (cell-7 semantics).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from vitiq.models.layers import dropout, linear_apply, linear_init

_CNN_CHANNELS: Sequence[int] = (32, 64, 128)
_IQ_CONV_CH = 64
_IQ_CONV_STRIDE = 8
_LSTM_HIDDEN = 128
_FUSION_HIDDEN = 256


def _conv_init(rng, kh, kw, c_in, c_out):
    """torch.nn.Conv2d default init (kaiming-uniform-flavored bounds)."""
    k_rng, b_rng = jax.random.split(rng)
    fan_in = kh * kw * c_in
    bound = 1.0 / jnp.sqrt(jnp.asarray(fan_in, jnp.float32))
    return {
        "kernel": jax.random.uniform(
            k_rng, (c_out, c_in, kh, kw), jnp.float32, -bound, bound),
        "bias": jax.random.uniform(b_rng, (c_out,), jnp.float32, -bound, bound),
    }


def _conv2d(params, x, stride=1):
    y = jax.lax.conv_general_dilated(
        x, params["kernel"], (stride, stride), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return y + params["bias"][None, :, None, None]


def _maxpool2(x):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 1, 2, 2), (1, 1, 2, 2), "VALID")


def _cnn_tower_init(rng, c_in=1):
    rngs = jax.random.split(rng, len(_CNN_CHANNELS))
    params = []
    for r, c_out in zip(rngs, _CNN_CHANNELS):
        params.append(_conv_init(r, 3, 3, c_in, c_out))
        c_in = c_out
    return params


def _cnn_tower_apply(params, img):
    """[B, 1, H, W] -> [B, C_last] (3x conv-relu-pool, global average)."""
    x = img
    for p in params:
        x = jnp.maximum(_conv2d(p, x), 0.0)
        x = _maxpool2(x)
    return jnp.mean(x, axis=(2, 3))


def _lstm_init(rng, d_in, d_hidden):
    r_x, r_h = jax.random.split(rng)
    # torch.nn.LSTM packs the 4 gates (i, f, g, o) on the output dim
    return {
        "wx": linear_init(r_x, d_in, 4 * d_hidden),
        "wh": linear_init(r_h, d_hidden, 4 * d_hidden),
    }


def _lstm_apply(params, xs, d_hidden):
    """xs [B, T, D] -> final hidden state [B, H] via lax.scan."""
    B = xs.shape[0]
    # hoist the input projection out of the scan: one big [B*T, D] GEMM;
    # the scan carries only the [B, H] recurrent GEMM
    gx = linear_apply(params["wx"], xs)  # [B, T, 4H]

    def step(carry, gx_t):
        h, c = carry
        gates = gx_t + h @ params["wh"]["kernel"] + params["wh"]["bias"]
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (h, c), None

    init = (jnp.zeros((B, d_hidden), gx.dtype), jnp.zeros((B, d_hidden), gx.dtype))
    (h, _), _ = jax.lax.scan(step, init, gx.transpose(1, 0, 2))
    return h


def create_multi_domain_model(num_classes: int, dropout_rate: float = 0.7):
    """Factory mirroring the notebook's `CNN_LSTM_new` API (MDF_NET.ipynb
    cell 16). Returns (init_fn, apply_fn)."""

    def init_fn(rng):
        r_amp, r_ph, r_iqc, r_lstm, r_f1, r_f2 = jax.random.split(rng, 6)
        d_fused = 2 * _CNN_CHANNELS[-1] + _LSTM_HIDDEN
        return {
            "amp_cnn": _cnn_tower_init(r_amp),
            "phase_cnn": _cnn_tower_init(r_ph),
            # conv1d front end as a conv2d with a 1-high kernel
            "iq_conv": _conv_init(r_iqc, 1, _IQ_CONV_STRIDE, 2, _IQ_CONV_CH),
            "lstm": _lstm_init(r_lstm, _IQ_CONV_CH, _LSTM_HIDDEN),
            "fuse1": linear_init(r_f1, d_fused, _FUSION_HIDDEN),
            "head": linear_init(r_f2, _FUSION_HIDDEN, num_classes),
        }

    def apply_fn(params, amp, phase, iq_seq, train: bool = False,
                 rng: Optional[jax.Array] = None):
        """amp/phase [B, 1, 32, 32], iq_seq [B, 1024, 2] -> [B, num_classes]."""
        f_amp = _cnn_tower_apply(params["amp_cnn"], amp)
        f_ph = _cnn_tower_apply(params["phase_cnn"], phase)
        # [B, L, 2] -> NCHW [B, 2, 1, L] -> strided conv -> [B, T, C]
        x = iq_seq.transpose(0, 2, 1)[:, :, None, :]
        x = jax.lax.conv_general_dilated(
            x, params["iq_conv"]["kernel"], (1, _IQ_CONV_STRIDE), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        x = x + params["iq_conv"]["bias"][None, :, None, None]
        x = jnp.maximum(x, 0.0)[:, :, 0, :].transpose(0, 2, 1)  # [B, T, C]
        f_iq = _lstm_apply(params["lstm"], x, _LSTM_HIDDEN)

        fused = jnp.concatenate([f_amp, f_ph, f_iq], axis=-1)
        # train=True without an rng runs dropout-free (torch-eval semantics
        # for the masks) rather than crashing — the notebook's call sites
        # always train with AMP+dropout, but the factory contract shouldn't
        # require an rng to smoke-test the train path
        drop_on = train and rng is not None
        r1, r2 = jax.random.split(rng) if drop_on else (None, None)
        fused = dropout(fused, dropout_rate, r1, drop_on)
        hid = jnp.maximum(linear_apply(params["fuse1"], fused), 0.0)
        hid = dropout(hid, dropout_rate, r2, drop_on)
        return linear_apply(params["head"], hid).astype(jnp.float32)

    return init_fn, apply_fn
