#!/usr/bin/env python
"""Attention, dropout-generator and remat A/B on one NVIDIA GPU, in one
process.

    python scripts/attention_ab.py --out result/attention_ab.jsonl
    python scripts/attention_ab.py --phases train,dropout --runs 5
    JAX_PLATFORMS=cpu python scripts/attention_ab.py --tiny   # plumbing only

Phases; each measurement is one JSON line, tagged with the card's name and
power limit:

alone    one attention call at the ViT flagship serving shape (B x 129
         tokens, d128/H8, bf16): the Triton kernel, cuDNN through
         `jax.nn.dot_product_attention`, and the plain XLA einsum path.
serve    ViT flagship serving end to end (`bench_fused_infer`) with each.
train    rawIQ reference training at batch 256 (`bench_train_step`): the
         kernel and the plain path alternating, --runs runs each, then the
         median and range of their step times; cuDNN once.
dropout  the same train step (kernel) with threefry and RBG dropout keys,
         alternating, --runs runs each.
remat    conv1d (1025 tokens) training at batch 256: temporary device memory
         of the compiled step and its time, with and without
         rematerializing each encoder layer, for the kernel and the plain
         path.

cuDNN refuses some sequence lengths (65, 1025); a refusal is recorded as
such. Any other error stops the script with a non-zero exit.

The attention implementation is swapped by rebinding
`vitiq.ops.pallas.flash_attention.fused_attention`, which `make_forward`
reads when it builds a bf16 forward.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vitiq import bench  # noqa: E402
from vitiq.models import encoder  # noqa: E402
from vitiq.ops.numerics import BF16  # noqa: E402
from vitiq.ops.pallas import flash_attention as fa  # noqa: E402

KERNEL = fa.fused_attention
PHASES = ("alone", "serve", "train", "dropout", "remat")
FULL = {"serve_batch": 16384, "train_batch": 256, "conv1d_batch": 256}
TINY = {"serve_batch": 16, "train_batch": 8, "conv1d_batch": 2}


def cudnn_attention(q, k, v, n_head, mask=None, policy=BF16,
                    return_scores=False):
    B, L, D = q.shape
    heads = lambda t: policy.cast_compute(t).reshape(B, L, n_head, D // n_head)
    return jax.nn.dot_product_attention(
        heads(q), heads(k), heads(v), implementation="cudnn").reshape(B, L, D)


def plain_attention(q, k, v, n_head, mask=None, policy=BF16,
                    return_scores=False):
    return fa.plain_packed_attention(q, k, v, n_head, policy)


cudnn_attention.packed_layout = True
plain_attention.packed_layout = True
IMPLS = {"kernel": KERNEL, "cudnn": cudnn_attention, "plain": plain_attention}


@contextlib.contextmanager
def attention(name: str):
    fa.fused_attention = IMPLS[name]
    try:
        yield
    finally:
        fa.fused_attention = KERNEL


@contextlib.contextmanager
def remat_layers(on: bool):
    """Rematerialize each encoder layer in the backward (jax.checkpoint)."""
    layer = encoder.encoder_layer_apply
    if on:
        def remat(p, x, n_head, drop_prob, rng, train, **kw):
            return jax.checkpoint(lambda p, x, rng: layer(
                p, x, n_head, drop_prob, rng, train, **kw))(p, x, rng)

        encoder.encoder_layer_apply = remat
    try:
        yield
    finally:
        encoder.encoder_layer_apply = layer


class Log:
    def __init__(self, out: Path, card: str):
        out.parent.mkdir(parents=True, exist_ok=True)
        self.file = open(out, "a")
        self.card = card

    def __call__(self, **rec) -> None:
        line = json.dumps({**rec, "card": self.card})
        print(line, flush=True)
        self.file.write(line + "\n")
        self.file.flush()


def refused(log: Log, fn, **tags):
    """Run `fn`; record cuDNN's refusal of a shape instead of failing."""
    try:
        return fn()
    except NotImplementedError as e:
        log(**tags, refused=str(e)[:300])
        return None


def spread(values) -> dict:
    v = np.asarray(values)
    return {"median": float(np.median(v)), "min": float(v.min()),
            "max": float(v.max()), "runs": len(v)}


def phase_alone(log: Log, sizes: dict, impls) -> None:
    B, L, D, H = sizes["serve_batch"], 129, 128, 8
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((B, L, D)), jnp.bfloat16)
               for _ in range(3))
    for name in impls:
        fn = IMPLS[name]
        t = refused(log, lambda: bench._time_amortized(
            lambda i, a, b, c: fn(a + i.astype(a.dtype) * 1e-3, b, c, H,
                                  policy=BF16), (q, k, v)),
            phase="alone", impl=name)
        if t:
            log(phase="alone", impl=name, batch=B, L=L, ms=t["p50_s"] * 1e3,
                best_ms=t["best_s"] * 1e3)


def phase_serve(log: Log, sizes: dict, impls) -> None:
    for name in impls:
        with attention(name):
            r = refused(log, lambda: bench.bench_fused_infer(
                "vit", sizes["serve_batch"]), phase="serve", impl=name)
        if r:
            log(phase="serve", impl=name, batch=r["batch_size"],
                frames_per_s=r["value"], ms=r["p50_latency_ms"])


def phase_train(log: Log, sizes: dict, runs: int, impls) -> None:
    B = sizes["train_batch"]
    step_ms = {name: [] for name in ("kernel", "plain")}
    for i in range(runs):
        for name in (("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")):
            with attention(name):
                r = bench.bench_train_step("rawiq", B)
            step_ms[name].append(r["p50_step_ms"])
            log(phase="train", impl=name, run=i, batch=B,
                frames_per_s=r["value"], ms=r["p50_step_ms"])
    for name, ms in step_ms.items():
        log(phase="train_summary", impl=name, batch=B, ms=spread(ms))
    if "cudnn" in impls:
        with attention("cudnn"):
            r = refused(log, lambda: bench.bench_train_step("rawiq", B),
                        phase="train", impl="cudnn")
        if r:
            log(phase="train", impl="cudnn", batch=B, frames_per_s=r["value"],
                ms=r["p50_step_ms"])


def phase_dropout(log: Log, sizes: dict, runs: int) -> None:
    B = sizes["train_batch"]
    keys = {"threefry": lambda: jax.random.PRNGKey(0),
            "rbg": lambda: jax.random.key(0, impl="rbg")}
    step_ms = {name: [] for name in keys}
    for i in range(runs):
        for name in (("threefry", "rbg") if i % 2 == 0 else ("rbg", "threefry")):
            r = bench.bench_train_step("rawiq", B, dropout_key=keys[name]())
            step_ms[name].append(r["p50_step_ms"])
            log(phase="dropout", generator=name, run=i, batch=B,
                frames_per_s=r["value"], ms=r["p50_step_ms"])
    for name, ms in step_ms.items():
        log(phase="dropout_summary", generator=name, batch=B, ms=spread(ms))


def phase_remat(log: Log, sizes: dict) -> None:
    from vitiq.config import TrainConfig
    from vitiq.models import init_amc_params
    from vitiq.train.loop import make_train_step
    from vitiq.train.optim import create_train_state, make_optimizer

    B = sizes["conv1d_batch"]
    cfg = bench.flagship_conv1d_config("tpu")
    tcfg = TrainConfig(batch_size=B)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((B, cfg.seq_length, 2)), jnp.float32)
    y = jnp.zeros((B,), jnp.int32)
    key = jax.random.PRNGKey(0)
    for name in ("kernel", "plain"):
        for remat in (False, True):
            with attention(name), remat_layers(remat):
                fwd, pre = bench._forward_and_pre(cfg)
                tx = make_optimizer(tcfg)
                state = create_train_state(
                    init_amc_params(jax.random.PRNGKey(0), cfg), tcfg)
                step = make_train_step(fwd, tx, tcfg.label_smoothing, pre)
                t0 = time.perf_counter()
                compiled = step.lower(state, x, y, key).compile()
                compile_s = time.perf_counter() - t0
            temp = compiled.memory_analysis().temp_size_in_bytes
            state, m = compiled(state, x, y, key)
            float(m["loss"])
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(10):
                    state, m = compiled(state, x, y, key)
                float(m["loss"])
                times.append((time.perf_counter() - t0) / 10 * 1e3)
            log(phase="remat", impl=name, remat=remat, batch=B,
                temp_gb=temp / 1e9, compile_s=compile_s, ms=spread(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--runs", type=int, default=3,
                    help="alternating runs per arm in train and dropout")
    ap.add_argument("--out", type=Path, default=ROOT / "result" / "attention_ab.jsonl")
    ap.add_argument("--tiny", action="store_true",
                    help="toy batches on any backend, without cuDNN: "
                         "rehearses the plumbing, measures nothing")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    dev = jax.devices()[0]
    if args.tiny:
        card, sizes, impls = "rehearsal, no card", TINY, ("kernel", "plain")
    elif dev.platform != "gpu":
        raise SystemExit(f"attention_ab: needs a GPU, JAX found {dev.platform!r}")
    else:
        from chip_smoke import card_line

        card, sizes, impls = card_line(), FULL, tuple(IMPLS)
    log = Log(args.out, card)
    log(phase="device", platform=dev.platform, device_kind=dev.device_kind,
        count=len(jax.devices()), jax=jax.__version__)
    if "alone" in phases:
        phase_alone(log, sizes, impls)
    if "serve" in phases:
        phase_serve(log, sizes, impls)
    if "train" in phases:
        phase_train(log, sizes, args.runs, impls)
    if "dropout" in phases:
        phase_dropout(log, sizes, args.runs)
    if "remat" in phases:
        phase_remat(log, sizes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
