#!/usr/bin/env python
"""Bring-up proof on NVIDIA GPUs: both arms' train and serve paths at the
published widths, every kernel compiled for the card, in ONE process.

    python chip_smoke.py              # one card: the phases below
    python chip_smoke.py --devices 4  # four cards: data-parallel parity only

One card:

1. device   — refuses anything but a GPU; prints the card (device_kind and
              nvidia-smi's name and power limit).
2. train    — `vitiq train` on the vit_synthetic19 and rawiq_synthetic19
              presets (the reference architectures, 19 classes) under the
              bf16 numerics for one short epoch, then `vitiq evaluate` on
              the checkpoint and `vitiq export` of a serving artifact.
3. serve    — `ServingArtifact.load` answers ragged requests that exercise
              bucket padding; logits must be finite, shaped [n, 19] and
              equal the model called directly on the request padded to
              the same bucket.
4. numerics — (a) f32 reference forward on the card vs on the host CPU;
              (b) bf16 production logits vs the f32 reference on the card,
              and what the attention kernel adds to bf16 rounding;
              (c) the Triton attention kernel vs the f32 reference at every
              served sequence length and width.

Every check prints its measured value beside its bound and the card. Any
failure exits non-zero. The last line is the JSON contract
{"ok": true, "device": {"platform", "kind", "count"}}. Work files go to
result/chip_smoke/ under the repo root.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "result" / "chip_smoke"

# bounds (see PERF.md "End-to-end metrics")
REFERENCE_HOST_REL = 1e-4   # (a) f32 on the card vs the host: no TF32 anywhere
# serve: the artifact's program vs the model called directly on the same
# bucket-padded batch. One program at one shape: equal up to an f32 ulp.
SERVE_REL = 1e-6
# (b) max |dlogit| / max |logit|. bf16 rounding through six post-norm
# layers leaves a mean |dlogit| of ~3.4e-3 whatever the attention path; a
# briefly trained model's logits are small (max ~0.5), so the ratio reads
# 2-4 % on the card for the plain bf16 path and the kernel alike (PERF.md).
BF16_REL = 5e-2
# (b) argmax agreement with f32 over all frames. On random frames a
# six-step model's top two logits are mostly near-ties, so bf16 rounding
# flips ~5 % of the ViT argmaxes with either attention path (PERF.md).
BF16_ARGMAX = 0.9
# (b) agreement the kernel may lose against bf16 with plain attention. The
# two bf16 paths round differently, so each flips its own ~5 % of near-tie
# frames: over NUMERICS_FRAMES the difference has a binomial spread of
# ~0.5 %; the bound is four of those.
KERNEL_ARGMAX_COST = 0.02
NUMERICS_FRAMES = 4096
ATTENTION_ABS = 2e-2        # (c) bf16 operands, f32 accumulation
# --devices 4: per-step loss and ||dP_4 - dP_1|| / ||dP_1|| (parameter
# updates after K steps). f32 reference numerics: only summation order
# differs. bf16: rounding differs with the per-device GEMM shapes, and
# AdamW's normalized update turns last-bit gradient differences on
# near-zero gradients into lr-sized ones, so its update bound is looser.
PARITY = {"reference": {"loss_rel": 1e-4, "update_rel": 1e-3},
          "tpu": {"loss_rel": 1e-3, "update_rel": 1e-1}}

ATTENTION_SHAPES = (  # (L, D, H): every served sequence length and width
    (129, 128, 8), (65, 128, 8), (17, 128, 8), (16, 128, 8),
    (65, 256, 8), (17, 64, 4), (1025, 128, 8))
ARMS = (("vit", "vit_synthetic19"), ("rawiq", "rawiq_synthetic19"))
FRAMES_PER_CLASS = 128  # 2,432 frames: six train steps of 256 at full width
REQUESTS = (1, 200, 256)
BUCKETS = "64,256"


class CheckFailed(AssertionError):
    pass


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Checks:
    """Prints every result beside the card, and records the checks that
    miss their bound (the run goes on so every check reports; main() then
    exits non-zero)."""

    def __init__(self, card: str = "card not read"):
        self.card = card
        self.failed = []

    def report(self, phase: str, **values) -> None:
        fields = " ".join(f"{k}={v}" for k, v in values.items())
        print(f"[{phase}] {fields} | card: {self.card}", flush=True)

    def check(self, phase: str, name: str, value: float, bound: float,
              higher_is_better: bool = False) -> None:
        ok = value >= bound if higher_is_better else value <= bound
        self.report(phase, check=name, value=repr(float(value)),
                    bound=("≥ " if higher_is_better else "≤ ") + repr(bound),
                    result="pass" if ok else "FAIL")
        if not ok:
            self.failed.append(f"{phase}/{name}: {value!r} vs bound {bound!r}")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def train_evaluate_export(checks: Checks, preset: str, work: Path,
                          frames_per_class: int, extra_args=()) -> dict:
    """`vitiq train` -> `vitiq evaluate` -> `vitiq export` for one preset.
    Each command's own output goes to work/logs/ (this script prints only
    lines that carry the card). Returns the experiment and artifact
    directories."""
    import contextlib

    from vitiq.cli import main

    name = f"smoke_{preset}"
    (work / "logs").mkdir(parents=True, exist_ok=True)

    def cli(args):
        with open(work / "logs" / f"{name}_{args[0]}.log", "w") as log, \
                contextlib.redirect_stdout(log):
            return main(args)

    exp_dir = work / "result" / "checkpoints" / name
    shutil.rmtree(exp_dir, ignore_errors=True)
    args = ["train", "--preset", preset, "--numerics", "tpu",
            "--frames_per_class", str(frames_per_class), "--num_epochs", "1",
            "--experiment_name", name, *extra_args]
    if cli(args) != 0:
        raise CheckFailed(f"train {preset} failed")
    summary = json.loads((exp_dir / "summary.json").read_text())
    checks.report("train", preset=preset, epochs=summary["epochs_run"],
                  best_val_loss=summary["best_val_loss"],
                  test_acc=summary["test_overall_accuracy"],
                  train_s=summary["train_wall_seconds"])
    if not (exp_dir / "model_best.npz").exists():
        raise CheckFailed(f"{preset}: no checkpoint written")
    if cli(["evaluate", "--checkpoint", str(exp_dir)]) != 0:
        raise CheckFailed(f"evaluate {preset} failed")
    report_txt = exp_dir / "evaluation" / "test_classification_report.txt"
    if "weighted avg" not in report_txt.read_text():
        raise CheckFailed(f"{preset}: evaluation report incomplete")
    artifact = work / "artifacts" / name
    shutil.rmtree(artifact, ignore_errors=True)
    if cli(["export", "--experiment_dir", str(exp_dir), "--output",
            str(artifact), "--batch_sizes", BUCKETS]) != 0:
        raise CheckFailed(f"export {preset} failed")
    return {"exp_dir": exp_dir, "artifact": artifact}


def serve_requests(checks: Checks, artifact: Path, exp_dir: Path,
                   sizes=REQUESTS, seed: int = 0) -> None:
    """Answer ragged requests from the exported artifact and compare with
    the model called directly on the same frames padded to the same
    bucket, then sliced."""
    import jax
    import numpy as np

    from vitiq.models import init_amc_params
    from vitiq.runner import build_forward_and_preprocess
    from vitiq.serve import ServingArtifact
    from vitiq.train.checkpoint import load_params

    art = ServingArtifact.load(artifact)
    cfg = art.config
    stats = json.loads((exp_dir / "normalization_stats.json").read_text())
    params = load_params(exp_dir / "model_best.npz",
                         init_amc_params(jax.random.PRNGKey(0), cfg.model))
    fwd, pre = build_forward_and_preprocess(cfg, stats)
    direct = jax.jit(lambda p, x: fwd(p, pre(x), train=False))
    rng = np.random.default_rng(seed)
    for n in sizes:
        x = rng.standard_normal((n, cfg.data.frame_len, 2)).astype(np.float32)
        logits = np.asarray(art.run(x))
        if logits.shape != (n, cfg.model.num_classes):
            raise CheckFailed(f"serve: shape {logits.shape} for {n} frames")
        if not np.isfinite(logits).all():
            raise CheckFailed(f"serve: non-finite logits for {n} frames")
        bucket = art._bucket(n)
        padded = np.pad(x, ((0, bucket - n), (0, 0), (0, 0)))
        want = np.asarray(direct(params, padded))[:n]
        rel = float(np.abs(logits - want).max() / max(np.abs(want).max(), 1e-6))
        checks.report("serve", arm=cfg.model.arm, request=n, bucket=bucket)
        checks.check("serve", f"{cfg.model.arm}_n{n}_vs_direct_rel", rel, SERVE_REL)


def reference_vs_host(cfg, batch: int, seed: int = 0) -> dict:
    """(a) The f32 reference forward on the default device vs the host CPU:
    max |d| / max |logit| for the preprocess path and the raw-embed GEMM."""
    import dataclasses

    import jax
    import numpy as np

    from vitiq.bench import FLAGSHIP_STATS
    from vitiq.dsp import preprocess_batch_rawiq, preprocess_batch_vit
    from vitiq.models import init_amc_params, make_forward

    cfg = dataclasses.replace(cfg, numerics="reference")
    params = init_amc_params(jax.random.PRNGKey(seed), cfg)
    x = np.random.default_rng(seed).standard_normal(
        (batch, cfg.seq_length, 2)).astype(np.float32)
    if cfg.arm == "vit":
        pre = lambda f: preprocess_batch_vit(f, FLAGSHIP_STATS, H=cfg.img_size_h,
                                             W=cfg.img_size_w)
    else:
        pre = lambda f: preprocess_batch_rawiq(f, FLAGSHIP_STATS)
    plain = make_forward(cfg)
    raw = make_forward(cfg, raw_stats=FLAGSHIP_STATS)
    paths = {"preprocess": lambda p, f: plain(p, pre(f), train=False),
             "raw_embed": lambda p, f: raw(p, f, train=False)}
    host = jax.devices("cpu")[0]
    out = {}
    for name, fn in paths.items():
        run = jax.jit(fn)
        on_device = np.asarray(run(params, x))
        on_host = np.asarray(run(jax.device_put(params, host),
                                 jax.device_put(x, host)))
        out[name] = float(np.abs(on_device - on_host).max()
                          / max(np.abs(on_host).max(), 1e-6))
    return out


def bf16_vs_reference(cfg, params, stats, x) -> dict:
    """(b) bf16 production logits vs the f32 reference on the same device.

    Returns the relative max deviation and the argmax agreement with f32,
    and the agreement that bf16 with plain XLA attention reaches: the
    difference is what the attention kernel costs beyond bf16 rounding
    (nothing where the kernel does not run, as on the CPU)."""
    import dataclasses

    import jax
    import numpy as np

    from vitiq.ops.attention import scaled_dot_product_attention
    from vitiq.runner import build_forward_and_preprocess

    logits = {}
    for label, numerics, attention_fn in (
            ("reference", "reference", None), ("production", "tpu", None),
            ("plain", "tpu", scaled_dot_product_attention)):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, numerics=numerics))
        fwd, pre = build_forward_and_preprocess(c, stats, attention_fn)
        logits[label] = np.asarray(
            jax.jit(lambda p, f: fwd(p, pre(f), train=False))(params, x))
    ref = logits["reference"]
    agree = {k: float((v.argmax(-1) == ref.argmax(-1)).mean())
             for k, v in logits.items()}
    return {"rel": float(np.abs(logits["production"] - ref).max()
                         / max(np.abs(ref).max(), 1e-6)),
            "argmax_agreement": agree["production"],
            "plain_argmax_agreement": agree["plain"],
            "kernel_argmax_cost": agree["plain"] - agree["production"]}


def attention_errors(shapes=ATTENTION_SHAPES, batch: int = 61,
                     interpret: bool = False, seed: int = 0) -> list:
    """(c) The Triton kernel on bf16 operands vs the f32 HIGHEST reference;
    max abs error per (L, D, H)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vitiq.ops.numerics import REFERENCE
    from vitiq.ops.pallas.flash_attention import (kernel_attention,
                                                  plain_packed_attention)

    rng = np.random.default_rng(seed)
    out = []
    for L, D, H in shapes:
        b = batch if L <= 129 else max(1, batch // 12)
        q, k, v = (jnp.asarray(rng.standard_normal((b, L, D)), jnp.float32)
                   for _ in range(3))
        want = jax.jit(lambda a, c, e: plain_packed_attention(
            a, c, e, H, REFERENCE))(q, k, v)
        got = jax.jit(lambda a, c, e: kernel_attention(
            a, c, e, H, interpret=interpret))(
                *(t.astype(jnp.bfloat16) for t in (q, k, v)))
        err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)))
        out.append({"L": L, "D": D, "H": H, "batch": b, "max_abs_err": err})
    return out


def data_parallel_parity(n_devices: int, steps: int, batch: int,
                         model_overrides=None, seed: int = 0) -> dict:
    """ViT flagship training, data-parallel over `n_devices` vs the same
    steps on one of those devices, in this process. Dropout is off so both
    runs see the same function; returns per-step losses and the relative
    L2 distance between the two runs' parameter updates."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vitiq.bench import FLAGSHIP_STATS
    from vitiq.config import ExperimentConfig
    from vitiq.models import init_amc_params
    from vitiq.parallel.mesh import batch_sharding, make_mesh, shard_params
    from vitiq.runner import build_forward_and_preprocess
    from vitiq.train.loop import make_train_step
    from vitiq.train.optim import create_train_state, make_optimizer

    cfg = ExperimentConfig.vit_synthetic19()
    cfg.model = dataclasses.replace(cfg.model, **{
        "numerics": "tpu", "drop_prob": 0.0, **(model_overrides or {})})
    cfg.train.batch_size = batch
    fwd, pre = build_forward_and_preprocess(cfg, FLAGSHIP_STATS)
    tx = make_optimizer(cfg.train)
    init = jax.device_get(init_amc_params(jax.random.PRNGKey(seed), cfg.model))
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((steps, batch, cfg.data.frame_len, 2)).astype(np.float32)
    ys = rng.integers(0, cfg.model.num_classes, (steps, batch)).astype(np.int32)
    devices = jax.devices()[:n_devices]

    def run(devs):
        mesh = make_mesh(data=len(devs), model=1, devices=devs)
        step = make_train_step(fwd, tx, cfg.train.label_smoothing, pre)
        with mesh:
            state = create_train_state(shard_params(
                jax.tree_util.tree_map(jnp.array, init), mesh), cfg.train)
            sh = batch_sharding(mesh)
            losses = []
            for i in range(steps):
                state, m = step(state, jax.device_put(xs[i], sh),
                                jax.device_put(ys[i], sh),
                                jax.random.PRNGKey(seed + 1))
                losses.append(float(m["loss"]))
        flat = np.concatenate([np.asarray(a, np.float64).ravel()
                               for a in jax.tree_util.tree_leaves(state.params)])
        return np.asarray(losses), flat

    p0 = np.concatenate([np.asarray(a, np.float64).ravel()
                         for a in jax.tree_util.tree_leaves(init)])
    loss_n, p_n = run(devices)
    loss_1, p_1 = run(devices[:1])
    d_n, d_1 = p_n - p0, p_1 - p0
    return {"losses_n": loss_n.tolist(), "losses_1": loss_1.tolist(),
            "loss_rel": float(np.max(np.abs(loss_n - loss_1) / np.abs(loss_1))),
            "update_rel": float(np.linalg.norm(d_n - d_1) / np.linalg.norm(d_1))}


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def require_gpu(n_devices: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devices[0].platform!r}")
    if len(devices) < n_devices:
        raise SystemExit(f"chip_smoke: needs {n_devices} GPUs, found "
                         f"{len(devices)}")
    return devices


def one_card(checks: Checks) -> None:
    import jax
    import numpy as np

    from vitiq.bench import ARM_CONFIGS
    from vitiq.config import ExperimentConfig
    from vitiq.models import init_amc_params
    from vitiq.train.checkpoint import load_params

    runs = {arm: train_evaluate_export(checks, preset, WORK, FRAMES_PER_CLASS)
            for arm, preset in ARMS}
    for arm, run in runs.items():
        serve_requests(checks, run["artifact"], run["exp_dir"])

    for arm in ("vit", "rawiq"):
        for path, rel in reference_vs_host(ARM_CONFIGS[arm]("reference"),
                                           batch=16).items():
            checks.check("numerics-a", f"{arm}_{path}_device_vs_host_rel", rel,
                  REFERENCE_HOST_REL)

    for arm, preset in ARMS:
        exp_dir = runs[arm]["exp_dir"]
        cfg = ExperimentConfig.from_json(str(exp_dir / "config.json"))
        stats = json.loads((exp_dir / "normalization_stats.json").read_text())
        params = load_params(exp_dir / "model_best.npz",
                             init_amc_params(jax.random.PRNGKey(0), cfg.model))
        x = np.random.default_rng(1).standard_normal(
            (NUMERICS_FRAMES, cfg.data.frame_len, 2)).astype(np.float32)
        res = bf16_vs_reference(cfg, params, stats, x)
        checks.report("numerics-b", arm=arm, frames=len(x),
                      plain_attention_argmax_agreement=res["plain_argmax_agreement"])
        checks.check("numerics-b", f"{arm}_bf16_vs_f32_rel", res["rel"], BF16_REL)
        checks.check("numerics-b", f"{arm}_bf16_vs_f32_argmax",
                     res["argmax_agreement"], BF16_ARGMAX, higher_is_better=True)
        checks.check("numerics-b", f"{arm}_kernel_argmax_cost",
                     res["kernel_argmax_cost"], KERNEL_ARGMAX_COST)

    for r in attention_errors():
        checks.check("numerics-c", f"attention_L{r['L']}_D{r['D']}_H{r['H']}_B{r['batch']}",
              r["max_abs_err"], ATTENTION_ABS)


def four_cards(checks: Checks, n_devices: int) -> None:
    for numerics, bounds in PARITY.items():
        res = data_parallel_parity(n_devices, steps=5, batch=256,
                                   model_overrides={"numerics": numerics})
        checks.report("data-parallel", numerics=numerics, devices=n_devices, steps=5,
               global_batch=256, losses_dp=res["losses_n"],
               losses_1=res["losses_1"])
        checks.check("data-parallel", f"{numerics}_loss_rel", res["loss_rel"],
              bounds["loss_rel"])
        checks.check("data-parallel", f"{numerics}_param_update_rel_l2",
              res["update_rel"], bounds["update_rel"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the data-parallel training parity "
                         "check across four cards")
    args = ap.parse_args(argv)

    devices = require_gpu(args.devices)
    checks = Checks(card_line())
    d = devices[0]
    checks.report("device", platform=d.platform, device_kind=repr(d.device_kind),
           count=len(devices))

    WORK.mkdir(parents=True, exist_ok=True)
    import os

    os.chdir(WORK)  # `vitiq train` writes result/ under the working dir
    if args.devices == 4:
        four_cards(checks, args.devices)
    else:
        one_card(checks)
    if checks.failed:
        raise CheckFailed("; ".join(checks.failed))
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
