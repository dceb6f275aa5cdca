"""Throughput / latency benchmarks.

Headline metric (BASELINE.json): classified IQ frames/sec/chip with the
END-TO-END fused path — z-score normalize + reshape/patchify + encoder + head
in ONE jit program, input = raw [B, 1024, 2] frames already resident in
device memory (storage decoupled from compute, SURVEY.md §7.3). The reference's only
published throughput is ~2,330 frames/s train @ bs=256 on an unspecified CUDA
GPU (ref README.md:458-473); the north-star target is 1M frames/s/chip.

All benchmarks time K dependent steps inside one device call after an
untimed warmup (the first call compiles) and report the p50 per-step slope
over repeated windows (_slope_timing). Every result names the device it ran
on (device_info).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vitiq.config import ModelConfig
from vitiq.dsp import preprocess_batch_rawiq, preprocess_batch_vit
from vitiq.dsp.filtering import matched_filter_batch
from vitiq.models import init_amc_params, make_forward

FLAGSHIP_STATS = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
REFERENCE_GPU_TRAIN_FPS = 2330.0  # README.md:458-473 illustrative number
TARGET_FPS = 1_000_000.0  # BASELINE.json north star


def flagship_vit_config(numerics: str = "tpu") -> ModelConfig:
    """The reference's production ViT arm (d128/L6/H8, patch 4, 19 classes)."""
    return ModelConfig(arm="vit", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=512, drop_prob=0.1, patch_size=4,
                       numerics=numerics)


def flagship_rawiq_config(numerics: str = "tpu") -> ModelConfig:
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=16, numerics=numerics)


def rawiq_seg64_config(numerics: str = "tpu") -> ModelConfig:
    """rawIQ segment-64 (17 tokens) — the reference's production_rawIQv1
    tokenization (seg=64)."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=64, numerics=numerics)


def rawiq_best_config(numerics: str = "tpu") -> ModelConfig:
    """The reference's BEST published checkpoint geometry (rawIQ
    exp_L9_H8_F1024_W1e-3, 63.44%): d256/L9/H8/seg16 — 65 tokens at
    twice the flagship's width (ref: transformer_rawIQ/result/checkpoints/
    exp_L9_H8_F1024_W1e-3/config.json)."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=256, n_head=8,
                       n_layers=9, ffn_hidden=1024, drop_prob=0.1,
                       segment_size=16, numerics=numerics)


def rawiq_seg64_mp_config(numerics: str = "tpu") -> ModelConfig:
    """rawIQ segment-64 with MEAN-POOL readout (use_cls_token=False — the
    reference's own pooling flag, transformer_rawIQ.py:88-93): 16 tokens,
    a power of two with no CLS row. Accuracy of mean-pool vs CLS
    (scripts/pool_gate.py, paired seeds, two regimes): no detectable cost — weak regime +0.68 pts t=+8.66, strong regime
    −0.65 pts t=−1.15 (within noise, n=5) with higher per-seed variance;
    all published reference checkpoints used CLS, so real-data
    validation remains the deployment gate."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=64, use_cls_token=False,
                       numerics=numerics)


def rawiq_best_mp_config(numerics: str = "tpu") -> ModelConfig:
    """The reference's best-checkpoint geometry (d256/L9/seg16) with the
    MEAN-POOL readout: 64 tokens (a power of two) vs the CLS variant's 65."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=256, n_head=8,
                       n_layers=9, ffn_hidden=1024, drop_prob=0.1,
                       segment_size=16, use_cls_token=False,
                       numerics=numerics)


def rawiq_mp_config(numerics: str = "tpu") -> ModelConfig:
    """rawIQ segment-16 with MEAN-POOL readout: 64 tokens (the CLS variant
    has 65)."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=16, use_cls_token=False,
                       numerics=numerics)


def vit_tiny_2016_config(numerics: str = "tpu") -> ModelConfig:
    """BASELINE config 2: ViT-Tiny on RadioML 2016.10a-style data —
    128-sample frames folded to [1, 16, 16] images, 11-class AMC
    (d64/L4/H4, 17 tokens)."""
    return ModelConfig(arm="vit", num_classes=11, d_model=64, n_head=4,
                       n_layers=4, ffn_hidden=256, drop_prob=0.1,
                       img_size_h=16, img_size_w=16, patch_size=4,
                       seq_length=128, numerics=numerics)


def flagship_conv1d_config(numerics: str = "tpu") -> ModelConfig:
    """rawIQ conv1d tokenization — 1025 tokens incl. CLS, the reference's
    long-sequence mode (ref: transformer_rawIQ/models/encoder.py:34-41)."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       embedding_type="conv1d", numerics=numerics)


# Every benchable serving geometry, by arm name (bench_fused_infer,
# bench_train_step, and the CLI --which dispatch all resolve through this).
ARM_CONFIGS = {
    "vit": flagship_vit_config,
    "rawiq": flagship_rawiq_config,
    "rawiq_seg64": rawiq_seg64_config,
    "rawiq_seg64_mp": rawiq_seg64_mp_config,
    "rawiq_mp": rawiq_mp_config,
    "rawiq_best": rawiq_best_config,
    "rawiq_best_mp": rawiq_best_mp_config,
    "rawiq_conv1d": flagship_conv1d_config,
    "vit_tiny": vit_tiny_2016_config,
}


def _forward_and_pre(cfg):
    """Forward + preprocess pair for a bench arm. When the fused raw
    embedding is enabled (vitiq/models/raw_embed.py: under the bf16
    numerics), preprocessing folds into the embedding GEMM and the
    preprocess step is the identity (the forward consumes raw frames)."""
    from vitiq.models.raw_embed import fused_raw_embed_enabled

    if fused_raw_embed_enabled(cfg):
        return make_forward(cfg, raw_stats=FLAGSHIP_STATS), (lambda x: x)
    fwd = make_forward(cfg)
    if cfg.arm == "vit":
        pre = lambda x: preprocess_batch_vit(x, FLAGSHIP_STATS,
                                             H=cfg.img_size_h,
                                             W=cfg.img_size_w)
    else:
        pre = lambda x: preprocess_batch_rawiq(x, FLAGSHIP_STATS)
    return fwd, pre


def _default_batch() -> int:
    # the serving batch the benchmarks use on an accelerator; the CPU
    # default only keeps host-side runs short
    return 16384 if jax.default_backend() != "cpu" else 256


def device_info() -> Dict[str, object]:
    """The device a result was measured on, as JAX reports it."""
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def _slope_timing(run_k: Callable[[int], float], k_small: int) -> Dict[str, float]:
    """Device time per step from `run_k(k)`, the wall time of ONE device call
    that runs k dependent steps and ends in a host fetch.

    Reported as the SLOPE between a shallow (k_small) and a deep (k_big)
    call, so the constant per-call cost (dispatch, result fetch) cancels
    exactly. k_big is adapted to ~3 s of device work, capped at
    VITIQ_BENCH_K_CAP; the two depths alternate order across reps so slow
    host-side drift cancels too."""
    on_cpu = jax.default_backend() == "cpu"
    k_small = int(os.environ.get("VITIQ_BENCH_K_SMALL", "1" if on_cpu else k_small))
    k_cap = int(os.environ.get("VITIQ_BENCH_K_CAP", "3" if on_cpu else "256"))
    reps = int(os.environ.get("VITIQ_BENCH_REPS", "2" if on_cpu else "5"))
    run_k(k_small)  # compile + warm up
    est_step = max(run_k(k_small) / k_small, 1e-6)  # upper bound (incl. overhead)
    k_big = int(np.clip(round(3.0 / est_step), k_small * 3, k_cap))
    slopes, overheads = [], []
    for r in range(reps):
        if r % 2 == 0:
            ts, tb = run_k(k_small), run_k(k_big)
        else:
            tb, ts = run_k(k_big), run_k(k_small)
        slope = max((tb - ts) / (k_big - k_small), 1e-9)
        slopes.append(slope)
        overheads.append(max(ts - k_small * slope, 0.0))
    s = np.asarray(slopes)
    return {"p50_s": float(np.median(s)), "best_s": float(s.min()),
            "mean_s": float(s.mean()),
            "overhead_p50_ms": float(np.median(overheads) * 1e3),
            "k_small": k_small, "k_big": k_big,
            "timing_method": "fori-slope"}


def _time_amortized(step_fn: Callable, args) -> Dict[str, float]:
    """Time `step_fn(i, *args)` as K dependent iterations inside one jitted
    lax.fori_loop call (inputs perturbed by the loop index so nothing
    hoists; outputs folded into the carry so nothing is dead code); see
    _slope_timing."""

    @jax.jit
    def run(n, *args):
        def body(i, c):
            out = step_fn(i.astype(jnp.float32), *args)
            return c + jnp.sum(out.astype(jnp.float32)) * 1e-12

        return jax.lax.fori_loop(0, n, body, jnp.zeros((), jnp.float32))

    def run_k(k: int) -> float:
        t0 = time.perf_counter()
        float(run(jnp.asarray(k, jnp.int32), *args))
        return time.perf_counter() - t0

    return _slope_timing(run_k, k_small=8)


def bench_fused_infer(arm: str = "vit", batch_size: Optional[int] = None,
                      steps: int = 30, numerics: str = "tpu",
                      n_head: Optional[int] = None,
                      data_parallel: Optional[int] = None) -> Dict:
    """End-to-end DSP(normalize)+model inference frames/sec/chip.

    `n_head` overrides the flagship head count for the d_head>=32 roofline
    variants (d_head = d_model / n_head; e.g. n_head=4 -> d_head=32): fewer,
    wider heads shrink the per-head score-tensor work of attention.
    Accuracy of the variants is revalidated by
    scripts/head_variant_validation.py.

    `data_parallel` shards the bench batch over a data mesh of that many
    devices (serving scale-out path; reported frames/s is then the MESH
    total, not per-chip)."""
    batch_size = batch_size or _default_batch()
    cfg = ARM_CONFIGS[arm](numerics)
    if arm == "rawiq_conv1d":
        # 1025-token attention is ~60x the 129-token FLOPs; keep the default
        # batch within device memory
        batch_size = min(batch_size, 2048)
    if n_head is not None:
        from dataclasses import replace

        cfg = replace(cfg, n_head=n_head)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    fwd, pre = _forward_and_pre(cfg)

    def infer(i, params, x):
        xi = x + i.astype(x.dtype) * 1e-6  # defeat loop-invariant hoisting
        return fwd(params, pre(xi), train=False).argmax(axis=-1)

    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (batch_size, cfg.seq_length, 2)), jnp.float32)
    if data_parallel:
        from vitiq.parallel.mesh import batch_sharding, make_mesh, shard_params

        mesh = make_mesh(data=data_parallel, model=1)
        x = jax.device_put(x, batch_sharding(mesh))
        params = shard_params(params, mesh)
    else:
        x = jax.device_put(x)
    t = _time_amortized(infer, (params, x))
    fps = batch_size / t["p50_s"]
    suffix = "" if n_head is None else f"_h{n_head}"
    out = {
        "metric": f"iq_frames_per_sec_per_chip_{arm}{suffix}",
        "value": fps,
        "unit": "frames/s",
        "batch_size": batch_size,
        "p50_latency_ms": t["p50_s"] * 1e3,
        "best_latency_ms": t["best_s"] * 1e3,
        **device_info(),
        "numerics": numerics,
    }
    for k in ("timing_method", "overhead_p50_ms", "k_big"):
        if k in t:
            out[k] = t[k]
    return out


def bench_int8_infer(arm: str = "vit", batch_size: Optional[int] = None,
                     steps: int = 30) -> Dict:
    """End-to-end inference with the int8 W8A8 serving path."""
    from vitiq.ops.quant import make_quantized_forward, quantize_params_int8

    batch_size = batch_size or _default_batch()
    cfg = flagship_vit_config("tpu") if arm == "vit" else flagship_rawiq_config("tpu")
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    qparams = quantize_params_int8(params)
    qfwd = make_quantized_forward(cfg)
    if arm == "vit":
        pre = lambda x: preprocess_batch_vit(x, FLAGSHIP_STATS)
    else:
        pre = lambda x: preprocess_batch_rawiq(x, FLAGSHIP_STATS)

    def infer(i, qparams, x):
        xi = x + i.astype(x.dtype) * 1e-6
        return qfwd(qparams, pre(xi)).argmax(axis=-1)

    x = jax.device_put(jnp.asarray(np.random.default_rng(0).standard_normal(
        (batch_size, cfg.seq_length, 2)), jnp.float32))
    t = _time_amortized(infer, (qparams, x))
    return {
        "metric": f"iq_frames_per_sec_per_chip_{arm}_int8",
        "value": batch_size / t["p50_s"],
        "unit": "frames/s",
        "batch_size": batch_size,
        "p50_latency_ms": t["p50_s"] * 1e3,
        **device_info(),
    }


def bench_train_step(arm: str = "vit", batch_size: Optional[int] = None,
                     steps: int = 20, numerics: str = "tpu",
                     dropout_key: Optional[jax.Array] = None) -> Dict:
    """Full fused train-step frames/sec/chip (fwd+bwd+AdamW).

    `dropout_key` is the base dropout key (default `PRNGKey(0)`, threefry);
    a typed key such as `jax.random.key(0, impl="rbg")` times another
    generator."""
    from vitiq.config import TrainConfig
    from vitiq.train.loop import make_train_step
    from vitiq.train.optim import create_train_state, make_optimizer

    batch_size = batch_size or max(_default_batch() // 4, 64)
    cfg = ARM_CONFIGS[arm](numerics)
    tcfg = TrainConfig(batch_size=batch_size)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    fwd, pre = _forward_and_pre(cfg)
    tx = make_optimizer(tcfg)
    state = create_train_state(params, tcfg)
    step = make_train_step(fwd, tx, tcfg.label_smoothing, pre)

    rng = jax.random.PRNGKey(0) if dropout_key is None else dropout_key
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (batch_size, cfg.seq_length, 2)), jnp.float32)
    y = jnp.zeros((batch_size,), jnp.int32)

    # K dependent train steps inside ONE jitted fori_loop device call
    # (trajectory-identical to K per-call steps: same per-(seed, state.step)
    # dropout keys, same update order), timed as a slope (_slope_timing).
    # The raw (unjitted) step body is traced: calling the jitted wrapper
    # inside the trace would inline fine but spams donation warnings.
    import functools

    inner_step = getattr(step, "__wrapped__", step)

    @functools.partial(jax.jit, donate_argnums=(1,))
    def run_train(n, st, x, y, rng):
        def body(i, st):
            st, _ = inner_step(st, x + i.astype(x.dtype) * 1e-6, y, rng)
            return st

        return jax.lax.fori_loop(0, n, body, st)

    holder = {"state": state}

    def run_k(k: int) -> float:
        t0 = time.perf_counter()
        holder["state"] = run_train(jnp.asarray(k, jnp.int32), holder["state"],
                                    x, y, rng)
        float(holder["state"].step)  # forces completion of the whole call
        return time.perf_counter() - t0

    t = _slope_timing(run_k, k_small=4)
    p50 = t["p50_s"]
    extra = {k: t[k] for k in ("timing_method", "k_small", "k_big",
                               "overhead_p50_ms")}
    return {
        "metric": f"train_frames_per_sec_per_chip_{arm}",
        "value": batch_size / p50,
        "unit": "frames/s",
        "batch_size": batch_size,
        "p50_step_ms": p50 * 1e3,
        "vs_reference_gpu": (batch_size / p50) / REFERENCE_GPU_TRAIN_FPS,
        **device_info(),
        **extra,
    }


def bench_dsp_frontend(batch_size: Optional[int] = None, steps: int = 30,
                       sps: int = 2) -> Dict:
    """Matched-filter front-end GB/s (RRC grouped conv over batched frames)."""
    batch_size = batch_size or _default_batch()
    frame_len = 1024

    def frontend(i, x):
        return matched_filter_batch(x + i.astype(x.dtype) * 1e-6, sps=sps)

    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (batch_size, frame_len, 2)), jnp.float32)
    t = _time_amortized(frontend, (x,))
    bytes_moved = 2 * batch_size * frame_len * 2 * 4  # read + write f32
    return {
        "metric": "dsp_frontend_gbps",
        "value": bytes_moved / t["p50_s"] / 1e9,
        "unit": "GB/s",
        "batch_size": batch_size,
        "p50_latency_ms": t["p50_s"] * 1e3,
        **device_info(),
    }


def bench_sps_infer(batch_size: Optional[int] = None, steps: int = 30,
                    sps: int = 2, method: str = "gardner") -> Dict:
    """BASELINE config 3 end-to-end: oversampled [B, sps*1024, 2] frames ->
    RRC matched filter -> timing recovery (`method`) -> z-score -> flagship
    rawIQ classifier, all in ONE jit (the reference's deleted DSP suite ran
    frame-at-a-time on the host; here Gardner/Mueller-Müller are vmapped
    lax.scan loops and the energy/correlation picks are pure vector ops,
    SURVEY.md §2.4)."""
    from vitiq.dsp import preprocess_batch_sps

    batch_size = batch_size or max(_default_batch() // 2, 64)
    cfg = flagship_rawiq_config("tpu")
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    fwd = make_forward(cfg)

    def infer(i, params, x):
        xi = x + i.astype(x.dtype) * 1e-6
        sym = preprocess_batch_sps(xi, sps, method=method)
        return fwd(params, preprocess_batch_rawiq(sym, FLAGSHIP_STATS),
                   train=False).argmax(axis=-1)

    x = jax.device_put(jnp.asarray(np.random.default_rng(0).standard_normal(
        (batch_size, sps * cfg.seq_length, 2)), jnp.float32))
    t = _time_amortized(infer, (params, x))
    return {
        "metric": f"sps{sps}_{method}_frames_per_sec_per_chip",
        "value": batch_size / t["p50_s"],
        "unit": "frames/s",
        "batch_size": batch_size,
        "sps": sps,
        "timing_method": method,
        "p50_latency_ms": t["p50_s"] * 1e3,
        **device_info(),
    }


def bench_ingestion(num_frames: int = 65536, frame_len: int = 1024,
                    batch_size: int = 1024, tmp_dir: Optional[str] = None) -> Dict:
    """Host ingestion throughput: HDF5 chunked-shuffled streaming vs packed
    mmap .npy shards, both through the background Prefetcher (the two storage
    paths of SURVEY.md §7.3's 1M frames/s ingestion problem)."""
    import json
    import tempfile

    import h5py

    from vitiq.data import (HDF5DataSource, PackedDataSource, Prefetcher,
                            pack_split_to_npy)

    tmp = tempfile.mkdtemp(dir=tmp_dir)
    path = f"{tmp}/bench.hdf5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=rng.standard_normal(
            (num_frames, frame_len, 2)).astype(np.float32))
        y = np.zeros((num_frames, 2), np.int64)
        y[:, 0] = 1
        f.create_dataset("Y", data=y)
        f.create_dataset("Z", data=np.zeros((num_frames, 1), np.float32))
    (lambda p: p.write_text(json.dumps(["A", "B"])))(__import__("pathlib").Path(f"{tmp}/c.json"))

    src = HDF5DataSource(path, f"{tmp}/c.json")
    indices = np.arange(num_frames)
    label_map = {"A": 0, "B": 1}
    frame_bytes = frame_len * 2 * 4

    def drain(it) -> float:
        t0 = time.perf_counter()
        n = 0
        for bx, *_ in it:
            n += len(bx)
        return n / (time.perf_counter() - t0)

    hdf5_fps = drain(Prefetcher(src.batch_stream(indices, label_map, batch_size,
                                                 seed=0), prefetch_depth=4))
    packed_dir = pack_split_to_npy(src, indices, label_map, f"{tmp}/packed")
    packed = PackedDataSource(packed_dir)
    rng2 = np.random.default_rng(1)

    def packed_stream():
        order = rng2.permutation(num_frames)
        for s in range(0, num_frames - batch_size + 1, batch_size):
            rows = np.sort(order[s:s + batch_size])
            yield (packed.read_rows(rows),)

    packed_fps = drain(Prefetcher(packed_stream(), prefetch_depth=4))
    # the streaming-training read path: shard-shuffle windows + lookahead
    stream_fps = drain(Prefetcher(
        packed.batch_stream(batch_size, shuffle=True, seed=2),
        prefetch_depth=4))
    # host sequential-copy ceiling (page-cache-warm memcpy bound)
    shard0 = packed._shards[0]
    blk = min(4096, len(shard0))
    buf = np.empty((blk,) + shard0.shape[1:], shard0.dtype)
    t0 = time.perf_counter()
    n_raw = 0
    for s in range(0, len(shard0) - blk + 1, blk):
        np.copyto(buf, shard0[s:s + blk])
        n_raw += blk
    raw_fps = n_raw / max(time.perf_counter() - t0, 1e-9)
    src.close()
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "metric": "ingestion_frames_per_sec",
        "hdf5_stream_fps": hdf5_fps,
        "hdf5_stream_gbps": hdf5_fps * frame_bytes / 1e9,
        "packed_mmap_fps": packed_fps,
        "packed_mmap_gbps": packed_fps * frame_bytes / 1e9,
        "packed_stream_fps": stream_fps,
        "packed_stream_gbps": stream_fps * frame_bytes / 1e9,
        "host_sequential_fps": raw_fps,
        "host_sequential_gbps": raw_fps * frame_bytes / 1e9,
        "value": packed_fps,
        "unit": "frames/s",
    }


def bench_e2e_serving(num_frames: int = 65536, batch_size: Optional[int] = None,
                      tmp_dir: Optional[str] = None) -> Dict:
    """Sustained end-to-end serving rate: packed mmap shards -> background
    prefetch thread (issues H2D ahead of the consumer) -> fused DSP+ViT
    inference. This is the whole-pipeline counterpart of bench_fused_infer's
    compute-only number."""
    import tempfile

    from vitiq.data import Prefetcher

    batch_size = batch_size or _default_batch()
    num_frames = max(num_frames, 4 * batch_size)
    cfg = flagship_vit_config("tpu")
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    fwd = make_forward(cfg)
    pre = lambda x: preprocess_batch_vit(x, FLAGSHIP_STATS)

    @jax.jit
    def infer(params, x):
        return fwd(params, pre(x), train=False).argmax(axis=-1)

    tmp = tempfile.mkdtemp(dir=tmp_dir)
    rng = np.random.default_rng(0)
    shards = []
    shard_rows = 16384
    for s in range(0, num_frames, shard_rows):
        rows = min(shard_rows, num_frames - s)
        p = f"{tmp}/x_{s}.npy"
        np.save(p, rng.standard_normal((rows, cfg.seq_length, 2)).astype(np.float32))
        shards.append(np.load(p, mmap_mode="r"))

    def batches():
        for shard in shards:
            for b in range(0, len(shard) - batch_size + 1, batch_size):
                yield np.asarray(shard[b:b + batch_size])

    # warm up the compile outside the timed region
    warm = jnp.zeros((batch_size, cfg.seq_length, 2), jnp.float32)
    jax.block_until_ready(infer(params, warm))

    t0 = time.perf_counter()
    n = 0
    out = None
    for bx in Prefetcher(batches(), prefetch_depth=4,
                         transform=lambda b: jax.device_put(b)):
        out = infer(params, bx)
        n += batch_size
    _ = np.asarray(out)  # drain the device queue
    wall = time.perf_counter() - t0

    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "metric": "e2e_serving_frames_per_sec",
        "value": n / wall,
        "unit": "frames/s",
        "frames": n,
        "batch_size": batch_size,
        **device_info(),
    }


def bench_streaming(num_channels: int = 64, windows: Optional[int] = None,
                    steps: int = 24, arm: str = "vit") -> Dict:
    """BASELINE config 5: wideband stream -> 64-channel polyphase channelizer
    -> fused normalize+classify, ONE jit program (vitiq/streaming.py). Reports
    classified frames/s (each window yields num_channels frames). `arm`
    selects the classifier geometry (any ARM_CONFIGS key; the channelizer
    ingests ONE sequential wideband stream either way)."""
    from vitiq.streaming import make_streaming_classifier

    windows = windows or max((_default_batch() // num_channels), 2)
    cfg = ARM_CONFIGS[arm]("tpu")
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    fwd = make_forward(cfg)
    classify = make_streaming_classifier(cfg, fwd, FLAGSHIP_STATS,
                                         num_channels=num_channels)
    n = num_channels * cfg.seq_length
    rng = np.random.default_rng(0)
    # ship real/imag as f32 and combine on device
    wr = jax.device_put(jnp.asarray(rng.standard_normal((windows, n)), jnp.float32))
    wi_ = jax.device_put(jnp.asarray(rng.standard_normal((windows, n)), jnp.float32))

    def run(i, params, wr, wi_):
        w = (wr + i * 1e-6) + 1j * wi_
        return classify(params, w.astype(jnp.complex64)).argmax(axis=-1)

    t = _time_amortized(run, (params, wr, wi_))
    frames = windows * num_channels
    return {
        "metric": "streaming_channelized_frames_per_sec_per_chip",
        "value": frames / t["p50_s"],
        "unit": "frames/s",
        "classifier_arm": arm,
        "num_channels": num_channels,
        "windows_per_call": windows,
        "p50_latency_ms": t["p50_s"] * 1e3,
        **device_info(),
    }


def run_benchmarks(which: str = "fused_vit_infer", batch_size: Optional[int] = None,
                   steps: int = 30, n_head: Optional[int] = None,
                   data_parallel: Optional[int] = None, sps: int = 2,
                   timing_method: Optional[str] = None) -> Dict:
    if which == "head_variant":
        # d_head = d_model / n_head roofline variant (default d_head=32)
        return bench_fused_infer("vit", batch_size, steps, n_head=n_head or 4,
                                 data_parallel=data_parallel)
    if which == "fused_vit_infer":
        return bench_fused_infer("vit", batch_size, steps,
                                 data_parallel=data_parallel)
    if which == "rawiq_infer":
        return bench_fused_infer("rawiq", batch_size, steps, n_head=n_head)
    if which == "vit_tiny_infer":
        # BASELINE config 2: ViT-Tiny, 128-sample frames, 16x16 images
        return bench_fused_infer("vit_tiny", batch_size, steps, n_head=n_head)
    if which == "rawiq64_infer":
        return bench_fused_infer("rawiq_seg64", batch_size, steps, n_head=n_head)
    if which == "rawiq64_mp_infer":
        # mean-pool readout: 16 tokens, no CLS row
        return bench_fused_infer("rawiq_seg64_mp", batch_size, steps,
                                 n_head=n_head)
    if which == "rawiq_mp_infer":
        return bench_fused_infer("rawiq_mp", batch_size, steps, n_head=n_head)
    if which == "rawiq_best_infer":
        return bench_fused_infer("rawiq_best", batch_size, steps, n_head=n_head)
    if which == "rawiq_best_mp_infer":
        return bench_fused_infer("rawiq_best_mp", batch_size, steps,
                                 n_head=n_head)
    if which == "conv1d_infer":
        # 1025 tokens: attention dominates, so --n_head variants matter most
        return bench_fused_infer("rawiq_conv1d", batch_size, steps,
                                 n_head=n_head)
    if which == "int8_infer":
        return bench_int8_infer("vit", batch_size, steps)
    if which == "train_step":
        return bench_train_step("vit", batch_size, steps)
    if which == "dsp_frontend":
        return bench_dsp_frontend(batch_size, steps)
    if which == "sps_infer":
        return bench_sps_infer(batch_size, steps, sps=sps,
                               method=timing_method or "gardner")
    if which == "ingestion":
        return bench_ingestion()
    if which == "e2e_serving":
        return bench_e2e_serving(batch_size=batch_size)
    if which == "streaming":
        return bench_streaming(windows=batch_size)
    if which == "all":
        return {
            "fused_vit_infer": bench_fused_infer("vit", batch_size, steps),
            "rawiq_infer": bench_fused_infer("rawiq", batch_size, steps),
            "int8_infer": bench_int8_infer("vit", batch_size, steps),
            "train_step": bench_train_step("vit", batch_size, steps),
            "dsp_frontend": bench_dsp_frontend(batch_size, steps),
        }
    raise ValueError(f"unknown benchmark {which!r}")
