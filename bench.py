#!/usr/bin/env python
"""Throughput benchmark: prints ONE JSON line.

Primary metric: classified IQ frames/s on one device for the ViT-Tiny
geometry (BASELINE.json config 2: 11-class AMC on RadioML 2016.10a-style
128-sample frames) — z-score normalization, [1, 16, 16] fold, patchify,
ViT-d64/L4 encoder and head in ONE jit program under the bf16 numerics,
raw frames resident in device memory. vs_baseline is relative to the 1M
frames/s north star of BASELINE.json.

Secondary keys: the reference's flagship ViT (d128/L6, 1024-sample frames)
serving, the rawIQ seg-64 mean-pool serving geometry, and train steps of
three rawIQ geometries (vs_reference_gpu compares with the reference's only
published throughput, ~2,330 frames/s train on an unspecified CUDA GPU,
README.md:458-473).

Every phase either produces its key or the script exits non-zero; the line
names the device (platform, device_kind, device_count) it was measured on
and, on an NVIDIA card, nvidia-smi's name and power limit (`card`).

    python bench.py
"""

import json
import shutil
import subprocess
import sys


def card() -> str:
    """nvidia-smi's name and power limit, or "none" without nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return "none"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def main() -> int:
    from vitiq.utils.compile_cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    from vitiq.bench import (TARGET_FPS, bench_fused_infer, bench_train_step,
                             device_info)

    res = bench_fused_infer("vit_tiny", 16384)
    line = {
        "metric": "iq_frames_per_sec_per_chip__vit_tiny",
        "value": res["value"],
        "unit": "frames/s",
        "vs_baseline": res["value"] / TARGET_FPS,
        "p50_latency_ms": res["p50_latency_ms"],
        "batch_size": res["batch_size"],
        **device_info(),
        "card": card(),
        "config": "vit_tiny (BASELINE config 2: ViT-arm 11-class AMC, "
                  "fused DSP front-end + ViT-d64/L4, 128-sample frames)",
        "timing_method": res["timing_method"],
        "timing_overhead_ms_p50": res["overhead_p50_ms"],
    }
    fl = bench_fused_infer("vit")
    line["vit_flagship_frames_per_sec"] = fl["value"]
    line["vit_flagship_vs_baseline"] = fl["value"] / TARGET_FPS
    line["vit_flagship_p50_latency_ms"] = fl["p50_latency_ms"]
    mp = bench_fused_infer("rawiq_seg64_mp")
    line["rawiq_seg64_mp_frames_per_sec"] = mp["value"]
    line["rawiq_seg64_mp_vs_baseline"] = mp["value"] / TARGET_FPS
    for key, arm, batch in (("rawiq_seg64_mp_train", "rawiq_seg64_mp", 8192),
                            ("rawiq_best_train", "rawiq_best", 8192),
                            ("rawiq_flagship_train", "rawiq", 2048)):
        tr = bench_train_step(arm, batch)
        line[f"{key}_frames_per_sec"] = tr["value"]
        line[f"{key}_vs_reference_gpu"] = tr["vs_reference_gpu"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
