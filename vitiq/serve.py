"""AOT-exported serving artifacts (deployment without model code).

The reference deploys by shipping a checkpoint plus the whole training tree
(`ViT/training/evaluate.py:42-87` rebuilds the model from config at load
time). Here the deployment unit is instead the COMPILED program:
`jax.export` serializes the jitted serving function — fused preprocess +
encoder (incl. the Triton attention kernel when exported for CUDA) + head,
with the trained weights baked in as constants — to StableHLO bytes. A
consumer process deserializes and calls it without vitiq model code, and
XLA recompiles the program for its local device.

Serving is fixed-shape, so an artifact holds one entry per batch-size
BUCKET (e.g. 256 for latency, 8192 for throughput). `ServingArtifact.run`
pads a ragged batch up to the smallest admitting bucket and slices the
result back — zero-padded frames are independent rows (no batch-coupled
ops anywhere in the serving path), so padding never perturbs real rows.

Artifact layout (a directory):
    manifest.json               format/version, buckets, shapes, platforms
    config.json                 full ExperimentConfig (round-trippable)
    stats.json                  normalization stats the export baked in
    serving_b{B}.mlirbc         the exported StableHLO module per bucket

Each bucket's program is stored as its StableHLO bytecode plus the few
fields of `jax.export.Exported` that calling it needs (in the manifest);
`load` rebuilds the Exported around the bytes. This keeps the artifact free
of jax.export's own serialization, which needs the `flatbuffers` package.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as jax_export

from vitiq.config import ExperimentConfig

_FORMAT = "vitiq-serving/2"
# the custom-call target a Pallas Triton kernel lowers to
TRITON_CUSTOM_CALL = "__gpu$xla.gpu.triton"


def build_serving_fn(cfg: ExperimentConfig, params, stats: Dict[str, float]):
    """Raw [B, frame_len, 2] f32 frames -> [B, num_classes] f32 logits.

    The full serving pipeline of `run_training`'s eval path (runner.py:
    build_preprocess) with the weights closed over, so the exported program
    is self-contained.
    """
    from vitiq.runner import build_forward_and_preprocess

    fwd, pre = build_forward_and_preprocess(cfg, stats)
    params = jax.tree_util.tree_map(jnp.asarray, params)

    def serve(x):
        return fwd(params, pre(x), train=False).astype(jnp.float32)

    return serve


def export_serving(
    cfg: ExperimentConfig,
    params,
    stats: Dict[str, float],
    path: str | Path,
    batch_sizes: Sequence[int] = (256, 8192),
    platforms: Optional[Sequence[str]] = None,
) -> Path:
    """Export one serialized serving program per batch bucket into `path`.

    `platforms` defaults to the current backend; pass e.g. ["cuda"] (or
    ["cpu", "cuda"]) to pin the lowering targets. The Triton attention
    kernel rides along as a custom call, which `jax.export` gates behind an
    explicit safety acknowledgement — given here, since the kernel is our
    own. The manifest records the platforms the export lowered for.
    """
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] <= 0:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    frame_len = cfg.data.frame_len
    serve = jax.jit(build_serving_fn(cfg, params, stats))
    kwargs = {"disabled_checks": [
        jax_export.DisabledSafetyCheck.custom_call(TRITON_CUSTOM_CALL)]}
    if platforms is not None:
        kwargs["platforms"] = list(platforms)
    entries = {}
    lowered_for = None
    for b in batch_sizes:
        spec = jax.ShapeDtypeStruct((b, frame_len, 2), jnp.float32)
        exported = jax_export.export(serve, **kwargs)(spec)
        lowered_for = list(exported.platforms)
        blob = exported.mlir_module_serialized
        name = f"serving_b{b}.mlirbc"
        (out / name).write_bytes(blob)
        entries[str(b)] = {
            "file": name, "bytes": len(blob),
            "fun_name": exported.fun_name,
            "calling_convention_version": exported.calling_convention_version,
            "module_kept_var_idx": list(exported.module_kept_var_idx),
            "uses_global_constants": exported.uses_global_constants,
        }
    manifest = {
        "format": _FORMAT,
        "arm": cfg.model.arm,
        "num_classes": cfg.model.num_classes,
        "frame_len": frame_len,
        "input_spec": [None, frame_len, 2],
        "batch_sizes": batch_sizes,
        "platforms": lowered_for,
        "entries": entries,
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    (out / "config.json").write_text(cfg.to_json())
    (out / "stats.json").write_text(json.dumps(stats, indent=2))
    return out


class ServingArtifact:
    """Loaded serving artifact: deserialized per-bucket programs + metadata.

    `run(x)` routes a [B, frame_len, 2] batch to the smallest bucket >= B
    (padding with zero frames, slicing the logits back); `predict(x)`
    returns argmax class indices.
    """

    def __init__(self, manifest: Dict, programs: Dict[int, "jax_export.Exported"],
                 root: Path):
        self.manifest = manifest
        self._programs = programs
        self.root = root

    @classmethod
    def load(cls, path: str | Path) -> "ServingArtifact":
        root = Path(path)
        manifest = json.loads((root / "manifest.json").read_text())
        if manifest.get("format") != _FORMAT:
            raise ValueError(
                f"{root} is not a vitiq serving artifact "
                f"(format={manifest.get('format')!r}, expected {_FORMAT!r})")
        programs = {
            int(b): _rebuild_exported(
                entry, (root / entry["file"]).read_bytes(),
                (int(b), manifest["frame_len"], 2), manifest["num_classes"],
                manifest["platforms"])
            for b, entry in manifest["entries"].items()}
        return cls(manifest, programs, root)

    @property
    def batch_sizes(self) -> list:
        return sorted(self._programs)

    @property
    def config(self) -> ExperimentConfig:
        return ExperimentConfig.from_json(str(self.root / "config.json"))

    def _bucket(self, b: int) -> int:
        for cand in self.batch_sizes:
            if cand >= b:
                return cand
        raise ValueError(
            f"batch of {b} frames exceeds the largest exported bucket "
            f"({self.batch_sizes[-1]}); re-export with a larger bucket")

    def run(self, x) -> jnp.ndarray:
        x = jnp.asarray(x, jnp.float32)
        frame_len = self.manifest["frame_len"]
        if x.ndim != 3 or x.shape[1] != frame_len or x.shape[2] != 2:
            raise ValueError(
                f"expected [B, {frame_len}, 2] raw I/Q frames, got {x.shape}")
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket != b:
            x = jnp.pad(x, ((0, bucket - b), (0, 0), (0, 0)))
        logits = self._programs[bucket].call(x)
        return logits[:b]

    def predict(self, x) -> np.ndarray:
        return np.asarray(jnp.argmax(self.run(x), axis=-1))


def _rebuild_exported(entry: Dict, module: bytes, in_shape, num_classes: int,
                      platforms) -> "jax_export.Exported":
    """An Exported that calls the stored StableHLO `module`: a template
    exported here with the same signature ([B, L, 2] f32 -> [B, K] f32,
    unsharded) supplies the calling structure, and the stored fields
    replace its program."""
    template = jax_export.export(jax.jit(
        lambda x: jnp.zeros((in_shape[0], num_classes), jnp.float32) + x[0, 0, 0]))(
            jax.ShapeDtypeStruct(in_shape, jnp.float32))
    return dataclasses.replace(
        template,
        fun_name=entry["fun_name"],
        platforms=tuple(platforms),
        mlir_module_serialized=module,
        calling_convention_version=entry["calling_convention_version"],
        module_kept_var_idx=tuple(entry["module_kept_var_idx"]),
        uses_global_constants=entry["uses_global_constants"])


def export_from_experiment(
    experiment_dir: str | Path,
    path: str | Path,
    batch_sizes: Sequence[int] = (256, 8192),
    platforms: Optional[Sequence[str]] = None,
    checkpoint: str = "model_best.npz",
) -> Path:
    """Assemble an artifact from a training-run directory (the layout
    `run_training` writes: config.json + normalization_stats.json +
    model_best.npz)."""
    from vitiq.models import init_amc_params
    from vitiq.train.checkpoint import load_params

    exp = Path(experiment_dir)
    cfg = ExperimentConfig.from_json(str(exp / "config.json"))
    stats = json.loads((exp / "normalization_stats.json").read_text())
    ckpt = exp / checkpoint
    if not ckpt.exists():
        if checkpoint != "model_best.npz":
            # only the DEFAULT falls back — an explicitly requested
            # checkpoint that is missing must not silently export other
            # weights
            raise FileNotFoundError(f"checkpoint not found: {ckpt}")
        ckpt = exp / "model_final.npz"  # best absent (e.g. interrupted
        # run): fall back to the final weights
    template = init_amc_params(jax.random.PRNGKey(0), cfg.model)
    params = load_params(ckpt, template)
    return export_serving(cfg, params, stats, path,
                          batch_sizes=batch_sizes, platforms=platforms)
