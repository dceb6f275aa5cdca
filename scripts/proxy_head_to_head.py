#!/usr/bin/env python
"""Two-arm head-to-head on the 19-class synthetic proxy corpus at the
reference training regime — the strongest accuracy proxy achievable without
the 20 GB RadioML download (VERDICT round-2 item 2).

Trains BOTH arms to convergence (batch 256, plateau LR, early stopping —
the reference regime, ref: ViT/training/train.py:90-95 / 405-424), evaluates
each with the full confusion/report artifact set, and runs the cross-arm
comparison — the workflow the reference performs manually across its two
script trees + compare_models.py.

Usage: python scripts/proxy_head_to_head.py [epochs] [frames_per_class] \
    [numerics] [classes] [channel] [tag]
Defaults: 100 epochs (early stop governs), 2048 frames/class, numerics=tpu
(bf16) on an accelerator else reference, classes=19 (24 = the full RadioML 2018.01A list
incl. the analog AM/FM families, ref: ViT/training/evaluate.py:69-74),
channel=none ('imp' = the 2018.01A-style impairment chain —
vitiq.data.synthetic.ChannelModel; VERDICT r3 item 1 — with artifacts
under result/proxy{classes}i/; a JSON dict, e.g. '{"fading": false}',
selects an ablation rung; pair ablation rungs with an explicit [tag] so
each rung's artifacts land under result/proxy{classes}{tag}/ instead of
clobbering the full-impairment run).
Artifacts under result/proxy{classes}/, comparison under
result/proxy{classes}/comparison_results/, summary JSON at
result/proxy{classes}/head_to_head_summary.json.
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    import jax

    from vitiq.utils.compile_cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    from vitiq.config import ExperimentConfig
    from vitiq.runner import run_head_to_head

    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    numerics = (sys.argv[3] if len(sys.argv) > 3
                else ("tpu" if jax.default_backend() != "cpu" else "reference"))
    n_classes = int(sys.argv[4]) if len(sys.argv) > 4 else 19
    channel = sys.argv[5] if len(sys.argv) > 5 else "none"

    suffix = (sys.argv[6] if len(sys.argv) > 6
              else ("" if channel == "none" else "i"))
    out_root = pathlib.Path(f"result/proxy{n_classes}{suffix}")
    common = {
        "data.synthetic_frames_per_class": frames,
        "model.numerics": numerics,
        "train.num_epochs": epochs,
        "checkpoint_dir": str(out_root / "ckpt"),
        "log_dir": str(out_root / "logs"),
    }
    if channel != "none":
        common["data.synthetic_channel"] = True
        if channel != "imp":
            common["data.synthetic_channel_params"] = json.loads(channel)
    if n_classes == 24:
        from vitiq.config import TARGET_MODULATIONS_24
        common["data.synthetic_classes"] = TARGET_MODULATIONS_24
        common["model.num_classes"] = 24
    vit_cfg = ExperimentConfig.vit_synthetic19(**common)
    rawiq_cfg = ExperimentConfig.rawiq_synthetic19(**common)
    vit_cfg.experiment_name = f"vit_synthetic{n_classes}{suffix}"
    rawiq_cfg.experiment_name = f"rawiq_synthetic{n_classes}{suffix}"

    summary = run_head_to_head(
        vit_cfg, rawiq_cfg,
        comparison_dir=str(out_root / "comparison_results"),
        verbose=True,
        resume="auto",  # interrupted rungs re-run with the same command
    )
    out = out_root / "head_to_head_summary.json"
    out.write_text(json.dumps(summary, indent=2, default=float))
    print(json.dumps({k: summary[k] for k in ("vit", "rawiq")},
                     indent=2, default=float))
    print(f"summary -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
