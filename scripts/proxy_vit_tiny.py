#!/usr/bin/env python
"""BASELINE config 2 convergence proxy: ViT-Tiny on the synthetic RadioML
2016.10a task (11 classes incl. CPFSK/GFSK/analog AM/FM, 128-sample frames
folded to [1,16,16] images).

The real 2016.10a corpus is absent (zero egress), so this is the strongest
achievable accuracy evidence for the config-2 geometry: train to convergence
at the reference regime (batch 256, plateau LR factor 0.5/patience 5, early
stop patience 10 — ref: ViT/training/train.py:90-95,405-424) on the
synthetic generator's 11-class corpus, then evaluate with the full
confusion/report artifact set.

Usage: python scripts/proxy_vit_tiny.py [epochs] [frames_per_class] [numerics]
Artifacts under result/proxy2016/, summary JSON at
result/proxy2016/vit_tiny_summary.json.
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
    from vitiq.runner import run_training

    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    numerics = (sys.argv[3] if len(sys.argv) > 3
                else ("tpu" if jax.default_backend() != "cpu" else "reference"))

    out_root = pathlib.Path("result/proxy2016")
    cfg = ExperimentConfig.vit_tiny_2016(**{
        "data.synthetic_frames_per_class": frames,
        # same 8-point SNR ladder as the 19/24-class proxies (docs/proxy19)
        "data.synthetic_snr_db": (-8.0, -4.0, 0.0, 4.0, 8.0, 12.0, 16.0, 20.0),
        "model.numerics": numerics,
        "train.num_epochs": epochs,
        "checkpoint_dir": str(out_root / "ckpt"),
        "log_dir": str(out_root / "logs"),
    })
    cfg.experiment_name = "vit_tiny_2016"

    summary = run_training(cfg, evaluate_test=True, verbose=True)
    out = out_root / "vit_tiny_summary.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2, default=float))
    print(json.dumps({k: summary[k] for k in summary
                      if k in ("test_overall_accuracy", "test_snr_accuracies",
                               "best_val_loss", "epochs_run", "stopped_early",
                               "train_wall_seconds")},
                     indent=2, default=float))
    print(f"summary -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
