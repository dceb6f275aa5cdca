#!/usr/bin/env python
"""Accuracy gate for the d_head>=32 variants on the RAW-IQ arm.

Companion to scripts/head_variant_validation.py (which gates the ViT arm at
10 seeds / full depth): the head lever matters most on the 1025-token
arm, where attention dominates, but the
existing gate only certifies the shared encoder under the ViT tokenization.
This script runs the same paired-seed protocol on the rawIQ arm — default
embedding is conv1d (the arm the serving win targets; ref:
transformer_rawIQ/models/encoder.py:34-41) — so the H2/H4 recommendation
for long-sequence serving rests on arm-specific evidence.

The regime is bounded (1025-token training is ~10x the flagship's cost per
frame): fewer seeds/epochs than the ViT gate, reported as a supporting
check, not a replacement. Paired per-seed deltas + t statistics match the
primary gate's output format.

Usage:
  python scripts/rawiq_head_gate.py [epochs] [frames_per_class] \
      [comma-separated seeds] [numerics] [embedding] [segment_size]
Defaults: 15 epochs, 256 frames/class, seeds 0..4, numerics auto,
embedding=conv1d. Writes rawiq_head_validation.json; per-run ledger
rawiq_head_runs.jsonl makes restarts skip completed runs (same pattern
as the primary gate).
"""
import json
import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    import jax

    from vitiq.utils.compile_cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    from vitiq.config import (TARGET_MODULATIONS_19, DataConfig,
                              ExperimentConfig, ModelConfig, TrainConfig)
    from vitiq.runner import run_training

    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 15
    frames_per_class = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    seeds = [int(s) for s in (sys.argv[3].split(",") if len(sys.argv) > 3
                              else [str(i) for i in range(5)])]
    numerics = (sys.argv[4] if len(sys.argv) > 4
                else ("tpu" if jax.default_backend() != "cpu" else "reference"))
    embedding = sys.argv[5] if len(sys.argv) > 5 else "conv1d"
    segment_size = int(sys.argv[6]) if len(sys.argv) > 6 else 16

    classes = TARGET_MODULATIONS_19
    ledger = pathlib.Path("rawiq_head_runs.jsonl")
    # Resume key includes the regime so a rerun with a different embedding/
    # epochs/frames/segment_size does not silently reuse results from an
    # incompatible configuration. Records predating the regime fields (the
    # round-3 conv1d campaign, 30 epochs / 512 frames, segment_size
    # irrelevant for conv1d) carry those defaults.
    done = {}
    if ledger.exists():
        for line in ledger.read_text().splitlines():
            rec = json.loads(line)
            done[(rec["n_head"], rec["seed"], rec["embedding"],
                  rec.get("epochs", 30), rec.get("frames_per_class", 512),
                  rec.get("segment_size", 16))] = rec

    results = {}
    for n_head in (8, 4, 2):
        accs, vlosses = [], []
        for seed in seeds:
            rec = done.get((n_head, seed, embedding, epochs,
                            frames_per_class, segment_size))
            if rec is None:
                model = ModelConfig(
                    arm="rawiq", num_classes=len(classes), d_model=128,
                    n_head=n_head, n_layers=6, ffn_hidden=1024,
                    drop_prob=0.2, embedding_type=embedding,
                    segment_size=segment_size, numerics=numerics)
                cfg = ExperimentConfig(
                    model=model,
                    data=DataConfig(source="synthetic", synthetic_classes=classes,
                                    synthetic_frames_per_class=frames_per_class,
                                    synthetic_snr_db=(0.0, 4.0, 8.0, 12.0, 16.0, 20.0),
                                    synthetic_seed=seed),
                    train=TrainConfig(batch_size=256, num_epochs=epochs,
                                      patience=epochs, init_seed=seed,
                                      dropout_seed=seed + 100,
                                      shuffle_seed=seed + 200),
                    experiment_name=f"rawiq_head_{embedding}_h{n_head}_s{seed}",
                    checkpoint_dir="/tmp/rawiq_head/ckpt",
                    log_dir="/tmp/rawiq_head/logs",
                )
                summary = run_training(cfg, verbose=False)
                rec = {"n_head": n_head, "seed": seed,
                       "embedding": embedding, "epochs": epochs,
                       "frames_per_class": frames_per_class,
                       "segment_size": segment_size,
                       "test_overall_accuracy": summary["test_overall_accuracy"],
                       "best_val_loss": summary["best_val_loss"],
                       "epochs_run": summary["epochs_run"]}
                with ledger.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
            accs.append(rec["test_overall_accuracy"])
            vlosses.append(rec["best_val_loss"])
            print(f"n_head={n_head} seed={seed}: test acc {accs[-1]:.4f}",
                  flush=True)

        results[f"h{n_head}"] = {
            "d_head": 128 // n_head,
            "per_seed_accuracy": accs,
            "mean_accuracy": statistics.mean(accs),
            "stdev_accuracy": statistics.stdev(accs) if len(accs) > 1 else 0.0,
            "mean_best_val_loss": statistics.mean(vlosses),
        }

    base = results["h8"]["per_seed_accuracy"]
    for k, v in results.items():
        deltas = [a - b for a, b in zip(v["per_seed_accuracy"], base)]
        v["delta_vs_h8"] = statistics.mean(deltas)
        if len(deltas) > 1 and k != "h8":
            sd = statistics.stdev(deltas)
            v["paired_stdev"] = sd
            v["paired_t"] = (statistics.mean(deltas)
                             / (sd / len(deltas) ** 0.5) if sd > 0 else 0.0)

    meta = {
        "regime": {"epochs": epochs, "frames_per_class": frames_per_class,
                   "seeds": seeds, "numerics": numerics,
                   "classes": len(classes), "n_layers": 6,
                   "arm": "rawiq", "embedding": embedding,
                   "backend": jax.default_backend()},
        **results,
    }
    out = pathlib.Path("rawiq_head_validation.json")
    out.write_text(json.dumps(meta, indent=2))
    print(json.dumps(meta, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
