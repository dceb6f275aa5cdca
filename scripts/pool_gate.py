#!/usr/bin/env python
"""Accuracy gate: CLS-token vs MEAN-POOL readout on the rawIQ arm.

The reference's rawIQ head supports both poolings behind one flag
(transformer_rawIQ/models/transformer_rawIQ.py:88-93, USE_CLS_TOKEN);
every published reference checkpoint used CLS. Mean-pool matters for
serving because dropping the CLS row makes the token count a power of two
(seg-64: 17 -> 16 tokens), the tile the attention kernel works in. This
gate supplies the accuracy evidence for that serving geometry with the
same paired-seed protocol as the head-variant gates.

Usage:
  python scripts/pool_gate.py [epochs] [frames_per_class] \
      [comma-separated seeds] [numerics] [segment_size]
Defaults: 30 epochs, 512 frames/class, seeds 0..4, numerics auto,
segment_size=64. Writes pool_gate_validation.json; per-run ledger
pool_gate_runs.jsonl makes restarts skip completed runs.
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

    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    frames_per_class = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    seeds = [int(s) for s in (sys.argv[3].split(",") if len(sys.argv) > 3
                              else [str(i) for i in range(5)])]
    numerics = (sys.argv[4] if len(sys.argv) > 4
                else ("tpu" if jax.default_backend() != "cpu" else "reference"))
    segment_size = int(sys.argv[5]) if len(sys.argv) > 5 else 64

    classes = TARGET_MODULATIONS_19
    ledger = pathlib.Path("pool_gate_runs.jsonl")
    done = {}
    if ledger.exists():
        for line in ledger.read_text().splitlines():
            rec = json.loads(line)
            done[(rec["use_cls_token"], rec["seed"], rec["epochs"],
                  rec["frames_per_class"], rec["segment_size"],
                  rec["numerics"])] = rec

    results = {}
    for use_cls in (True, False):
        accs, vlosses = [], []
        for seed in seeds:
            key = (use_cls, seed, epochs, frames_per_class, segment_size,
                   numerics)
            rec = done.get(key)
            if rec is None:
                model = ModelConfig(
                    arm="rawiq", num_classes=len(classes), d_model=128,
                    n_head=8, n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                    segment_size=segment_size, use_cls_token=use_cls,
                    numerics=numerics)
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
                    experiment_name=f"pool_{'cls' if use_cls else 'mean'}"
                                    f"_seg{segment_size}_s{seed}",
                    checkpoint_dir="/tmp/pool_gate/ckpt",
                    log_dir="/tmp/pool_gate/logs",
                )
                summary = run_training(cfg, verbose=False)
                rec = {"use_cls_token": use_cls, "seed": seed,
                       "epochs": epochs,
                       "frames_per_class": frames_per_class,
                       "segment_size": segment_size, "numerics": numerics,
                       "test_overall_accuracy": summary["test_overall_accuracy"],
                       "best_val_loss": summary["best_val_loss"],
                       "epochs_run": summary["epochs_run"]}
                with ledger.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
            accs.append(rec["test_overall_accuracy"])
            vlosses.append(rec["best_val_loss"])
            print(f"use_cls={use_cls} seed={seed}: "
                  f"test acc {accs[-1]:.4f}", flush=True)

        results["cls" if use_cls else "mean_pool"] = {
            "per_seed_accuracy": accs,
            "mean_accuracy": statistics.mean(accs),
            "stdev_accuracy": statistics.stdev(accs) if len(accs) > 1 else 0.0,
            "mean_best_val_loss": statistics.mean(vlosses),
        }

    base = results["cls"]["per_seed_accuracy"]
    mp = results["mean_pool"]
    deltas = [a - b for a, b in zip(mp["per_seed_accuracy"], base)]
    mp["delta_vs_cls"] = statistics.mean(deltas)
    if len(deltas) > 1:
        sd = statistics.stdev(deltas)
        mp["paired_stdev"] = sd
        mp["paired_t"] = (statistics.mean(deltas) / (sd / len(deltas) ** 0.5)
                          if sd > 0 else 0.0)

    meta = {
        "regime": {"epochs": epochs, "frames_per_class": frames_per_class,
                   "seeds": seeds, "numerics": numerics,
                   "classes": len(classes), "n_layers": 6,
                   "arm": "rawiq", "segment_size": segment_size,
                   "backend": jax.default_backend()},
        **results,
    }
    out = pathlib.Path("pool_gate_validation.json")
    out.write_text(json.dumps(meta, indent=2))
    print(json.dumps(meta, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
