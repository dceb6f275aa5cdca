"""Command-line interface: train / evaluate / compare / visualize / sweep / bench.

One CLI replaces the reference's five separate entry scripts (per-arm
train.py / evaluate.py, compare_models.py, plot_preprocessing_signal.py and
the broken hyperparameter_tuning.py). Flag names mirror the reference's
argparse surface (ref: ViT/training/train.py:121-144,
transformer_rawIQ/training/train.py:170-199) so commands translate 1:1.
"""

from __future__ import annotations

import argparse
import json
import sys

from vitiq.config import ExperimentConfig


PRESETS = ("vit_reference", "vit_tpu_production", "vit_synthetic19",
           "rawiq_synthetic19", "vit_tiny_2016", "rawiq_reference",
           "rawiq_best")


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arm", choices=["vit", "rawiq"], default=None)
    p.add_argument("--config", type=str, help="Path to experiment config JSON")
    p.add_argument("--preset", choices=PRESETS,
                   help="start from a named ExperimentConfig preset (e.g. "
                        "rawiq_best = the reference's best published "
                        "checkpoint config, vit_tpu_production = the "
                        "d_head=64 variant); individual "
                        "flags still override")
    # data
    p.add_argument("--source", choices=["synthetic", "hdf5"], default=None)
    p.add_argument("--features", choices=["iq", "amp_phase", "spectrogram"],
                   default=None,
                   help="input features: raw I/Q (reference), the MDF "
                        "amplitude/phase transform (rawiq), or STFT "
                        "spectrogram images (vit)")
    p.add_argument("--file_path", type=str, help="Path to HDF5 data file")
    p.add_argument("--json_path", type=str, help="Path to classes JSON file")
    p.add_argument("--sps", type=int, default=None,
                   help="samples per symbol: 1 = RadioML bypass (default); "
                        ">=2 runs the RRC matched-filter + timing-recovery "
                        "front-end inside the jitted step (BASELINE config 3)")
    p.add_argument("--timing_method",
                   choices=["simple_energy", "simple_correlation", "gardner",
                            "mueller_muller"],
                   default=None, help="timing recovery for --sps >= 2")
    p.add_argument("--timing_hybrid_window", type=int, default=None,
                   help="gardner/mueller_muller: hybrid tracking-window "
                        "length (default 64; 0 = full per-symbol feedback "
                        "loop for drifting clocks)")
    p.add_argument("--streaming", action="store_true", default=None,
                   help="stream splits from the HDF5 file (out-of-core: "
                        "bounded RSS via windowed sequential reads) instead "
                        "of materializing them in RAM")
    p.add_argument("--stream_window_rows", type=int,
                   help="shuffle-window size (rows) for --streaming")
    p.add_argument("--profile_steps", action="store_true", default=None,
                   help="record per-step wall times; history gains "
                        "step_p50/step_p90 and summary a StepTimer report")
    # training
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_epochs", type=int)
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--weight_decay", type=float)
    p.add_argument("--grad_clip_max_norm", type=float)
    p.add_argument("--data_parallel", type=int)
    p.add_argument("--model_parallel", type=int)
    # model
    p.add_argument("--d_model", type=int)
    p.add_argument("--n_head", type=int)
    p.add_argument("--n_layers", type=int)
    p.add_argument("--ffn_hidden", type=int)
    p.add_argument("--drop_prob", type=float)
    p.add_argument("--patch_size", type=int)
    p.add_argument("--segment_size", type=int)
    p.add_argument("--seq_length", type=int,
                   help="rawiq arm: token-stream length the model consumes "
                        "(= frame_len / sps)")
    p.add_argument("--frame_len", type=int,
                   help="synthetic source: samples per generated frame")
    p.add_argument("--frames_per_class", type=int,
                   help="synthetic source: frames generated per class")
    p.add_argument("--shaping_sps", type=int,
                   help="synthetic source: RRC-shape constellation frames at "
                        "this oversampling (pairs with --sps)")
    p.add_argument("--embedding_type", choices=["conv1d", "segment"])
    p.add_argument("--pooling", choices=["cls", "mean"],
                   help="rawiq arm readout (reference USE_CLS_TOKEN flag, "
                        "transformer_rawIQ.py:88-93): 'mean' drops the CLS "
                        "row (seg-64 then serves 16 tokens)")
    p.add_argument("--numerics", choices=["reference", "tpu"])
    # other
    p.add_argument("--resume", type=str, help="Path to checkpoint to resume from")
    p.add_argument("--experiment_name", type=str)
    p.add_argument("--no_validate_config", action="store_true")


def _config_from_args(args) -> ExperimentConfig:
    if args.config:
        cfg = ExperimentConfig.from_json(args.config)
    elif getattr(args, "preset", None):
        cfg = getattr(ExperimentConfig, args.preset)()
    elif args.arm == "rawiq":
        cfg = ExperimentConfig.rawiq_reference()
    else:
        cfg = ExperimentConfig.vit_reference()
    if args.arm and args.arm != cfg.model.arm:
        cfg.model.arm = args.arm
        cfg.model.in_channels = 0
        cfg.model.__post_init__()  # re-derive in_channels for the arm
    overrides = {
        "data.source": args.source,
        "data.features": args.features,
        "data.file_path": args.file_path,
        "data.json_path": args.json_path,
        "data.streaming": args.streaming,
        "data.stream_window_rows": args.stream_window_rows,
        "data.sps": args.sps,
        "data.timing_method": args.timing_method,
        "data.timing_hybrid_window": args.timing_hybrid_window,
        "train.profile_steps": args.profile_steps,
        "train.batch_size": args.batch_size,
        "train.num_epochs": args.num_epochs,
        "train.learning_rate": args.learning_rate,
        "train.weight_decay": args.weight_decay,
        "train.grad_clip_max_norm": args.grad_clip_max_norm,
        "train.data_parallel": args.data_parallel,
        "train.model_parallel": args.model_parallel,
        "model.d_model": args.d_model,
        "model.n_head": args.n_head,
        "model.n_layers": args.n_layers,
        "model.ffn_hidden": args.ffn_hidden,
        "model.drop_prob": args.drop_prob,
        "model.patch_size": args.patch_size,
        "model.segment_size": args.segment_size,
        "model.seq_length": args.seq_length,
        "data.synthetic_frame_len": args.frame_len,
        "data.synthetic_frames_per_class": args.frames_per_class,
        "data.synthetic_shaping_sps": args.shaping_sps,
        "model.embedding_type": args.embedding_type,
        "model.use_cls_token": (None if args.pooling is None
                                else args.pooling == "cls"),
        "model.numerics": args.numerics,
        "experiment_name": args.experiment_name,
    }
    from vitiq.config import _apply_overrides
    cfg = _apply_overrides(cfg, overrides)
    if cfg.data.source == "synthetic":
        # synthetic class count drives the head size
        cfg.model.num_classes = len(cfg.data.synthetic_classes)
    if not args.no_validate_config:
        cfg.validate(check_paths=cfg.data.source == "hdf5")
    return cfg


def cmd_train(args) -> int:
    from vitiq.runner import run_training

    cfg = _config_from_args(args)
    summary = run_training(cfg, resume=args.resume)
    print(json.dumps({k: v for k, v in summary.items() if k != "history"},
                     indent=2, default=float))
    return 0


def cmd_evaluate(args) -> int:
    if getattr(args, "torch_checkpoint", None):
        from vitiq.runner import run_reference_evaluation

        res = run_reference_evaluation(
            args.torch_checkpoint, config_path=args.config,
            output_dir=args.output, dataset=args.dataset,
            batch_size=args.batch_size, data_path=args.data_path,
            json_path=args.json_path)
        print(f"overall accuracy: {res['overall_accuracy'] * 100:.2f}%")
        for snr, acc in sorted(res["snr_accuracies"].items()):
            print(f"  SNR {snr:+3d} dB: {acc * 100:.2f}%")
        return 0
    if not args.checkpoint:
        raise SystemExit("evaluate: --checkpoint or --torch-checkpoint is required")
    from vitiq.runner import run_evaluation

    res = run_evaluation(args.checkpoint, dataset=args.dataset,
                         batch_size=args.batch_size, config_path=args.config,
                         int8=args.int8)
    print(f"overall accuracy: {res['overall_accuracy'] * 100:.2f}%")
    for snr, acc in sorted(res["snr_accuracies"].items()):
        print(f"  SNR {snr:+3d} dB: {acc * 100:.2f}%")
    return 0


def cmd_export(args) -> int:
    from vitiq.serve import export_from_experiment

    out = export_from_experiment(
        args.experiment_dir, args.output,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        platforms=args.platforms.split(",") if args.platforms else None,
        checkpoint=args.checkpoint,
    )
    manifest = json.loads((out / "manifest.json").read_text())
    print(json.dumps({"artifact": str(out),
                      "batch_sizes": manifest["batch_sizes"],
                      "platforms": manifest["platforms"],
                      "entries": manifest["entries"]}, indent=2))
    return 0


def cmd_compare(args) -> int:
    from vitiq.eval import ModelComparison

    mc = ModelComparison(args.vit_report, args.transformer_report,
                         output_dir=args.output_dir)
    mc.run_comparison()
    return 0


def cmd_head_to_head(args) -> int:
    import copy

    from vitiq.runner import run_head_to_head

    base_name = args.experiment_name or "h2h"
    args.arm = "vit"
    vit_cfg = _config_from_args(args)
    vit_cfg.experiment_name = f"{base_name}_vit"
    rawiq_args = copy.copy(args)
    rawiq_args.arm = "rawiq"
    # arm-specific model flags reset to rawiq defaults unless user-overridden
    rawiq_cfg = _config_from_args(rawiq_args)
    rawiq_cfg.data = copy.deepcopy(vit_cfg.data)  # identical data for both arms
    rawiq_cfg.data.features = "iq"
    rawiq_cfg.experiment_name = f"{base_name}_rawiq"
    result = run_head_to_head(vit_cfg, rawiq_cfg, comparison_dir=args.output_dir)
    print(json.dumps(result, indent=2, default=float))
    return 0


def cmd_visualize(args) -> int:
    from vitiq.viz import run_visualization

    run_visualization(
        file_path=args.file_path, json_path=args.json_path,
        output_dir=args.output_dir, modulations=args.modulations,
        num_samples=args.num_samples, create_overview=args.create_overview,
        dpi=args.dpi, sps=args.sps,
    )
    return 0


def cmd_sweep(args) -> int:
    from vitiq.sweep import run_pso_sweep

    best = run_pso_sweep(
        n_particles=args.n_particles, iters=args.iters, seed=args.seed,
        train_steps=args.train_steps, source=args.source,
        file_path=args.file_path, json_path=args.json_path,
        output_path=args.output,
        resume_path=args.output if getattr(args, "resume", False) else None,
    )
    print(json.dumps(best, indent=2, default=float))
    return 0


def cmd_bench(args) -> int:
    import contextlib

    from vitiq.bench import run_benchmarks

    ctx = contextlib.nullcontext()
    if getattr(args, "trace", None):
        # --trace DIR: capture a jax.profiler trace (Perfetto/XProf) of the
        # bench window (SURVEY.md §5 tracing integration)
        from vitiq.utils.profiling import trace_context

        ctx = trace_context(args.trace)
    with ctx:
        result = run_benchmarks(
            which=args.which, batch_size=args.batch_size, steps=args.steps,
            n_head=getattr(args, "n_head", None),
            data_parallel=getattr(args, "data_parallel", None),
            sps=getattr(args, "sps", 2) or 2,
            timing_method=getattr(args, "timing_method", None))
    if getattr(args, "trace", None):
        result["trace_dir"] = args.trace
    print(json.dumps(result, default=float))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vitiq", description="AMC framework (ViT vs raw-IQ) on JAX"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="Train an AMC transformer")
    _add_train_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="Evaluate a trained experiment")
    p.add_argument("--checkpoint",
                   help="Experiment directory (containing config.json + model_best)")
    p.add_argument("--torch-checkpoint", dest="torch_checkpoint",
                   help="Evaluate a REFERENCE PyTorch .pth instead: imports "
                        "the weights through vitiq.interop and produces the "
                        "full eval artifact set (config from --config, a "
                        "sibling config.json, or the checkpoint's embedded "
                        "reference config)")
    p.add_argument("--data-path", dest="data_path",
                   help="HDF5 dataset path override (with --torch-checkpoint)")
    p.add_argument("--json-path", dest="json_path",
                   help="classes JSON path override (with --torch-checkpoint)")
    p.add_argument("--output",
                   help="Artifact directory (with --torch-checkpoint; default "
                        "result/reference_import/<stem>/evaluation)")
    p.add_argument("--dataset", choices=["train", "valid", "test"], default="test")
    p.add_argument("--batch_size", type=int)
    p.add_argument("--config", type=str, help="Override config JSON path")
    p.add_argument("--int8", action="store_true",
                   help="Evaluate through the int8 W8A8 serving path")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser(
        "export",
        help="Export an AOT-compiled serving artifact (jax.export) from a "
             "trained experiment — deployable without model code")
    p.add_argument("--experiment_dir", required=True,
                   help="Training-run directory (config.json + "
                        "normalization_stats.json + model_best.npz)")
    p.add_argument("--output", required=True, help="Artifact directory to write")
    p.add_argument("--batch_sizes", default="256,8192",
                   help="Comma-separated fixed batch buckets to compile")
    p.add_argument("--platforms", default=None,
                   help="Comma-separated lowering targets (e.g. cuda or "
                        "cpu,cuda); default: current backend")
    p.add_argument("--checkpoint", default="model_best.npz",
                   help="Weights file inside the experiment dir")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("compare", help="Compare two classification reports")
    p.add_argument("--vit_report", required=True)
    p.add_argument("--transformer_report", required=True)
    p.add_argument("--output_dir", default="comparison_results")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("head-to-head",
                       help="Train both arms on the same data and compare")
    _add_train_args(p)
    p.add_argument("--output_dir", default="comparison_results")
    p.set_defaults(fn=cmd_head_to_head)

    p = sub.add_parser("visualize", help="Preprocessing visualization figures")
    p.add_argument("--file_path", type=str, default=None,
                   help="HDF5 path (omit for synthetic data)")
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--output_dir", default="visualization_results")
    p.add_argument("--modulations", nargs="+", default=None)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--create_overview", action="store_true")
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--sps", type=int, default=1)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("sweep", help="PSO hyperparameter search")
    p.add_argument("--n_particles", type=int, default=18)
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_steps", type=int, default=30)
    p.add_argument("--source", choices=["synthetic", "hdf5"], default="synthetic")
    p.add_argument("--file_path", type=str)
    p.add_argument("--json_path", type=str)
    p.add_argument("--output", type=str, default="sweep_results.json")
    p.add_argument("--resume", action="store_true",
                   help="Resume the exact swarm trajectory from a partial "
                        "trace at --output (written every iteration)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("bench", help="Throughput / latency benchmarks")
    p.add_argument("--which", default="fused_vit_infer",
                   choices=["fused_vit_infer", "vit_tiny_infer", "rawiq_infer", "rawiq_mp_infer",
                            "rawiq64_infer", "rawiq64_mp_infer", "rawiq_best_mp_infer",
                            "rawiq_best_infer", "conv1d_infer", "int8_infer",
                            "train_step", "head_variant", "dsp_frontend",
                            "sps_infer", "ingestion", "e2e_serving",
                            "streaming", "all"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--sps", type=int, default=2,
                   help="sps_infer: samples per symbol for the fused DSP+"
                        "classifier bench")
    p.add_argument("--timing_method", default=None,
                   choices=["simple_energy", "simple_correlation", "gardner",
                            "mueller_muller"],
                   help="sps_infer: timing-recovery method (default gardner)")
    p.add_argument("--n_head", type=int, default=None,
                   help="head_variant: override the flagship head count "
                        "(d_head = d_model / n_head)")
    p.add_argument("--data_parallel", type=int, default=None,
                   help="shard the bench batch over a data mesh of this "
                        "many devices (serving scale-out)")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the bench window "
                        "into DIR (view with XProf/Perfetto)")
    p.set_defaults(fn=cmd_bench)

    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vitiq.utils.compile_cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
