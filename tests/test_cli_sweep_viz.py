"""Tests for the CLI surface, the PSO engine, and the visualization tool."""

import json

import numpy as np
import pytest

from vitiq.cli import build_parser, _config_from_args
from vitiq.sweep import (
    MIN_BOUNDS,
    MAX_BOUNDS,
    decode_particle,
    global_best_pso,
)


class TestCLIParser:
    def test_train_defaults_vit(self):
        args = build_parser().parse_args(["train"])
        cfg = _config_from_args(args)
        assert cfg.model.arm == "vit"
        assert cfg.model.d_model == 128 and cfg.model.n_layers == 6
        assert cfg.train.weight_decay == 1e-3  # ViT arm default

    def test_train_rawiq_defaults(self):
        args = build_parser().parse_args(["train", "--arm", "rawiq"])
        cfg = _config_from_args(args)
        assert cfg.model.arm == "rawiq"
        assert cfg.model.ffn_hidden == 1024 and cfg.model.drop_prob == 0.2
        assert cfg.train.weight_decay == 1e-4
        assert cfg.model.in_channels == 2

    def test_preset_flag(self):
        """--preset selects a named ExperimentConfig preset; flags still
        override on top; the preset's arm wins unless --arm is explicit."""
        args = build_parser().parse_args(["train", "--preset", "rawiq_best"])
        cfg = _config_from_args(args)
        assert cfg.model.arm == "rawiq"
        assert (cfg.model.d_model, cfg.model.n_layers) == (256, 9)
        assert cfg.train.batch_size == 128
        args = build_parser().parse_args(
            ["train", "--preset", "vit_tpu_production", "--n_layers", "3"])
        cfg = _config_from_args(args)
        assert cfg.model.arm == "vit" and cfg.model.n_head == 2
        assert cfg.model.n_layers == 3

    def test_overrides_reach_config(self):
        args = build_parser().parse_args([
            "train", "--arm", "rawiq", "--d_model", "64", "--n_head", "4",
            "--learning_rate", "3e-4", "--batch_size", "32",
            "--embedding_type", "conv1d", "--numerics", "tpu",
        ])
        cfg = _config_from_args(args)
        assert cfg.model.d_model == 64
        assert cfg.model.embedding_type == "conv1d"
        assert cfg.model.numerics == "tpu"
        assert cfg.train.learning_rate == pytest.approx(3e-4)
        assert cfg.train.batch_size == 32

    def test_synthetic_source_adjusts_classes(self):
        args = build_parser().parse_args(["train", "--source", "synthetic"])
        cfg = _config_from_args(args)
        assert cfg.model.num_classes == len(cfg.data.synthetic_classes)

    def test_invalid_override_rejected(self):
        args = build_parser().parse_args(["train", "--d_model", "30"])
        with pytest.raises(ValueError):
            _config_from_args(args)

    def test_config_json_loading(self, tmp_path):
        from vitiq.config import ExperimentConfig
        p = tmp_path / "c.json"
        ExperimentConfig.rawiq_reference(**{"model.n_layers": 9}).to_json(p)
        args = build_parser().parse_args(["train", "--arm", "rawiq",
                                          "--config", str(p),
                                          "--source", "synthetic"])
        cfg = _config_from_args(args)
        assert cfg.model.n_layers == 9

    def test_all_subcommands_parse(self):
        parser = build_parser()
        for argv in (["train"],
                     ["evaluate", "--checkpoint", "x"],
                     ["compare", "--vit_report", "a", "--transformer_report", "b"],
                     ["visualize"],
                     ["sweep"],
                     ["bench"]):
            args = parser.parse_args(argv)
            assert callable(args.fn)


class TestPSO:
    def test_converges_on_sphere(self):
        """Global-best PSO must find the minimum of a shifted sphere."""
        lo = np.full(4, -5.0)
        hi = np.full(4, 5.0)
        target = np.array([1.0, -2.0, 0.5, 3.0])

        def fitness(X):
            return np.sum((X - target) ** 2, axis=1)

        res = global_best_pso(fitness, n_particles=20, iters=60, seed=0,
                              bounds=(lo, hi))
        assert res.best_cost < 1e-2
        np.testing.assert_allclose(res.best_position, target, atol=0.2)

    def test_cost_history_monotone(self):
        def fitness(X):
            return np.sum(X ** 2, axis=1)

        res = global_best_pso(fitness, n_particles=8, iters=20, seed=1,
                              bounds=(np.full(3, -1.0), np.full(3, 1.0)))
        h = np.asarray(res.cost_history)
        assert (np.diff(h) <= 1e-12).all()  # gbest never regresses

    def test_respects_bounds(self):
        seen = []

        def fitness(X):
            seen.append(X.copy())
            return np.sum(X, axis=1)

        global_best_pso(fitness, n_particles=6, iters=10, seed=2,
                        bounds=(np.zeros(2), np.ones(2)))
        allx = np.concatenate(seen)
        assert (allx >= 0).all() and (allx <= 1).all()

    def test_decode_particle_always_valid(self):
        """Every point in the search box must decode to a buildable config
        (the reference sketch crashed on most of its own space)."""
        from vitiq.config import ModelConfig
        rng = np.random.default_rng(3)
        for _ in range(200):
            p = rng.uniform(MIN_BOUNDS, MAX_BOUNDS)
            hp = decode_particle(p)
            assert hp["d_model"] % hp["n_head"] == 0
            if hp["arm"] == "vit":
                assert 32 % hp["patch_size"] == 0 and 64 % hp["patch_size"] == 0
                ModelConfig(arm="vit", num_classes=3, d_model=hp["d_model"],
                            n_head=hp["n_head"], n_layers=hp["n_layers"],
                            ffn_hidden=hp["ffn_hidden"], drop_prob=hp["drop_prob"],
                            patch_size=hp["patch_size"]).validate()
            else:
                assert 1024 % hp["segment_size"] == 0
                ModelConfig(arm="rawiq", num_classes=3, d_model=hp["d_model"],
                            n_head=hp["n_head"], n_layers=hp["n_layers"],
                            ffn_hidden=hp["ffn_hidden"], drop_prob=hp["drop_prob"],
                            segment_size=hp["segment_size"]).validate()

    def test_search_space_matches_reference_sketch(self):
        np.testing.assert_array_equal(MIN_BOUNDS, [0, 32, 2, 1, 64, 0.0, 1e-5, 16, 4])
        np.testing.assert_array_equal(MAX_BOUNDS, [1, 512, 16, 8, 2048, 0.4, 5e-3, 128, 64])


class TestViz:
    def test_synthetic_figures_written(self, tmp_path):
        from vitiq.viz import run_visualization

        written = run_visualization(output_dir=str(tmp_path), modulations=["BPSK", "QPSK"],
                                    num_samples=1, create_overview=True, dpi=60)
        assert len(written) == 3
        for p in written:
            assert p.exists() and p.stat().st_size > 1000

    def test_sps2_pipeline_figure(self, tmp_path):
        from vitiq.viz import run_visualization

        written = run_visualization(output_dir=str(tmp_path), modulations=["QPSK"],
                                    num_samples=1, dpi=60, sps=2)
        assert written[0].exists()

    def test_unknown_synthetic_modulation(self, tmp_path):
        from vitiq.viz import run_visualization

        # NOTE "FM" became a real synthetic class in round 3 (analog suite)
        with pytest.raises(ValueError):
            run_visualization(output_dir=str(tmp_path), modulations=["ZAP-9"])


class TestBenchEntry:
    def test_bench_fused_infer_smoke(self):
        from vitiq.bench import bench_fused_infer

        res = bench_fused_infer("rawiq", batch_size=16, steps=2, numerics="reference")
        assert res["value"] > 0
        assert res["unit"] == "frames/s"
        assert "p50_latency_ms" in res

    def test_bench_meanpool_arm_smoke(self):
        """The seg-64 mean-pool arm (the 1M-frames/s geometry) must bench
        end-to-end; its config serves 16 tokens with no CLS row."""
        from vitiq.bench import bench_fused_infer, rawiq_seg64_mp_config

        assert rawiq_seg64_mp_config().num_tokens == 16
        res = bench_fused_infer("rawiq_seg64_mp", batch_size=16, steps=2,
                                numerics="reference")
        assert res["value"] > 0

    def test_bench_vit_tiny_arm(self):
        """BASELINE config 2 (ViT-Tiny 2016.10a geometry: 128-sample frames,
        16x16 images, 11 classes) benches end-to-end with its own fold
        geometry (regression: the vit preprocess used to hardwire 32x64)."""
        from vitiq.bench import bench_fused_infer, vit_tiny_2016_config

        cfg = vit_tiny_2016_config()
        assert cfg.num_tokens == 17 and cfg.num_classes == 11  # 16 patches + CLS
        res = bench_fused_infer("vit_tiny", batch_size=16, steps=2,
                                numerics="reference")
        assert res["value"] > 0

    def test_bench_train_step_arm_configs(self):
        """bench_train_step resolves every served arm via ARM_CONFIGS
        (regression: it used to hardwire vit/rawiq, so new arms silently
        benched the wrong config)."""
        from vitiq import bench as B

        assert set(B.ARM_CONFIGS) >= {"vit", "rawiq", "rawiq_seg64",
                                      "rawiq_seg64_mp", "rawiq_mp",
                                      "rawiq_best", "rawiq_conv1d",
                                      "vit_tiny"}
        res = B.bench_train_step("rawiq_seg64_mp", batch_size=32, steps=2,
                                 numerics="reference")
        assert res["value"] > 0

    def test_graft_entry(self):
        import sys
        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as g
        import jax

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out.shape == (64, 19)

    def test_graft_dryrun_8(self):
        import sys
        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as g

        g.dryrun_multichip(8)


def test_timing_recovery_comparison_figure(tmp_path):
    """One figure, all four contract methods, true-vs-recovered strobes
    (parity with the reference's test_dsp_functions.py:175-241 visual)."""
    from vitiq.viz import plot_timing_recovery_comparison

    p = plot_timing_recovery_comparison(tmp_path / "timing.png", dpi=60)
    assert p.exists() and p.stat().st_size > 10_000


def test_run_visualization_emits_timing_panel_at_sps2(tmp_path):
    from vitiq.viz import run_visualization

    written = run_visualization(output_dir=str(tmp_path), modulations=["QPSK"],
                                num_samples=1, sps=2, dpi=60)
    names = {p.name for p in written}
    assert "timing_recovery_comparison.png" in names


def test_decode_particle_bucketing():
    """bucket=True snaps shape-affecting dims to the coarse grids while
    leaving the (state-injected, recompile-free) learning rate continuous."""
    from vitiq.sweep import MAX_BOUNDS, MIN_BOUNDS, decode_particle

    rng = np.random.default_rng(0)
    for _ in range(50):
        p = rng.uniform(MIN_BOUNDS, MAX_BOUNDS)
        hp = decode_particle(p, bucket=True)
        assert hp["n_head"] in (2, 4, 8, 16)
        assert hp["ffn_hidden"] in (64, 128, 256, 512, 1024, 2048)
        assert hp["batch_size"] in (16, 32, 64, 128)
        assert abs(hp["drop_prob"] * 20 - round(hp["drop_prob"] * 20)) < 1e-9
        assert hp["d_model"] % hp["n_head"] == 0
        # lr must NOT be snapped
        loose = decode_particle(p, bucket=False)
        assert hp["learning_rate"] == loose["learning_rate"]


def test_fitness_memoizes_compiles_per_architecture():
    """Re-evaluating particles that decode to the same architecture (or that
    differ only in learning rate) must not grow the compile cache — what
    keeps a sweep affordable on an accelerator (VERDICT r1 item 7)."""
    from vitiq.data import SyntheticAMCDataset
    from vitiq.sweep import make_amc_fitness

    ds = SyntheticAMCDataset(classes=("BPSK", "QPSK"), frames_per_class=64,
                             frame_len=64, seed=0)
    train = (ds.X[:96], ds.Y[:96])
    valid = (ds.X[96:], ds.Y[96:])
    fitness = make_amc_fitness(train, valid, num_classes=2, seq_length=64,
                               train_steps=1, eval_batches=1, bucket=True)
    base = np.array([1.0, 64, 4, 1, 64, 0.1, 1e-4, 16, 16], np.float64)
    lr_twin = base.copy(); lr_twin[6] = 3e-4      # same arch, different lr
    near = base.copy(); near[1] = 70; near[4] = 60  # buckets to the same arch
    X = np.stack([base, lr_twin, near])
    c1 = fitness(X)
    assert len(fitness.compile_cache) == 1
    c2 = fitness(X)
    assert len(fitness.compile_cache) == 1
    assert np.allclose(c1, c2)
    # the lr really is injected per-evaluation state, not a compile constant
    # (one tiny-data train step won't reliably move accuracy, so assert the
    # mechanism rather than the outcome)
    from vitiq.train.optim import create_train_state, set_learning_rate

    cfg, tcfg, _, _ = next(iter(fitness.compile_cache.values()))
    import jax as _jax
    from vitiq.models import init_amc_params as _init

    st = create_train_state(_init(_jax.random.PRNGKey(0), cfg), tcfg)
    st = set_learning_rate(st, 3e-4)
    assert abs(float(st.opt_state.hyperparams["learning_rate"]) - 3e-4) < 1e-9


def test_pso_resume_reproduces_trajectory():
    """Round 5: the per-iteration swarm state persisted by on_iter must
    resume the EXACT trajectory — a sweep interrupted at iteration k and
    resumed matches the uninterrupted run bit-for-bit."""
    import numpy as np

    from vitiq.sweep import global_best_pso

    def fitness(X):
        return np.sum((X - 0.3) ** 2, axis=1)

    bounds = (np.zeros(3), np.ones(3))
    full = global_best_pso(fitness, n_particles=5, iters=6, seed=3,
                           bounds=bounds)

    captured = {}

    def grab(it, gx, gc, hist, swarm_state):
        if it == 2:
            # JSON round-trip, exactly like the persisted artifact
            import json

            captured["state"] = json.loads(json.dumps(swarm_state))

    global_best_pso(fitness, n_particles=5, iters=3, seed=3, bounds=bounds,
                    on_iter=grab)
    assert "state" in captured
    resumed = global_best_pso(fitness, n_particles=5, iters=6, seed=3,
                              bounds=bounds, init_state=captured["state"])
    np.testing.assert_allclose(resumed.best_position, full.best_position)
    assert resumed.best_cost == full.best_cost
    np.testing.assert_allclose(resumed.cost_history, full.cost_history)
    assert resumed.evaluations == full.evaluations


def test_bench_slope_timing_diagnostics():
    """The fori-slope timing path exposes its self-diagnostics
    (timing_method, overhead, chosen depth), and every result names the
    device it was measured on."""
    import jax

    from vitiq.bench import bench_fused_infer

    r = bench_fused_infer("rawiq_seg64_mp", batch_size=16, steps=2)
    assert r["timing_method"] == "fori-slope"
    assert r["k_big"] >= 3
    assert r["overhead_p50_ms"] >= 0.0
    assert r["value"] > 0
    d = jax.devices()[0]
    assert (r["platform"], r["device_kind"], r["device_count"]) == (
        d.platform, d.device_kind, len(jax.devices()))
