"""Aux coverage: feature extractor, MDF transform, profiling utils, runner
interrupted-checkpoint rescue."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitiq.config import ModelConfig


class TestFeatureExtractor:
    def test_cls_and_sequence_outputs(self):
        from vitiq.models import init_amc_params
        from vitiq.models.amc import make_feature_extractor

        cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=32, n_head=4,
                          n_layers=1, ffn_hidden=64, seq_length=64, segment_size=16)
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        feats = make_feature_extractor(cfg)(params, jnp.zeros((2, 2, 64)))
        assert feats["cls_output"].shape == (2, 32)
        assert feats["sequence_output"].shape == (2, 4, 32)

    def test_no_cls_mode(self):
        from vitiq.models import init_amc_params
        from vitiq.models.amc import make_feature_extractor

        cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=32, n_head=4,
                          n_layers=1, ffn_hidden=64, seq_length=64,
                          segment_size=16, use_cls_token=False)
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        feats = make_feature_extractor(cfg)(params, jnp.zeros((2, 2, 64)))
        assert feats["cls_output"] is None
        assert feats["sequence_output"].shape == (2, 4, 32)


class TestMDFTransform:
    def test_shapes_and_ranges(self):
        from vitiq.dsp.frontend import preprocess_batch_mdf

        x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 1024, 2)),
                        jnp.float32)
        amp, phase, seq = preprocess_batch_mdf(x)
        assert amp.shape == (3, 1, 32, 32)
        assert phase.shape == (3, 1, 32, 32)
        assert seq is x
        a = np.asarray(amp)
        p = np.asarray(phase)
        assert a.min() >= 0 and a.max() <= 1.0 + 1e-6  # per-frame max scaling
        assert p.min() >= -1.0 - 1e-6 and p.max() <= 1.0 + 1e-6  # /pi

    def test_bad_length(self):
        from vitiq.dsp.frontend import preprocess_batch_mdf

        with pytest.raises(ValueError):
            preprocess_batch_mdf(jnp.zeros((1, 100, 2)))


class TestProfilingUtils:
    def test_format_time(self):
        from vitiq.utils import format_time

        assert format_time(5.2) == "5.2s"
        assert format_time(75) == "1m 15s"
        assert format_time(3723) == "1h 2m"

    def test_step_timer_summary(self):
        import time
        from vitiq.utils import StepTimer

        t = StepTimer()
        for _ in range(4):
            with t.step():
                time.sleep(0.002)
        s = t.summary(skip_first=1)
        assert s["steps"] == 3
        assert s["p50_s"] >= 0.002
        assert t.summary(skip_first=10)["steps"] == 4  # falls back to all

    def test_trace_context_writes(self, tmp_path):
        from vitiq.utils import trace_context

        with trace_context(str(tmp_path)):
            jnp.ones((8, 8)).sum().block_until_ready()
        assert any(tmp_path.rglob("*"))  # profile artifacts written

    def test_trace_disabled_noop(self, tmp_path):
        from vitiq.utils import trace_context

        with trace_context(str(tmp_path), enabled=False):
            pass
        assert not any(tmp_path.rglob("*"))


class TestInterruptRescue:
    def test_rescue_checkpoint_written(self, tmp_path, monkeypatch):
        """KeyboardInterrupt mid-training writes checkpoint_interrupted."""
        from vitiq.config import DataConfig, ExperimentConfig, TrainConfig
        from vitiq import runner as runner_mod

        cfg = ExperimentConfig(
            model=ModelConfig(arm="rawiq", num_classes=2, d_model=16, n_head=2,
                              n_layers=1, ffn_hidden=32, seq_length=64,
                              segment_size=16),
            data=DataConfig(source="synthetic",
                            synthetic_classes=("BPSK", "QPSK"),
                            synthetic_frames_per_class=64,
                            synthetic_frame_len=64),
            train=TrainConfig(batch_size=16, num_epochs=50, save_freq=100),
            experiment_name="rescue_test",
            checkpoint_dir=str(tmp_path / "ck"),
            log_dir=str(tmp_path / "logs"),
        )

        # interrupt after the 2nd epoch via the fit epoch loop's callback
        orig_fit = runner_mod.fit

        def interrupting_fit(*args, **kwargs):
            user_cb = kwargs["epoch_callback"]

            def cb(epoch, state, history):
                user_cb(epoch, state, history)
                if epoch >= 1:
                    raise KeyboardInterrupt

            kwargs["epoch_callback"] = cb
            return orig_fit(*args, **kwargs)

        monkeypatch.setattr(runner_mod, "fit", interrupting_fit)
        with pytest.raises(KeyboardInterrupt):
            runner_mod.run_training(cfg, verbose=False)
        exp_dir = tmp_path / "ck" / "rescue_test"
        assert (exp_dir / "checkpoint_interrupted.npz").exists()
        assert (exp_dir / "checkpoint_interrupted.json").exists()
        import json
        manifest = json.loads((exp_dir / "checkpoint_interrupted.json").read_text())
        assert manifest["epoch"] == 1


class TestOrbaxCheckpoint:
    def test_roundtrip(self, tmp_path):
        from vitiq.config import TrainConfig
        from vitiq.models import init_amc_params
        from vitiq.train.optim import create_train_state
        from vitiq.train.orbax_io import load_checkpoint_orbax, save_checkpoint_orbax

        cfg = ModelConfig(arm="rawiq", num_classes=2, d_model=16, n_head=2,
                          n_layers=1, ffn_hidden=32, seq_length=64, segment_size=16)
        state = create_train_state(init_amc_params(jax.random.PRNGKey(0), cfg),
                                   TrainConfig())
        save_checkpoint_orbax(tmp_path / "ck", state, epoch=3, val_loss=0.7,
                              history={"val_loss": [0.9, 0.7]})
        template = create_train_state(init_amc_params(jax.random.PRNGKey(5), cfg),
                                      TrainConfig())
        restored, manifest = load_checkpoint_orbax(tmp_path / "ck", template)
        assert manifest["epoch"] == 3
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestAttentionMaps:
    def test_per_layer_maps(self):
        from vitiq.models import init_amc_params
        from vitiq.models.amc import make_attention_map_fn

        cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=32, n_head=4,
                          n_layers=2, ffn_hidden=64, seq_length=64, segment_size=16)
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        maps = make_attention_map_fn(cfg)(params, jnp.zeros((2, 2, 64)))
        assert len(maps) == 2
        assert maps[0].shape == (2, 4, 5, 5)  # [B, H, L=4+cls, L]
        np.testing.assert_allclose(np.asarray(maps[0].sum(-1)), 1.0, atol=1e-5)


class TestCompileCache:
    """Placement: JAX_COMPILATION_CACHE_DIR when set (left to JAX), else the
    fixed <repo root>/.jax_cache."""

    @pytest.fixture(autouse=True)
    def _restore_config(self):
        names = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_compile_time_secs",
                 "jax_persistent_cache_min_entry_size_bytes")
        saved = {n: getattr(jax.config, n) for n in names}
        yield
        for n, v in saved.items():
            jax.config.update(n, v)

    def test_enables_and_creates_dir(self, tmp_path, monkeypatch):
        from vitiq.utils import compile_cache as cc

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(cc, "DEFAULT_DIR", tmp_path / "cc")
        cc.enable_persistent_compilation_cache()
        assert (tmp_path / "cc").is_dir()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")

    def test_default_is_fixed_repo_path(self, monkeypatch):
        from pathlib import Path

        from vitiq.utils import compile_cache as cc

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = Path(__file__).resolve().parents[1]
        assert cc.cache_dir() == str(repo / ".jax_cache")

    def test_env_dir_left_to_jax(self, tmp_path, monkeypatch):
        from vitiq.utils import compile_cache as cc

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        monkeypatch.setattr(cc, "DEFAULT_DIR", tmp_path / "default")
        before = jax.config.jax_compilation_cache_dir
        assert cc.cache_dir() is None
        cc.enable_persistent_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == before
        assert not (tmp_path / "default").exists()
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 1.0


class TestEvalConfigFallback:
    def test_embedded_checkpoint_config_used(self, tmp_path):
        """config.json missing -> run_evaluation falls back to the config
        embedded in the checkpoint manifest (reference evaluate.py behavior)."""
        from vitiq.config import DataConfig, ExperimentConfig, TrainConfig
        from vitiq.runner import run_evaluation, run_training

        cfg = ExperimentConfig(
            model=ModelConfig(arm="rawiq", num_classes=2, d_model=16, n_head=2,
                              n_layers=1, ffn_hidden=32, seq_length=64,
                              segment_size=16),
            data=DataConfig(source="synthetic",
                            synthetic_classes=("BPSK", "QPSK"),
                            synthetic_frames_per_class=64,
                            synthetic_frame_len=64),
            train=TrainConfig(batch_size=16, num_epochs=1),
            experiment_name="fb",
            checkpoint_dir=str(tmp_path / "ck"),
            log_dir=str(tmp_path / "logs"),
        )
        run_training(cfg, evaluate_test=False, verbose=False)
        exp_dir = tmp_path / "ck" / "fb"
        (exp_dir / "config.json").unlink()
        res = run_evaluation(str(exp_dir), dataset="test", verbose=False)
        assert 0.0 <= res["overall_accuracy"] <= 1.0


class TestCorruptResume:
    def test_resume_from_garbage_starts_fresh(self, tmp_path, capsys):
        """A corrupt/missing --resume checkpoint falls back to fresh training
        (ref: transformer_rawIQ/training/train.py:532-541)."""
        from vitiq.config import DataConfig, ExperimentConfig, TrainConfig
        from vitiq.runner import run_training

        (tmp_path / "bad.npz").write_bytes(b"not a checkpoint")
        cfg = ExperimentConfig(
            model=ModelConfig(arm="rawiq", num_classes=2, d_model=16, n_head=2,
                              n_layers=1, ffn_hidden=32, seq_length=64,
                              segment_size=16),
            data=DataConfig(source="synthetic",
                            synthetic_classes=("BPSK", "QPSK"),
                            synthetic_frames_per_class=48,
                            synthetic_frame_len=64),
            train=TrainConfig(batch_size=16, num_epochs=1),
            experiment_name="corrupt",
            checkpoint_dir=str(tmp_path / "ck"),
            log_dir=str(tmp_path / "logs"),
        )
        summary = run_training(cfg, resume=str(tmp_path / "bad"), verbose=False,
                               evaluate_test=False)
        assert summary["epochs_run"] == 1
        assert "could not resume" in capsys.readouterr().out


class TestFeatureKnob:
    def test_amp_phase_features_via_runner(self, tmp_path):
        from vitiq.config import DataConfig, ExperimentConfig, TrainConfig
        from vitiq.runner import run_training

        cfg = ExperimentConfig(
            model=ModelConfig(arm="rawiq", num_classes=2, d_model=16, n_head=2,
                              n_layers=1, ffn_hidden=32, seq_length=64,
                              segment_size=16),
            data=DataConfig(source="synthetic", features="amp_phase",
                            synthetic_classes=("BPSK", "16QAM"),
                            synthetic_frames_per_class=48,
                            synthetic_frame_len=64),
            train=TrainConfig(batch_size=16, num_epochs=1),
            experiment_name="ap",
            checkpoint_dir=str(tmp_path / "ck"),
            log_dir=str(tmp_path / "logs"),
        )
        s = run_training(cfg, verbose=False)
        assert s["epochs_run"] == 1

    def test_cli_flag_reaches_config(self):
        from vitiq.cli import build_parser, _config_from_args

        args = build_parser().parse_args(["train", "--arm", "rawiq",
                                          "--source", "synthetic",
                                          "--features", "amp_phase"])
        assert _config_from_args(args).data.features == "amp_phase"


class TestHeadToHead:
    def test_trains_both_arms_and_compares(self, tmp_path):
        from vitiq.config import DataConfig, ExperimentConfig, TrainConfig
        from vitiq.runner import run_head_to_head

        data = DataConfig(source="synthetic", synthetic_classes=("BPSK", "QPSK"),
                          synthetic_frames_per_class=48, synthetic_frame_len=128)
        vit = ExperimentConfig(
            model=ModelConfig(arm="vit", num_classes=2, d_model=16, n_head=2,
                              n_layers=1, ffn_hidden=32, img_size_h=16,
                              img_size_w=16, patch_size=8, seq_length=128),
            data=data,
            train=TrainConfig(batch_size=16, num_epochs=1),
            experiment_name="h2h_vit", checkpoint_dir=str(tmp_path / "ck"),
            log_dir=str(tmp_path / "logs"),
        )
        rawiq = ExperimentConfig(
            model=ModelConfig(arm="rawiq", num_classes=2, d_model=16, n_head=2,
                              n_layers=1, ffn_hidden=32, seq_length=128,
                              segment_size=32),
            data=data,
            train=TrainConfig(batch_size=16, num_epochs=1),
            experiment_name="h2h_rawiq", checkpoint_dir=str(tmp_path / "ck"),
            log_dir=str(tmp_path / "logs"),
        )
        res = run_head_to_head(vit, rawiq, comparison_dir=str(tmp_path / "cmp"),
                               verbose=False)
        assert "overall_improvement" in res["insights"]
        assert (tmp_path / "cmp" / "summary_comparison.csv").exists()
        assert (tmp_path / "cmp" / "overall_comparison.png").exists()
