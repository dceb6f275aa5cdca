"""AOT serving-artifact export/load (vitiq/serve.py).

The deployment story the reference lacks: its eval path rebuilds the model
from training code at load time (ViT/training/evaluate.py:42-87); vitiq
serializes the COMPILED serving program (jax.export) so a consumer runs it
without model code. These tests round-trip an artifact through disk and
hold the loaded program to exact agreement with the in-process forward.
"""
import json

import jax
import numpy as np
import pytest

from vitiq.config import ExperimentConfig
from vitiq.models import init_amc_params
from vitiq.serve import (
    ServingArtifact,
    build_serving_fn,
    export_from_experiment,
    export_serving,
)

STATS = {"i_mean": 0.1, "i_std": 1.2, "q_mean": -0.05, "q_std": 0.9}


def _tiny_cfg():
    cfg = ExperimentConfig.rawiq_synthetic19()
    cfg.model.n_layers = 2
    cfg.data.synthetic_frame_len = 256
    cfg.model.seq_length = 256
    return cfg


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = _tiny_cfg()
    params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
    out = export_serving(cfg, params, STATS,
                         tmp_path_factory.mktemp("art") / "serving",
                         batch_sizes=[8, 32])
    return cfg, params, out


def test_round_trip_exact(artifact):
    cfg, params, out = artifact
    art = ServingArtifact.load(out)
    x = np.random.default_rng(0).standard_normal(
        (32, cfg.data.frame_len, 2)).astype(np.float32)
    got = np.asarray(art.run(x))
    want = np.asarray(jax.jit(build_serving_fn(cfg, params, STATS))(x))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (32, cfg.model.num_classes)


def test_ragged_batch_pads_to_bucket_without_perturbation(artifact):
    cfg, params, out = artifact
    art = ServingArtifact.load(out)
    x = np.random.default_rng(1).standard_normal(
        (20, cfg.data.frame_len, 2)).astype(np.float32)
    got = np.asarray(art.run(x))  # 20 -> bucket 32, sliced back
    want = np.asarray(jax.jit(build_serving_fn(cfg, params, STATS))(x))
    np.testing.assert_array_equal(got, want)
    preds = art.predict(x)
    assert preds.shape == (20,)


def test_bucket_routing_and_errors(artifact):
    cfg, _, out = artifact
    art = ServingArtifact.load(out)
    assert art.batch_sizes == [8, 32]
    assert art._bucket(5) == 8 and art._bucket(8) == 8 and art._bucket(9) == 32
    with pytest.raises(ValueError, match="largest exported bucket"):
        art.run(np.zeros((33, cfg.data.frame_len, 2), np.float32))
    with pytest.raises(ValueError, match="raw I/Q frames"):
        art.run(np.zeros((4, 77, 2), np.float32))


def test_manifest_and_config_embedded(artifact):
    cfg, _, out = artifact
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["format"] == "vitiq-serving/2"
    assert manifest["arm"] == "rawiq"
    assert manifest["frame_len"] == cfg.data.frame_len
    art = ServingArtifact.load(out)
    assert art.config.model.n_layers == cfg.model.n_layers
    stats = json.loads((out / "stats.json").read_text())
    assert stats == STATS


def test_load_rejects_non_artifact(tmp_path):
    (tmp_path / "manifest.json").write_text(json.dumps({"format": "other/9"}))
    with pytest.raises(ValueError, match="not a vitiq serving artifact"):
        ServingArtifact.load(tmp_path)


def test_export_from_experiment_dir(tmp_path):
    """The CLI path: assemble from a training-run directory layout."""
    cfg = _tiny_cfg()
    params = init_amc_params(jax.random.PRNGKey(1), cfg.model)
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.json").write_text(cfg.to_json())
    (exp / "normalization_stats.json").write_text(json.dumps(STATS))
    from vitiq.train.checkpoint import save_params
    save_params(exp / "model_best.npz", params)
    out = export_from_experiment(exp, tmp_path / "art", batch_sizes=[4])
    art = ServingArtifact.load(out)
    x = np.random.default_rng(2).standard_normal(
        (4, cfg.data.frame_len, 2)).astype(np.float32)
    got = np.asarray(art.run(x))
    want = np.asarray(jax.jit(build_serving_fn(cfg, params, STATS))(x))
    np.testing.assert_array_equal(got, want)


def test_export_missing_explicit_checkpoint_raises(tmp_path):
    """An explicitly requested checkpoint that is absent must raise, not
    silently fall back to model_final.npz (which would bake different
    weights into the artifact); only the DEFAULT model_best.npz falls back
    (interrupted runs write only final weights)."""
    cfg = _tiny_cfg()
    params = init_amc_params(jax.random.PRNGKey(1), cfg.model)
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.json").write_text(cfg.to_json())
    (exp / "normalization_stats.json").write_text(json.dumps(STATS))
    from vitiq.train.checkpoint import save_params
    save_params(exp / "model_final.npz", params)
    with pytest.raises(FileNotFoundError, match="model_bets.npz"):
        export_from_experiment(exp, tmp_path / "art", batch_sizes=[4],
                               checkpoint="model_bets.npz")
    # the default falls back to model_final.npz when best is absent
    out = export_from_experiment(exp, tmp_path / "art2", batch_sizes=[4])
    assert (out / "manifest.json").exists()


@pytest.mark.parametrize("platforms", [None, ["cpu"], ["cpu", "cuda"]])
def test_manifest_records_lowered_platforms(tmp_path, platforms):
    cfg = _tiny_cfg()
    params = init_amc_params(jax.random.PRNGKey(1), cfg.model)
    out = export_serving(cfg, params, STATS, tmp_path / "art", batch_sizes=[4],
                         platforms=platforms)
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["platforms"] == (platforms or ["cpu"])


def test_cuda_export_carries_the_triton_kernel(tmp_path, monkeypatch):
    """Exported for CUDA, the bf16 serving program calls the Triton
    attention kernel through the one custom call export_serving
    acknowledges (jax.export refuses any it was not told of)."""
    from vitiq.serve import TRITON_CUSTOM_CALL

    cfg = _tiny_cfg()
    cfg.model.numerics = "tpu"
    params = init_amc_params(jax.random.PRNGKey(1), cfg.model)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")  # kernel route
    out = export_serving(cfg, params, STATS, tmp_path / "art", batch_sizes=[4],
                         platforms=["cuda"])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["platforms"] == ["cuda"]
    blob = (out / manifest["entries"]["4"]["file"]).read_bytes()
    assert TRITON_CUSTOM_CALL.encode() in blob
