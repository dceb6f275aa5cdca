"""Torch-checkpoint import: key mapping, layout conversion, and forward
equivalence of the imported tree (conv-vs-fold equivalence itself is proven
against torch.nn.functional in tests/test_layers.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitiq.config import ModelConfig
from vitiq.interop import load_torch_state_dict
from vitiq.models import init_amc_params, make_forward


def synth_state_dict(cfg: ModelConfig, rng):
    """A reference-shaped state_dict of random arrays (keys/shapes exactly as
    the reference modules register them)."""
    d, h = cfg.d_model, cfg.ffn_hidden
    sd = {}
    if cfg.arm == "vit":
        p = cfg.patch_size
        sd["encoder.patch_embedding.projection.weight"] = rng.standard_normal(
            (d, cfg.in_channels, p, p)).astype(np.float32)
        sd["encoder.patch_embedding.projection.bias"] = rng.standard_normal(d).astype(np.float32)
        sd["encoder.cls_token"] = rng.standard_normal((1, 1, d)).astype(np.float32)
    else:
        # key names as the real reference modules register them (verified by
        # tests/test_reference_golden.py against an actual state_dict):
        # the rawIQ Encoder attribute is `sequence_embedding`
        # (ref: transformer_rawIQ/models/encoder.py:37,50)
        s = cfg.segment_size if cfg.embedding_type == "segment" else 1
        sd["encoder.sequence_embedding.projection.weight"] = rng.standard_normal(
            (d, 2, s)).astype(np.float32)
        sd["encoder.sequence_embedding.projection.bias"] = rng.standard_normal(d).astype(np.float32)
        if cfg.use_cls_token:
            sd["encoder.cls_token"] = rng.standard_normal((1, 1, d)).astype(np.float32)
    for i in range(cfg.n_layers):
        pfx = f"encoder.layers.{i}"
        for name in ("w_q", "w_k", "w_v", "w_concat"):
            sd[f"{pfx}.attention.{name}.weight"] = rng.standard_normal((d, d)).astype(np.float32)
            sd[f"{pfx}.attention.{name}.bias"] = rng.standard_normal(d).astype(np.float32)
        for n in ("norm1", "norm2"):
            sd[f"{pfx}.{n}.gamma"] = np.ones(d, np.float32)
            sd[f"{pfx}.{n}.beta"] = np.zeros(d, np.float32)
        sd[f"{pfx}.ffn.linear1.weight"] = rng.standard_normal((h, d)).astype(np.float32)
        sd[f"{pfx}.ffn.linear1.bias"] = rng.standard_normal(h).astype(np.float32)
        sd[f"{pfx}.ffn.linear2.weight"] = rng.standard_normal((d, h)).astype(np.float32)
        sd[f"{pfx}.ffn.linear2.bias"] = rng.standard_normal(d).astype(np.float32)
    if cfg.arm == "vit":
        sd["mlp_head.weight"] = rng.standard_normal((cfg.num_classes, d)).astype(np.float32)
        sd["mlp_head.bias"] = rng.standard_normal(cfg.num_classes).astype(np.float32)
    else:
        # the head LayerNorm is torch nn.LayerNorm -> weight/bias keys
        sd["mlp_head.0.weight"] = np.ones(d, np.float32)
        sd["mlp_head.0.bias"] = np.zeros(d, np.float32)
        sd["mlp_head.1.weight"] = rng.standard_normal((cfg.num_classes, d)).astype(np.float32)
        sd["mlp_head.1.bias"] = rng.standard_normal(cfg.num_classes).astype(np.float32)
    return sd


@pytest.mark.parametrize("arm", ["vit", "rawiq"])
def test_import_matches_native_structure(arm):
    if arm == "vit":
        cfg = ModelConfig(arm="vit", num_classes=5, d_model=32, n_head=4,
                          n_layers=2, ffn_hidden=64, patch_size=4)
    else:
        cfg = ModelConfig(arm="rawiq", num_classes=5, d_model=32, n_head=4,
                          n_layers=2, ffn_hidden=64, seq_length=128, segment_size=16)
    sd = synth_state_dict(cfg, np.random.default_rng(0))
    imported = load_torch_state_dict(sd, cfg)
    native = init_amc_params(jax.random.PRNGKey(0), cfg)
    assert (jax.tree_util.tree_structure(imported)
            == jax.tree_util.tree_structure(native))
    for a, b in zip(jax.tree_util.tree_leaves(imported),
                    jax.tree_util.tree_leaves(native)):
        assert a.shape == b.shape


def test_imported_weights_produce_expected_linear_math():
    """Head linear: logits = feat @ W.T + b in torch == feat @ kernel + bias."""
    cfg = ModelConfig(arm="vit", num_classes=3, d_model=16, n_head=2,
                      n_layers=1, ffn_hidden=32, patch_size=4)
    sd = synth_state_dict(cfg, np.random.default_rng(1))
    params = load_torch_state_dict(sd, cfg)
    np.testing.assert_allclose(
        np.asarray(params["mlp_head"]["kernel"]), sd["mlp_head.weight"].T)
    x = jnp.zeros((2, 1, 32, 64))
    logits = make_forward(cfg)(params, x)
    assert logits.shape == (2, 3)
    assert np.isfinite(np.asarray(logits)).all()


def test_missing_key_fails_loudly():
    cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=16, n_head=2,
                      n_layers=1, ffn_hidden=32, seq_length=64, segment_size=16)
    sd = synth_state_dict(cfg, np.random.default_rng(2))
    del sd["encoder.layers.0.ffn.linear1.bias"]
    with pytest.raises(KeyError):
        load_torch_state_dict(sd, cfg)


def test_torch_tensor_inputs():
    torch = pytest.importorskip("torch")
    cfg = ModelConfig(arm="vit", num_classes=3, d_model=16, n_head=2,
                      n_layers=1, ffn_hidden=32, patch_size=4)
    sd = {k: torch.from_numpy(v) for k, v in
          synth_state_dict(cfg, np.random.default_rng(3)).items()}
    params = load_torch_state_dict(sd, cfg)
    logits = make_forward(cfg)(params, jnp.zeros((1, 1, 32, 64)))
    assert logits.shape == (1, 3)


@pytest.mark.parametrize("wrapped", [True, False],
                         ids=["training_checkpoint", "bare_state_dict"])
def test_load_torch_checkpoint_file(tmp_path, wrapped):
    """A .pth on disk, as the reference's training checkpoint dict or a bare
    state_dict, imports to the same tree as load_torch_state_dict."""
    torch = pytest.importorskip("torch")
    from vitiq.interop import load_torch_checkpoint

    cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=16, n_head=2,
                      n_layers=1, ffn_hidden=32, seq_length=64,
                      segment_size=16)
    sd = {k: torch.from_numpy(v) for k, v in
          synth_state_dict(cfg, np.random.default_rng(4)).items()}
    path = tmp_path / "model.pth"
    torch.save({"model_state_dict": sd, "epoch": 3} if wrapped else sd, path)
    got = load_torch_checkpoint(str(path), cfg)
    want = load_torch_state_dict(sd, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
