"""Fused raw-frame embedding (vitiq/models/raw_embed.py) parity vs the
unfused preprocess -> fold -> embed -> CLS -> PE chain, per arm/geometry.

The fused path must be numerically equivalent (f32 REFERENCE policy; the
GEMM refactor reassociates the z-score so exact bit-equality is not
expected — 1e-4 absolute is ~100x the observed f32 drift) and its
gradients must match the unfused chain's for every live parameter."""

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import pytest

from vitiq.bench import (
    flagship_conv1d_config,
    flagship_rawiq_config,
    flagship_vit_config,
    rawiq_seg64_mp_config,
    vit_tiny_2016_config,
)
from vitiq.dsp import preprocess_batch_rawiq, preprocess_batch_vit
from vitiq.models import embeddings as emb
from vitiq.models import init_amc_params, make_forward
from vitiq.models.raw_embed import fused_raw_embed_apply, fused_raw_embed_supported
from vitiq.ops.numerics import policy_for

STATS = {"i_mean": 0.11, "i_std": 1.7, "q_mean": -0.23, "q_std": 0.9}

CONFIGS = {
    "vit_flagship": flagship_vit_config,
    "vit_tiny": vit_tiny_2016_config,
    "seg16_cls": flagship_rawiq_config,
    "seg64_mp": rawiq_seg64_mp_config,
    "conv1d": flagship_conv1d_config,
}


def _unfused_tokens(enc_params, x, cfg, policy):
    """The reference front-end chain the fused GEMM replaces."""
    if cfg.arm == "vit":
        src = preprocess_batch_vit(x, STATS, H=cfg.img_size_h, W=cfg.img_size_w)
        t = emb.patch_embed_2d_apply(enc_params["embedding"], src,
                                     cfg.patch_size, policy)
    else:
        src = preprocess_batch_rawiq(x, STATS)
        t = emb.sequence_embed_apply(enc_params["embedding"], src,
                                     cfg.embedding_type, cfg.segment_size,
                                     policy)
    if "cls_token" in enc_params:
        cls = jnp.broadcast_to(enc_params["cls_token"].astype(t.dtype),
                               (t.shape[0], 1, t.shape[2]))
        t = jnp.concatenate([cls, t], axis=1)
    return emb.add_positional_encoding(t, cfg.num_tokens)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_matches_unfused_chain(name):
    cfg = CONFIGS[name]("reference")
    assert fused_raw_embed_supported(cfg)
    policy = policy_for(cfg.numerics)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)["encoder"]
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (3, cfg.seq_length, 2)), jnp.float32) * 2.0 + 0.3
    want = _unfused_tokens(params, x, cfg, policy)
    got = fused_raw_embed_apply(params, x, cfg, STATS, policy)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["vit_tiny", "seg64_mp", "conv1d"])
def test_fused_gradients_match(name):
    cfg = CONFIGS[name]("reference")
    policy = policy_for(cfg.numerics)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)["encoder"]
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, cfg.seq_length, 2)), jnp.float32)
    # weight the token sum so every token position has a distinct cotangent
    wvec = jnp.linspace(0.5, 1.5, cfg.num_tokens if cfg.arm == "vit"
                        or cfg.use_cls_token else cfg.seq_length //
                        (cfg.segment_size or 1))

    def loss_fused(p):
        t = fused_raw_embed_apply(p, x, cfg, STATS, policy)
        return jnp.sum(t * wvec[: t.shape[1], None] * jnp.sin(t))

    def loss_unfused(p):
        t = _unfused_tokens(p, x, cfg, policy)
        return jnp.sum(t * wvec[: t.shape[1], None] * jnp.sin(t))

    gf = jax.grad(loss_fused)(params)
    gu = jax.grad(loss_unfused)(params)
    flat_f, _ = ravel_pytree(
        {k: gf[k] for k in ("embedding", "cls_token") if k in gf})
    flat_u, _ = ravel_pytree(
        {k: gu[k] for k in ("embedding", "cls_token") if k in gu})
    np.testing.assert_allclose(np.asarray(flat_f), np.asarray(flat_u),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", ["vit_tiny", "seg64_mp"])
def test_make_forward_raw_stats_end_to_end(name):
    cfg = CONFIGS[name]("reference")
    params = init_amc_params(jax.random.PRNGKey(3), cfg)
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (4, cfg.seq_length, 2)), jnp.float32)
    fwd_raw = make_forward(cfg, raw_stats=STATS)
    fwd = make_forward(cfg)
    if cfg.arm == "vit":
        src = preprocess_batch_vit(x, STATS, H=cfg.img_size_h, W=cfg.img_size_w)
    else:
        src = preprocess_batch_rawiq(x, STATS)
    np.testing.assert_allclose(
        np.asarray(fwd_raw(params, x)), np.asarray(fwd(params, src)),
        atol=5e-4, rtol=1e-4)


def test_supported_gating():
    cfg = flagship_vit_config("reference")
    assert fused_raw_embed_supported(cfg)
    # a vit geometry whose image is NOT the channel-major frame concat
    from dataclasses import replace

    bad = replace(cfg, img_size_h=16, img_size_w=16)  # 256 != 2*1024
    assert not fused_raw_embed_supported(bad)


def test_enabled_gating_per_arm(monkeypatch):
    """On for the contiguous rawiq folds under the bf16 policy at every
    size; for the vit arm only while the block-sparse expansion is small
    ((N+1)*D <= 2048); never under the f32 reference policy."""
    from dataclasses import replace

    from vitiq.models.raw_embed import fused_raw_embed_enabled

    assert fused_raw_embed_enabled(rawiq_seg64_mp_config("tpu"))
    assert fused_raw_embed_enabled(flagship_conv1d_config("tpu"))
    assert fused_raw_embed_enabled(vit_tiny_2016_config("tpu"))  # 17*64=1088
    assert not fused_raw_embed_enabled(flagship_vit_config("tpu"))  # 18560
    assert not fused_raw_embed_enabled(rawiq_seg64_mp_config("reference"))
    assert not fused_raw_embed_enabled(vit_tiny_2016_config("reference"))
    # an unsupported fold stays off even under bf16
    assert not fused_raw_embed_enabled(
        replace(vit_tiny_2016_config("tpu"), img_size_h=8, img_size_w=8))
