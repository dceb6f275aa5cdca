"""Shared CLS-token transformer encoder.

One implementation serves both arms (the reference keeps two byte-identical
copies, SURVEY.md §2.2); the arm only chooses the tokenizer and whether a CLS
token is prepended.

Pipeline (ref: ViT/models/encoder.py:34-53, transformer_rawIQ/models/encoder.py:86-117):
  tokens = embed(src)
  x = concat([cls, tokens]) if cls else tokens
  x = x + PE[:L]; x = dropout(x)
  for layer in layers: x = EncoderLayer(x, mask)
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitiq.config import ModelConfig
from vitiq.models import embeddings as emb
from vitiq.models.layers import dropout, encoder_layer_apply, encoder_layer_init
from vitiq.ops.attention import scaled_dot_product_attention
from vitiq.ops.numerics import Policy


def encoder_init(rng, cfg: ModelConfig):
    rngs = jax.random.split(rng, cfg.n_layers + 2)
    if cfg.arm == "vit":
        embed = emb.patch_embed_2d_init(rngs[0], cfg.in_channels, cfg.patch_size, cfg.d_model)
    else:
        embed = emb.sequence_embed_init(
            rngs[0], cfg.in_channels, cfg.d_model, cfg.embedding_type, cfg.segment_size
        )
    params = {
        "embedding": embed,
        "layers": [
            encoder_layer_init(rngs[2 + i], cfg.d_model, cfg.ffn_hidden)
            for i in range(cfg.n_layers)
        ],
    }
    # ViT arm always has a CLS token; rawIQ arm's is optional
    # (ref: ViT/models/encoder.py:24 cls_token = Parameter(randn(1,1,d)))
    if cfg.arm == "vit" or cfg.use_cls_token:
        params["cls_token"] = jax.random.normal(rngs[1], (1, 1, cfg.d_model), jnp.float32)
    return params


def encoder_apply(
    params,
    src: jnp.ndarray,
    cfg: ModelConfig,
    policy: Policy,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    mask=None,
    attention_fn=scaled_dot_product_attention,
    raw_stats=None,
):
    """Returns the full token sequence [B, L, d_model].

    raw_stats: when given (the i/q mean/std dict), `src` is the RAW
    [B, L, 2] frame batch and preprocess + embed + CLS + PE run as ONE
    fused GEMM (vitiq/models/raw_embed.py) — no image/segment fold, no
    padded small-minor-dim intermediates, no fold recompute in the
    backward."""
    if raw_stats is not None:
        from vitiq.models.raw_embed import fused_raw_embed_apply

        x = fused_raw_embed_apply(params, src, cfg, raw_stats, policy)
    else:
        expected_rank = 4 if cfg.arm == "vit" else 3
        if src.ndim != expected_rank:
            raise ValueError(
                f"{cfg.arm} arm expects rank-{expected_rank} input "
                f"({'[B, C, H, W]' if cfg.arm == 'vit' else '[B, C, L]'}), "
                f"got shape {src.shape}"
            )
        if cfg.arm == "vit":
            x = emb.patch_embed_2d_apply(params["embedding"], src, cfg.patch_size, policy)
        else:
            x = emb.sequence_embed_apply(
                params["embedding"], src, cfg.embedding_type, cfg.segment_size, policy
            )
        if "cls_token" in params:
            cls = jnp.broadcast_to(params["cls_token"].astype(x.dtype), (x.shape[0], 1, x.shape[2]))
            x = jnp.concatenate([cls, x], axis=1)

        # PE table sized exactly to the token count, as the reference computes
        # max_len = num_patches + 1 (ViT/models/encoder.py:21-23)
        x = emb.add_positional_encoding(x, cfg.num_tokens)

    if train and rng is not None:
        rngs = jax.random.split(rng, cfg.n_layers + 1)
        x = dropout(x, cfg.drop_prob, rngs[0], train)
        layer_rngs = list(rngs[1:])
    else:
        x = dropout(x, cfg.drop_prob, None, train)
        layer_rngs = [None] * cfg.n_layers

    for layer_params, layer_rng in zip(params["layers"], layer_rngs):
        x = encoder_layer_apply(
            layer_params, x, cfg.n_head, cfg.drop_prob, layer_rng, train,
            mask=mask, policy=policy, attention_fn=attention_fn)
    return x
