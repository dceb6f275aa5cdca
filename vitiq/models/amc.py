"""AMC classifier heads for both arms, over the shared encoder.

* ViT arm: take token 0 (CLS), Linear(d_model, num_classes) — NO pre-head
  LayerNorm (ref: ViT/models/amc_transformer.py:24-30).
* raw-IQ arm: CLS token or mean-pool over tokens, then
  LayerNorm(d_model) -> Linear(d_model, num_classes) — the rawIQ head DOES
  have a pre-head LayerNorm (ref: transformer_rawIQ/models/transformer_rawIQ.py:67-96).

`make_forward(cfg)` returns a pure function `(params, src, train, rng) -> logits`
that closes over the static config, so it jits cleanly and the same callable is
reused for train/eval/bench.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from vitiq.config import ModelConfig
from vitiq.models.encoder import encoder_apply, encoder_init
from vitiq.models.layers import layer_norm_apply, layer_norm_init, linear_apply, linear_init
from vitiq.ops.attention import scaled_dot_product_attention
from vitiq.ops.numerics import policy_for


def init_amc_params(rng, cfg: ModelConfig):
    cfg.validate()
    r_enc, r_head, r_ln = jax.random.split(rng, 3)
    params = {
        "encoder": encoder_init(r_enc, cfg),
        "mlp_head": linear_init(r_head, cfg.d_model, cfg.num_classes),
    }
    if cfg.arm == "rawiq":
        params["head_norm"] = layer_norm_init(cfg.d_model)
    return params


def make_forward(cfg: ModelConfig, attention_fn: Optional[Callable] = None,
                 raw_stats=None):
    """Build the jittable forward pass for `cfg`.

    Returns fn(params, src, train=False, rng=None) -> logits [B, num_classes].
    src is [B, 1, 32, 64] for the ViT arm, [B, 2, seq_length] for rawIQ —
    or the RAW [B, seq_length, 2] frame batch when `raw_stats` (the i/q
    mean/std dict) is given: preprocessing then fuses into the embedding
    GEMM (vitiq/models/raw_embed.py) and no separate preprocess step is
    needed.
    """
    cfg.validate()
    policy = policy_for(cfg.numerics)
    if attention_fn is None:
        if cfg.numerics == "tpu":
            # the fused Triton attention on the GPU; plain XLA elsewhere
            from vitiq.ops.pallas.flash_attention import fused_attention
            attention_fn = fused_attention
        else:
            attention_fn = scaled_dot_product_attention

    def forward(params, src, train: bool = False, rng=None):
        x = encoder_apply(
            params["encoder"], src, cfg, policy, train=train, rng=rng,
            attention_fn=attention_fn, raw_stats=raw_stats,
        )
        if cfg.arm == "vit":
            feat = x[:, 0]
        else:
            if cfg.use_cls_token:
                feat = x[:, 0]
            else:
                feat = jnp.mean(x, axis=1)  # transformer_rawIQ.py:92-93
            # the rawIQ head norm is a torch nn.LayerNorm (default eps=1e-5),
            # unlike the encoder's custom eps=1e-12 LN
            # (ref: transformer_rawIQ/models/transformer_rawIQ.py:68)
            feat = layer_norm_apply(params["head_norm"], feat, eps=1e-5)
        logits = linear_apply(params["mlp_head"], feat, policy)
        return logits.astype(jnp.float32)

    return forward


def make_feature_extractor(cfg: ModelConfig, attention_fn: Optional[Callable] = None):
    """Encoder-output access helpers, parity with the rawIQ encoder's
    `get_cls_token_output` / `get_sequence_output`
    (ref: transformer_rawIQ/models/encoder.py:119-153).

    Returns fn(params, src) -> {"sequence_output": [B, L, d],
    "cls_output": [B, d] or None}.
    """
    cfg.validate()
    policy = policy_for(cfg.numerics)
    if attention_fn is None:
        attention_fn = scaled_dot_product_attention

    def extract(params, src):
        x = encoder_apply(params["encoder"], src, cfg, policy, train=False,
                          attention_fn=attention_fn)
        has_cls = cfg.arm == "vit" or cfg.use_cls_token
        return {
            "sequence_output": x[:, 1:] if has_cls else x,
            "cls_output": x[:, 0] if has_cls else None,
        }

    return extract


def count_parameters(params) -> int:
    """Total trainable parameter count (utility parity with
    ref: ViT/training/utils.py:469-483)."""
    return sum(int(x.size) for x in jax.tree_util.tree_leaves(params))


def make_attention_map_fn(cfg: ModelConfig):
    """Per-layer post-softmax attention maps — implements the reference's
    unfinished visualization TODO (ref: ViT/models/layers/
    multi_head_attention.py:30-31 "we should implement visualization").

    Returns fn(params, src) -> list of n_layers arrays [B, H, L, L].
    """
    cfg.validate()
    policy = policy_for(cfg.numerics)

    def extract(params, src):
        maps = []

        def capturing_attention(q, k, v, mask=None, policy=policy,
                                return_scores=False):
            out, scores = scaled_dot_product_attention(
                q, k, v, mask=mask, policy=policy, return_scores=True
            )
            maps.append(scores)
            return out

        encoder_apply(params["encoder"], src, cfg, policy, train=False,
                      attention_fn=capturing_attention)
        return maps

    return extract
