"""Shared transformer core — implemented ONCE.

The reference keeps byte-identical copies of these layers in both arm trees
(SURVEY.md §2.2); here they are pure functions over parameter pytrees, traced
once under ``jit`` and fused by XLA.

Exact reference numerics preserved (for the 'reference' policy):
  * LayerNorm: biased variance (unbiased=False), eps=1e-12, affine gamma/beta
    (ref: ViT/models/layers/layers_norm.py:4-19)
  * MultiHeadAttention: four Linear(d_model, d_model) projections WITH bias,
    head split via reshape+transpose, -10000 mask fill, no attention dropout
    (ref: ViT/models/layers/multi_head_attention.py:6-47)
  * PositionwiseFeedForward: Linear -> ReLU -> Dropout -> Linear. ReLU, not
    GELU — the reference READMEs claim GELU but the code is ReLU; code wins
    (ref: ViT/models/layers/position_wise_feed_forward.py:3-17)
  * EncoderLayer: POST-norm with dropout before the residual add:
    x = norm1(dropout(attn(x)) + x); x = norm2(dropout(ffn(x)) + x)
    (ref: ViT/models/blocks/encoder_layer.py:7-35)

Parameter initialization follows torch.nn.Linear/Conv defaults
(kaiming-uniform == U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for both kernel and
bias) so training dynamics are comparable to the reference.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitiq.ops.attention import scaled_dot_product_attention
from vitiq.ops.numerics import Policy, REFERENCE

LN_EPS = 1e-12  # reference LayerNorm eps (layers_norm.py:5)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def linear_init(rng, fan_in: int, fan_out: int, dtype=jnp.float32):
    """torch.nn.Linear default init: kernel and bias ~ U(-1/sqrt(fan_in), +)."""
    k_rng, b_rng = jax.random.split(rng)
    bound = 1.0 / jnp.sqrt(jnp.asarray(fan_in, jnp.float32))
    return {
        # stored (fan_in, fan_out) so application is x @ kernel + bias
        "kernel": jax.random.uniform(k_rng, (fan_in, fan_out), dtype, -bound, bound),
        "bias": jax.random.uniform(b_rng, (fan_out,), dtype, -bound, bound),
    }


def linear_apply(params, x, policy: Policy = REFERENCE):
    return policy.cast_output(policy.dot(x, params["kernel"]) + params["bias"])


def layer_norm_init(d_model: int, dtype=jnp.float32):
    return {"gamma": jnp.ones((d_model,), dtype), "beta": jnp.zeros((d_model,), dtype)}


def layer_norm_apply(params, x, eps: float = LN_EPS, out_dtype=None):
    """Biased-variance LayerNorm with eps=1e-12; statistics always in f32.

    `out_dtype` controls the residual-stream dtype: f32 by default (reference
    parity), bf16 under the bf16 policy so the activation stream stays
    half-width in device memory.
    """
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)  # unbiased=False
    out = (x32 - mean) / jnp.sqrt(var + eps)
    out = params["gamma"] * out + params["beta"]
    return out if out_dtype is None else out.astype(out_dtype)


def dropout(x, rate: float, rng: Optional[jax.Array], train: bool):
    """Inverted dropout; identity when not training (torch eval semantics)."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout requires an rng key when train=True and rate > 0")
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, shape=x.shape)
    return jnp.where(mask, x / keep, jnp.zeros_like(x))


# --------------------------------------------------------------------------
# multi-head attention
# --------------------------------------------------------------------------

def mha_init(rng, d_model: int):
    rngs = jax.random.split(rng, 4)
    return {
        "w_q": linear_init(rngs[0], d_model, d_model),
        "w_k": linear_init(rngs[1], d_model, d_model),
        "w_v": linear_init(rngs[2], d_model, d_model),
        "w_concat": linear_init(rngs[3], d_model, d_model),
    }


def mha_apply(params, x, n_head: int, mask=None, policy: Policy = REFERENCE,
              attention_fn=scaled_dot_product_attention):
    """Self-attention (q = k = v = x, as the encoder always calls it).

    ``attention_fn`` lets the model swap in the fused Triton kernel.
    """
    B, L, D = x.shape
    d_head = D // n_head
    # fused QKV projection: one [D, 3D] GEMM reads x once instead of three
    # times (this model is memory-bandwidth-bound at d_model=128). The weight
    # concat is over constant params, folded at compile time; numerics are
    # identical to three separate GEMMs.
    w_qkv = jnp.concatenate(
        [params["w_q"]["kernel"], params["w_k"]["kernel"], params["w_v"]["kernel"]],
        axis=1,
    )
    b_qkv = jnp.concatenate(
        [params["w_q"]["bias"], params["w_k"]["bias"], params["w_v"]["bias"]]
    )
    qkv = policy.cast_output(policy.dot(x, w_qkv) + b_qkv)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    if getattr(attention_fn, "packed_layout", False):
        # the fused kernel takes heads packed in the model dim ([B, L, D]
        # stays compact in device memory; each program reads one head)
        out = attention_fn(q, k, v, n_head, mask=mask, policy=policy)
    else:
        # split heads: [B, L, D] -> [B, H, L, Dh]  (multi_head_attention.py:34-40)
        split = lambda t: t.reshape(B, L, n_head, d_head).transpose(0, 2, 1, 3)
        out = attention_fn(split(q), split(k), split(v), mask=mask, policy=policy)
        # concat heads: [B, H, L, Dh] -> [B, L, D]  (multi_head_attention.py:41-47)
        out = out.transpose(0, 2, 1, 3).reshape(B, L, D)
    return linear_apply(params["w_concat"], out, policy)


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------

def ffn_init(rng, d_model: int, hidden: int):
    r1, r2 = jax.random.split(rng)
    return {
        "linear1": linear_init(r1, d_model, hidden),
        "linear2": linear_init(r2, hidden, d_model),
    }


def ffn_apply(params, x, drop_prob: float, rng, train: bool, policy: Policy = REFERENCE):
    h = linear_apply(params["linear1"], x, policy)
    h = jnp.maximum(h, 0.0)  # ReLU (position_wise_feed_forward.py:14)
    h = dropout(h, drop_prob, rng, train)
    return linear_apply(params["linear2"], h, policy)


# --------------------------------------------------------------------------
# encoder layer (post-norm)
# --------------------------------------------------------------------------

def encoder_layer_init(rng, d_model: int, ffn_hidden: int):
    r_attn, r_ffn = jax.random.split(rng)
    return {
        "attention": mha_init(r_attn, d_model),
        "norm1": layer_norm_init(d_model),
        "ffn": ffn_init(r_ffn, d_model, ffn_hidden),
        "norm2": layer_norm_init(d_model),
    }


def encoder_layer_apply(params, x, n_head: int, drop_prob: float, rng, train: bool,
                        mask=None, policy: Policy = REFERENCE,
                        attention_fn=scaled_dot_product_attention):
    if train and rng is not None:
        r_attn, r_ffn_inner, r_ffn_out = jax.random.split(rng, 3)
    else:
        r_attn = r_ffn_inner = r_ffn_out = None
    # residual stream dtype: f32 for reference parity, compute dtype (bf16)
    # under the bf16 policy — halves the memory traffic of every residual/LN pass
    stream_dtype = None if policy.compute_dtype == jnp.float32 else policy.compute_dtype
    # 1-2. self-attention, dropout BEFORE the residual add, then post-norm
    attn = mha_apply(params["attention"], x, n_head, mask=mask, policy=policy,
                     attention_fn=attention_fn)
    x = layer_norm_apply(params["norm1"], dropout(attn, drop_prob, r_attn, train) + x,
                         out_dtype=stream_dtype)
    # 3-4. FFN (dropout inside, between ReLU and linear2), then post-norm
    ffn = ffn_apply(params["ffn"], x, drop_prob, r_ffn_inner, train, policy=policy)
    x = layer_norm_apply(params["norm2"], dropout(ffn, drop_prob, r_ffn_out, train) + x,
                         out_dtype=stream_dtype)
    return x
