"""Token embeddings and positional encoding.

The reference's strided Conv2d/Conv1d patchifiers are algebraically plain
GEMMs once the input is folded (space-to-depth). We implement them that way —
a reshape/transpose feeding one [B*N, fan_in] x [fan_in, d_model] matmul —
instead of translating the conv ops.

Reference behavior preserved:
  * 2D patchify: Conv2d(in_ch, d, kernel=p, stride=p) -> flatten -> transpose
    to (B, N, d)  (ref: ViT/models/embedding/patch_embedding.py:3-15)
  * 1D tokenizer: 'conv1d' = Conv1d(2, d, kernel=1) -> 1024 tokens;
    'segment' = Conv1d(2, d, kernel=s, stride=s) -> L/s tokens
    (ref: transformer_rawIQ/models/embedding/patch_embedding.py:5-60)
  * sinusoidal PE: encoding[p, 2i] = sin(p / 10000^(2i/d)),
    encoding[p, 2i+1] = cos(p / 10000^(2i/d)); added, no scaling
    (ref: ViT/models/embedding/positional_encoding.py:4-29; the rawIQ variant
    computes the same table via exp(-log(10000) * 2i / d),
    ref: transformer_rawIQ/models/embedding/positional_encoding.py:6-82)

Kernel flattening order matches torch Conv weight layout (out, in, k...) so a
reference checkpoint can be imported by transposing [d, in, p, p] ->
[(in*p*p), d] with (channel, kh, kw) row order.
"""

from __future__ import annotations

import jax.numpy as jnp

from vitiq.models.layers import linear_init, linear_apply
from vitiq.ops.numerics import Policy, REFERENCE


# --------------------------------------------------------------------------
# 2D patch embedding (ViT arm)
# --------------------------------------------------------------------------

def patch_embed_2d_init(rng, in_channels: int, patch_size: int, d_model: int):
    # torch Conv2d default init bounds use fan_in = in_ch * k * k
    return {"proj": linear_init(rng, in_channels * patch_size * patch_size, d_model)}


def fold_patches_2d(x: jnp.ndarray, patch_size: int) -> jnp.ndarray:
    """[B, C, H, W] -> [B, N, C*p*p] with (C, ph, pw) feature order.

    This is the exact input-window flattening a stride-p Conv2d performs, so
    `fold @ kernel` == Conv2d(kernel=p, stride=p).
    """
    B, C, H, W = x.shape
    p = patch_size
    x = x.reshape(B, C, H // p, p, W // p, p)
    # -> [B, H/p, W/p, C, p, p]
    x = x.transpose(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


def patch_embed_2d_apply(params, x, patch_size: int, policy: Policy = REFERENCE):
    """[B, C, H, W] -> [B, N, d_model]."""
    return linear_apply(params["proj"], fold_patches_2d(x, patch_size), policy)


# --------------------------------------------------------------------------
# 1D sequence embedding (raw-IQ arm)
# --------------------------------------------------------------------------

def sequence_embed_init(rng, in_channels: int, d_model: int, method: str,
                        segment_size: int | None = None):
    if method == "conv1d":
        fan_in = in_channels
    elif method == "segment":
        if segment_size is None:
            raise ValueError("segment_size is required for 'segment' method")
        fan_in = in_channels * segment_size
    else:
        raise ValueError(f"Unknown method: {method}. Use 'conv1d' or 'segment'")
    return {"proj": linear_init(rng, fan_in, d_model)}


def fold_segments_1d(x: jnp.ndarray, segment_size: int) -> jnp.ndarray:
    """[B, C, L] -> [B, L/s, C*s] with (C, k) feature order (== Conv1d windows)."""
    B, C, L = x.shape
    s = segment_size
    x = x.reshape(B, C, L // s, s)
    x = x.transpose(0, 2, 1, 3)  # [B, T, C, s]
    return x.reshape(B, L // s, C * s)


def sequence_embed_apply(params, x, method: str, segment_size: int | None,
                         policy: Policy = REFERENCE):
    """[B, C, L] -> [B, T, d_model] (T = L for conv1d, L/s for segment)."""
    if method == "conv1d":
        tokens = x.transpose(0, 2, 1)  # pointwise conv == per-sample dense
    else:
        tokens = fold_segments_1d(x, segment_size)
    return linear_apply(params["proj"], tokens, policy)


# --------------------------------------------------------------------------
# sinusoidal positional encoding
# --------------------------------------------------------------------------

def sinusoidal_encoding(max_len: int, d_model: int, dtype=jnp.float32) -> jnp.ndarray:
    """[max_len, d_model] table; computed at trace time and constant-folded by
    XLA, so no buffer parameter is stored (unlike the reference's
    register_buffer)."""
    pos = jnp.arange(max_len, dtype=jnp.float32)[:, None]
    two_i = jnp.arange(0, d_model, 2, dtype=jnp.float32)
    denominator = jnp.power(10000.0, two_i / d_model)
    angles = pos / denominator  # [max_len, d_model//2]
    # interleave: even columns sin, odd columns cos
    enc = jnp.stack([jnp.sin(angles), jnp.cos(angles)], axis=-1).reshape(max_len, -1)
    return enc[:, :d_model].astype(dtype)


def add_positional_encoding(x: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """x: [B, L, D]; adds enc[:L] broadcast over batch. Mirrors the rawIQ
    variant's bounds check (positional_encoding.py:64-69) — the ViT variant
    would silently mis-broadcast instead."""
    B, L, D = x.shape
    if L > max_len:
        raise ValueError(f"sequence length {L} exceeds positional-encoding max_len {max_len}")
    return x + sinusoidal_encoding(max_len, D, x.dtype)[:L]
