"""Scaled dot-product attention.

Reference semantics (ref: ViT/models/layers/scale_dot_product_attention.py:5-39):
``score = q @ k^T / sqrt(d_head)``; optional mask fills masked positions with
-10000 (NOT -inf); softmax over the last axis; no attention dropout. The
reference returns the score matrix for visualization and immediately discards
it (ref: ViT/models/layers/multi_head_attention.py:30-31); we expose it behind
``return_scores`` instead of always materializing it.

Two execution paths:

* XLA path (below): einsum + softmax, f32 accumulation — the reference
  semantics, the f32 preset's path and the CPU path.
* Triton path (vitiq.ops.pallas.flash_attention): one fused kernel per
  (batch row, head, query block) — no [B,H,L,L] score tensor ever reaches
  device memory. The bf16 preset's path on the GPU.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from vitiq.ops.numerics import Policy, REFERENCE

MASK_FILL_VALUE = -10000.0  # reference uses -10000, not -inf


def scaled_dot_product_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    policy: Policy = REFERENCE,
    return_scores: bool = False,
):
    """Attention over [B, H, L, Dh] tensors.

    Args:
      q, k, v: [batch, heads, length, d_head]
      mask: optional broadcastable mask; positions where ``mask == 0`` are
        filled with -10000 before the softmax.
      policy: numerics policy (bf16 compute / f32 softmax under the bf16 preset).
      return_scores: also return the post-softmax score matrix.
    """
    d_head = q.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(d_head, dtype=policy.accum_dtype))
    # [B, H, Lq, Lk], accumulated in f32 regardless of compute dtype.
    scores = policy.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        scores = jnp.where(mask == 0, jnp.asarray(MASK_FILL_VALUE, scores.dtype), scores)
    probs = jnp.exp(scores - jnp.max(scores, axis=-1, keepdims=True))
    probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
    out = policy.einsum("bhqk,bhkd->bhqd", probs, v)
    if return_scores:
        return out, probs
    return out
