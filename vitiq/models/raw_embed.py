"""Fused raw-frame embedding: preprocess + patchify + embed + CLS + PE as ONE
GEMM straight off the raw [B, L, 2] frame batch.

Motivation: the unfused front-end — z-score -> channel concat ->
image/segment fold -> embed GEMM -> CLS concat -> PE add — is a chain of
small-minor-dim layout ops that XLA materializes, and its adjoint (the embed
dW needs the fold output) re-runs the fold in the backward. Every op in the chain is AFFINE in the raw
frame, so the whole front-end folds EXACTLY into the embedding GEMM:

  tokens = zscore_fold(x) @ W + b + PE  ==  x_flat @ W' + b'

with W' a static re-indexing of W scaled by 1/sigma (the z-score scale), and
b' absorbing the z-score shift (mu/sigma contracted through W), the PE table,
and the CLS row. The fold is rebuilt in-jit each step from the LIVE embedding
parameters (a gather + broadcast over a [2L, D]-sized tensor — trivial next
to the GEMM), so gradients flow to W / b / cls_token through plain GEMM
adjoints: no fold recompute, no scatter adjoints, no padded intermediates.

Reference semantics preserved exactly (f32): the per-channel z-score of
ViT/dataloader/dataset.py:211-226 and transformer_rawIQ/dataloader/
dataset.py:214-224, the Conv2d/Conv1d patchifiers (ViT/models/embedding/
patch_embedding.py:3-15, transformer_rawIQ/models/embedding/
patch_embedding.py:5-60), the CLS prepend and sinusoidal PE add
(ViT/models/encoder.py:34-53). Under the bf16 policy the fused GEMM
rounds differently from the unfused chain (W/sigma is rounded once instead of
z per-element) — equal-quality numerics, covered by the parity tests.

Arms:
  * vit      — patches are a strided permutation of the frame, so W expands
               to a block-sparse [2L, (N+1)*D] operand (one non-zero D-block
               per input element); CLS and PE ride in the bias. One GEMM,
               zero layout ops.
  * segment  — each token is a CONTIGUOUS run of 2*s raw values, so the fold
               is a free reshape and W only needs its rows permuted
               ((C, k) -> interleaved (k, C)). PE is a broadcast add; CLS
               (when configured) stays a concat.
  * conv1d   — tokens are per-sample: raw [B, L, 2] is already the fold;
               W is just scaled by 1/sigma.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vitiq.config import ModelConfig
from vitiq.models.embeddings import sinusoidal_encoding
from vitiq.ops.numerics import Policy


def fused_raw_embed_supported(cfg: ModelConfig) -> bool:
    """True when the arm's front-end is expressible as the fused GEMM."""
    if cfg.arm == "vit":
        # image must be exactly the channel-major concat of the frame
        return (cfg.in_channels == 1
                and cfg.img_size_h * cfg.img_size_w == 2 * cfg.seq_length)
    if cfg.embedding_type == "segment":
        return cfg.segment_size is not None and cfg.seq_length % cfg.segment_size == 0
    return cfg.embedding_type == "conv1d"


def fused_raw_embed_enabled(cfg: ModelConfig) -> bool:
    """Gate for entry points (bench/train/serve): on under the bf16 numerics
    ('tpu' preset) wherever the fold is supported — always for the rawIQ
    arms, whose segment/conv1d folds are contiguous (the same FLOPs with
    the layout ops deleted), and for the vit arm only while the
    block-sparse [2L, (N+1)*D] expansion is small ((N+1)*D <= 2048: its
    extra MACs grow with the token count). The 'reference' f32 policy keeps
    the unfused chain as the bit-parity target. Pure XLA — works on every
    backend. The vit threshold is not yet re-measured on the GPU."""
    if cfg.numerics != "tpu" or not fused_raw_embed_supported(cfg):
        return False
    return cfg.arm != "vit" or cfg.num_tokens * cfg.d_model <= 2048


def _exact_dot(a, b):
    """f32 product of parameter-sized operands at full precision (a GPU
    would otherwise run it in TF32 under either numerics policy)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def _vit_maps(cfg: ModelConfig):
    """Static (p_of, t_of) over the interleaved flat index f = 2*l + c."""
    L, W_img, ps = cfg.seq_length, cfg.img_size_w, cfg.patch_size
    m = np.arange(2 * L)  # channel-major flat position (I block then Q block)
    r, col = m // W_img, m % W_img
    t_of_m = (r // ps) * (W_img // ps) + col // ps
    p_of_m = (r % ps) * ps + (col % ps)
    c_of_m, l_of_m = m // L, m % L
    f_of_m = 2 * l_of_m + c_of_m
    p_of = np.empty(2 * L, np.int32)
    t_of = np.empty(2 * L, np.int32)
    c_of = np.empty(2 * L, np.int32)
    p_of[f_of_m], t_of[f_of_m], c_of[f_of_m] = p_of_m, t_of_m, c_of_m
    return p_of, t_of, c_of


def fused_raw_embed_apply(
    enc_params,
    x: jnp.ndarray,
    cfg: ModelConfig,
    stats: Dict[str, float],
    policy: Policy,
) -> jnp.ndarray:
    """[B, L, 2] raw frames -> [B, Ltok, D] tokens (CLS prepended when the
    arm has one, PE added) — the exact output of preprocess_batch_* ->
    embed -> CLS concat -> add_positional_encoding."""
    B, L, C = x.shape
    if C != 2 or L != cfg.seq_length:
        raise ValueError(f"expected raw [B, {cfg.seq_length}, 2], got {x.shape}")
    D = cfg.d_model
    proj = enc_params["embedding"]["proj"]
    W, b = proj["kernel"], proj["bias"]
    mu = jnp.asarray([stats["i_mean"], stats["q_mean"]], jnp.float32)
    inv_sigma = 1.0 / jnp.asarray([stats["i_std"], stats["q_std"]], jnp.float32)
    has_cls = "cls_token" in enc_params

    if cfg.arm == "vit":
        p_of, t_of, c_of = _vit_maps(cfg)
        N = (cfg.img_size_h // cfg.patch_size) * (cfg.img_size_w // cfg.patch_size)
        off = 1  # ViT always prepends CLS
        Wp = W[p_of] * inv_sigma[c_of][:, None]                  # [2L, D] f32
        onehot = jnp.asarray(np.eye(N + off, dtype=np.float32)[t_of + off])
        w_big = (onehot[:, :, None] * Wp[:, None, :]).reshape(2 * L, (N + off) * D)
        shift = _exact_dot(mu[c_of], w_big)  # w_big rows carry 1/sigma
        pe = sinusoidal_encoding(cfg.num_tokens, D, jnp.float32)[: N + off]
        bias = jnp.concatenate(
            [enc_params["cls_token"].reshape(1, D).astype(jnp.float32),
             jnp.broadcast_to(b.astype(jnp.float32), (N, D))]
        ) + pe
        bias = bias.reshape(-1) - shift
        out = policy.dot(x.reshape(B, 2 * L), w_big) + bias
        return policy.cast_output(out).reshape(B, N + off, D)

    if cfg.embedding_type == "segment":
        s = cfg.segment_size
        N = L // s
        # rows of the folded token are (C, k)-ordered; raw rows are (k, C)
        k = np.arange(2 * s) // 2
        c = np.arange(2 * s) % 2
        row_of = c * s + k                                        # [2s]
        w_perm = W[row_of] * inv_sigma[c][:, None]                # [2s, D] f32
        shift = _exact_dot(mu[c], w_perm)  # w_perm rows carry 1/sigma
        tokens = policy.cast_output(
            policy.dot(x.reshape(B, N, 2 * s), w_perm)
            + (b.astype(jnp.float32) - shift))
    else:  # conv1d: per-sample pointwise embed, raw layout is the fold
        w_perm = W * inv_sigma[:, None]                           # [2, D]
        shift = _exact_dot(mu, w_perm)
        tokens = policy.cast_output(
            policy.dot(x, w_perm) + (b.astype(jnp.float32) - shift))
        N = L

    if has_cls:
        cls = jnp.broadcast_to(
            enc_params["cls_token"].astype(tokens.dtype), (B, 1, D))
        tokens = jnp.concatenate([cls, tokens], axis=1)
        N += 1
    pe = sinusoidal_encoding(cfg.num_tokens, D, tokens.dtype)[:N]
    return tokens + pe
