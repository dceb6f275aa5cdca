"""Int8 post-training quantization for the serving path.

Tensor cores execute int8 x int8 -> int32 at twice the bf16 rate, and int8
activations halve device-memory traffic. This module implements W8A8
dynamic quantization:

  * weights: per-output-channel symmetric int8 (absmax / 127), quantized once
    offline from a trained checkpoint;
  * activations: per-row (per-token) symmetric int8 scales computed on the
    fly — one reduction per matmul input, no calibration data needed;
  * accumulation in int32, dequantized by the rank-1 outer product of row and
    channel scales.

Only the GEMMs quantize; LayerNorm statistics, softmax, residuals and the
classifier head stay in the float policy (standard W8A8 transformer practice —
those are where int8 hurts accuracy, and they are not the bottleneck).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp


def quantize_linear_params(linear: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """{'kernel': [in, out] float, 'bias': [out]} -> int8 kernel + scales."""
    kernel = linear["kernel"].astype(jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(kernel), axis=0), 1e-8) / 127.0  # [out]
    kernel_q = jnp.clip(jnp.round(kernel / scale), -127, 127).astype(jnp.int8)
    return {"kernel_q": kernel_q, "scale": scale, "bias": linear["bias"]}


def quantize_params_int8(params: Any, keep_float: tuple = ("mlp_head",)) -> Any:
    """Quantize every Linear-shaped leaf dict ({'kernel','bias'}) in a model
    parameter pytree; everything else (LN affines, CLS token) passes through.
    Subtrees named in `keep_float` (default: the classifier head) stay float."""

    def walk(tree, name=""):
        if name in keep_float:
            return tree
        if isinstance(tree, dict):
            if set(tree) == {"kernel", "bias"} and tree["kernel"].ndim == 2:
                return quantize_linear_params(tree)
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def int8_linear(qlinear: Dict[str, jnp.ndarray], x: jnp.ndarray,
                out_dtype=jnp.float32) -> jnp.ndarray:
    """Dynamic-activation int8 matmul: y = (x_q @ w_q) * (s_row x s_col) + b.

    x: [..., in] float. Row scales from per-token absmax; int32 accumulation.
    """
    x32 = x.astype(jnp.float32)
    row_scale = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True), 1e-8) / 127.0
    x_q = jnp.clip(jnp.round(x32 / row_scale), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        x_q, qlinear["kernel_q"],
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    y = acc.astype(jnp.float32) * row_scale * qlinear["scale"] + qlinear["bias"]
    return y.astype(out_dtype)


def make_quantized_forward(cfg, attention_fn: Callable | None = None) -> Callable:
    """Quantized inference twin of models.make_forward: same architecture,
    GEMMs routed through int8_linear. Returns fn(qparams, src) -> logits.

    `qparams` comes from quantize_params_int8(trained_params). Embedding
    projection, QKV/attention-out and FFN matmuls run int8; attention scores,
    LayerNorms and the classifier head stay float (the head is [d, classes] —
    negligible compute, accuracy-critical).
    """
    from vitiq.config import ModelConfig  # noqa: F401  (type only)
    from vitiq.models import embeddings as emb
    from vitiq.models.layers import layer_norm_apply, linear_apply
    from vitiq.ops.attention import scaled_dot_product_attention
    from vitiq.ops.numerics import BF16

    cfg.validate()
    policy = BF16
    if attention_fn is None:
        attention_fn = scaled_dot_product_attention

    def qkv_attention(qlayer, x):
        B, L, D = x.shape
        n_head = cfg.n_head
        dh = D // n_head
        q = int8_linear(qlayer["w_q"], x)
        k = int8_linear(qlayer["w_k"], x)
        v = int8_linear(qlayer["w_v"], x)
        split = lambda t: t.reshape(B, L, n_head, dh).transpose(0, 2, 1, 3)
        out = attention_fn(split(q), split(k), split(v), policy=policy)
        out = out.transpose(0, 2, 1, 3).reshape(B, L, D)
        return int8_linear(qlayer["w_concat"], out)

    def encoder_layer(qlayer, x):
        attn = qkv_attention(qlayer["attention"], x)
        x = layer_norm_apply(qlayer["norm1"], attn + x)
        h = jnp.maximum(int8_linear(qlayer["ffn"]["linear1"], x), 0.0)
        y = int8_linear(qlayer["ffn"]["linear2"], h)
        return layer_norm_apply(qlayer["norm2"], y + x)

    def forward(qparams, src):
        enc = qparams["encoder"]
        if cfg.arm == "vit":
            tokens = emb.fold_patches_2d(src, cfg.patch_size)
        elif cfg.embedding_type == "conv1d":
            tokens = src.transpose(0, 2, 1)
        else:
            tokens = emb.fold_segments_1d(src, cfg.segment_size)
        x = int8_linear(enc["embedding"]["proj"], tokens)
        if "cls_token" in enc:
            cls = jnp.broadcast_to(enc["cls_token"].astype(x.dtype),
                                   (x.shape[0], 1, x.shape[2]))
            x = jnp.concatenate([cls, x], axis=1)
        x = emb.add_positional_encoding(x, cfg.num_tokens)
        for qlayer in enc["layers"]:
            x = encoder_layer(qlayer, x)
        if cfg.arm == "vit":
            feat = x[:, 0]
        else:
            feat = x[:, 0] if cfg.use_cls_token else jnp.mean(x, axis=1)
            # torch nn.LayerNorm default eps=1e-5, matching the float path
            # (vitiq/models/amc.py:75; ref: transformer_rawIQ.py:68)
            feat = layer_norm_apply(qparams["head_norm"], feat, eps=1e-5)
        # head stays float for accuracy (tiny GEMM)
        logits = linear_apply(qparams["mlp_head"], feat)
        return logits.astype(jnp.float32)

    return forward
