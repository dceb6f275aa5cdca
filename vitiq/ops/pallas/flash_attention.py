"""Fused self-attention for the bf16 production path: one Pallas kernel,
compiled through Triton for NVIDIA GPUs.

Why a kernel (ref: ViT/models/layers/scale_dot_product_attention.py:18-39):
the plain path materializes the [B, H, L, L] f32 score tensor in device
memory, reads it back for the softmax, then writes and reads the
probabilities again. At this model's short sequences (L = 16..1025) and
tiny heads (d_head 16-32) that score traffic, not the matmuls, is the
layer's cost. Here scores and probabilities never leave on-chip memory.

Design:

* One program per (batch row, head, query block). Heads stay packed in the
  model dimension of the [B, L, D] projections; the [B, L, H, dh] view is a
  free reshape, and each program reads its head's dh-wide column stripe.
* Queries and keys are tiled in power-of-two blocks of up to 64 rows with
  masked tails, so L = 129 costs three key blocks, not a pad to 256.
* Online (running-max) softmax over the key blocks in base 2, f32
  accumulation of bf16 products; the 1/sum normalization is applied once to
  the [block, dh] output.

The backward recomputes attention under XLA (custom_vjp) instead of saving
the probabilities, in batch chunks sized from the device's memory limit.

`fused_attention` is the packed-layout entry `mha_apply` calls;
`attention_route` decides, without running anything, whether a call takes
the kernel or the plain XLA path.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vitiq.ops.attention import scaled_dot_product_attention
from vitiq.ops.numerics import BF16, Policy, REFERENCE

_LOG2E = 1.4426950408889634
_MAX_BLOCK = 64


def attention_route(mask=None, return_scores: bool = False,
                    backend: Optional[str] = None,
                    interpret: bool = False) -> str:
    """'kernel' or 'plain' for one attention call.

    A mask or a request for the score matrix needs the plain path (the
    kernel never forms the scores). Otherwise the kernel runs where it is
    compiled, on the GPU, or anywhere in the Pallas interpreter
    (`interpret=True`). Decided from the arguments and the backend name
    alone."""
    if mask is not None or return_scores:
        return "plain"
    if interpret:
        return "kernel"
    backend = backend or jax.default_backend()
    return "kernel" if backend == "gpu" else "plain"


def block_size(seq_len: int) -> int:
    """Query/key tile: the next power of two of L, between 16 (the tensor
    cores' smallest dot) and 64."""
    return min(_MAX_BLOCK, max(16, pl.next_power_of_2(seq_len)))


def _attention_kernel(q_ref, k_ref, v_ref, o_ref, *, seq_len: int, block: int,
                      scale: float):
    """One (batch row, head, query block): refs are the head's [L, dh]."""
    start_q = pl.program_id(2) * block
    rows = start_q + jnp.arange(block)
    q = plgpu.load(q_ref.at[pl.ds(start_q, block), :],
                   mask=(rows < seq_len)[:, None], other=0.0)
    dh = q.shape[-1]

    def body(j, carry):
        acc, m_prev, l_prev = carry
        cols = j * block + jnp.arange(block)
        key_ok = cols < seq_len
        k = plgpu.load(k_ref.at[pl.ds(j * block, block), :],
                       mask=key_ok[:, None], other=0.0)
        v = plgpu.load(v_ref.at[pl.ds(j * block, block), :],
                       mask=key_ok[:, None], other=0.0)
        s = pl.dot(q, k, trans_b=True) * (scale * _LOG2E)  # [block, block]
        s = jnp.where(key_ok[None, :], s, -jnp.inf)
        m_next = jnp.maximum(m_prev, jnp.max(s, axis=-1))
        alpha = jnp.exp2(m_prev - m_next)
        p = jnp.exp2(s - m_next[:, None])
        l_next = l_prev * alpha + jnp.sum(p, axis=-1)
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_next, l_next

    init = (jnp.zeros((block, dh), jnp.float32),
            jnp.full((block,), -jnp.inf, jnp.float32),
            jnp.zeros((block,), jnp.float32))
    acc, _, l_sum = jax.lax.fori_loop(0, pl.cdiv(seq_len, block), body, init)
    plgpu.store(o_ref.at[pl.ds(start_q, block), :],
                (acc / l_sum[:, None]).astype(o_ref.dtype),
                mask=(rows < seq_len)[:, None])


def kernel_attention(q, k, v, n_head: int, interpret: bool = False):
    """Packed [B, L, D] self-attention through the Triton kernel (no mask).

    `interpret=True` runs the kernel in the Pallas interpreter (tests on
    the CPU)."""
    B, L, D = q.shape
    dh = D // n_head
    block = block_size(L)
    spec = pl.BlockSpec((None, L, None, dh), lambda b, h, i: (b, 0, h, 0))
    heads = lambda t: t.reshape(B, L, n_head, dh)
    out = pl.pallas_call(
        functools.partial(_attention_kernel, seq_len=L, block=block,
                          scale=1.0 / dh ** 0.5),
        grid=(B, n_head, pl.cdiv(L, block)),
        in_specs=[spec, spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((B, L, n_head, dh), q.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="vitiq_attention",
    )(heads(q), heads(k), heads(v))
    return out.reshape(B, L, D)


def plain_packed_attention(q, k, v, n_head: int, policy: Policy,
                           mask=None, return_scores: bool = False):
    """The plain XLA path over packed [B, L, D] operands."""
    B, L, D = q.shape
    split = lambda t: t.reshape(B, L, n_head, D // n_head).transpose(0, 2, 1, 3)
    res = scaled_dot_product_attention(split(q), split(k), split(v), mask=mask,
                                       policy=policy,
                                       return_scores=return_scores)
    merge = lambda t: t.transpose(0, 2, 1, 3).reshape(B, L, D)
    if return_scores:
        return merge(res[0]), res[1]
    return merge(res)


def bwd_budget_bytes() -> Optional[int]:
    """Bytes the backward's recomputed score tensors may take at once: an
    eighth of the device's memory limit, or None (no chunking) where the
    device reports no limit."""
    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"]) // 8


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _attention(q, k, v, n_head, interpret):
    return kernel_attention(q, k, v, n_head, interpret)


def _attention_fwd(q, k, v, n_head, interpret):
    return kernel_attention(q, k, v, n_head, interpret), (q, k, v)


def _attention_bwd(n_head, interpret, residuals, g):
    # Recompute under XLA in the primal's dtype: the primal ran bf16
    # products, so an f32 HIGHEST recompute would cost more for nothing.
    q, k, v = residuals
    policy = BF16 if q.dtype == jnp.bfloat16 else REFERENCE
    B, L, D = q.shape

    def one(args):
        qc, kc, vc, gc = args
        _, vjp = jax.vjp(
            lambda a, b, c: plain_packed_attention(a, b, c, n_head,
                                                   policy).astype(q.dtype),
            qc, kc, vc)
        return vjp(gc)

    # The recompute holds ~7 bytes per score element (f32 scores, bf16
    # probabilities, a mask); tile the batch with lax.map so one chunk's
    # score tensors are live at a time.
    budget = bwd_budget_bytes()
    per_frame = n_head * L * L * 7
    chunk = B if budget is None else max(1, min(B, budget // per_frame))
    g = g.astype(q.dtype)
    if chunk >= B:
        return one((q, k, v, g))
    nb = -(-B // chunk)
    pad = nb * chunk - B

    def tile(t):
        return jnp.pad(t, ((0, pad), (0, 0), (0, 0))).reshape(nb, chunk, L, D)

    grads = jax.lax.map(one, (tile(q), tile(k), tile(v), tile(g)))
    return tuple(t.reshape(nb * chunk, L, D)[:B] for t in grads)


_attention.defvjp(_attention_fwd, _attention_bwd)


def sharded_kernel_attention(q, k, v, n_head: int, interpret: bool = False):
    """The differentiable kernel, run per shard under an ambient mesh.

    XLA's partitioner cannot split a pallas_call, so under a mesh the
    kernel runs inside `jax.shard_map`: the batch over the data axes and,
    under tensor parallelism, the packed heads over 'model' (the QKV
    projections are column-sharded by head)."""
    from jax.sharding import PartitionSpec as P

    from vitiq.parallel.mesh import ambient_mesh, mesh_data_axes

    mesh = ambient_mesh()
    if mesh is None or mesh.size == 1:
        return _attention(q, k, v, n_head, interpret)
    tp = dict(mesh.shape).get("model", 1)
    spec = P(mesh_data_axes(mesh) or None, None, "model" if tp > 1 else None)
    return jax.shard_map(
        lambda a, b, c: _attention(a, b, c, n_head // tp, interpret),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)(q, k, v)


def fused_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    n_head: int,
    mask: Optional[jnp.ndarray] = None,
    policy: Policy = REFERENCE,
    return_scores: bool = False,
    interpret: bool = False,
):
    """Packed-layout attention: [B, L, d_model] in and out.

    The Triton kernel where `attention_route` says so (per shard under a
    mesh); the plain XLA path otherwise. `interpret=True` takes the kernel
    on any backend, run in the Pallas interpreter, which is how the CPU
    tests and the virtual-mesh dry run certify it."""
    if attention_route(mask, return_scores, interpret=interpret) == "plain":
        return plain_packed_attention(q, k, v, n_head, policy, mask=mask,
                                      return_scores=return_scores)
    c = policy.cast_compute
    # stays in the compute dtype: the w_concat GEMM consumes it directly
    return sharded_kernel_attention(c(q), c(k), c(v), n_head, interpret)


fused_attention.packed_layout = True
