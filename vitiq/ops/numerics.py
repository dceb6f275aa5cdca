"""Numerics policies.

Two presets:

* ``REFERENCE`` — float32 everywhere; matches the PyTorch reference bit-closely
  (the parity target per SURVEY.md §7.3 is f32 / atol 1e-5).
* ``BF16`` (config preset name ``"tpu"``, kept so saved configs load) —
  bfloat16 matmul inputs with float32 accumulation and float32 parameters /
  softmax / LayerNorm statistics. This is the production preset: tensor
  cores consume bf16 at many times the f32 rate while every numerically
  sensitive reduction stays in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class Policy:
    """Casting rules for one forward/backward pass."""

    compute_dtype: jnp.dtype  # dtype fed to matmuls
    param_dtype: jnp.dtype = jnp.float32  # dtype parameters are stored in
    accum_dtype: jnp.dtype = jnp.float32  # matmul accumulation / softmax / LN
    # Matmul input precision. By default a GPU may run f32 products in TF32
    # (about three decimal digits); HIGHEST forces true f32 products, which
    # the 'reference' parity preset requires (atol 1e-5 vs the PyTorch f32
    # numerics). The bf16 preset feeds bf16 directly.
    precision: Optional[jax.lax.Precision] = None

    def cast_compute(self, x):
        return x.astype(self.compute_dtype)

    def cast_output(self, x):
        """Dtype for activations written between ops: f32 accumulation results
        are cast back to the compute dtype under bf16 policies so large
        intermediates (e.g. the FFN hidden) travel device memory at half
        width."""
        if self.compute_dtype == jnp.float32:
            return x
        return x.astype(self.compute_dtype)

    def dot(self, a, b):
        """Matmul over the last axis of ``a`` and first of ``b`` with policy
        casting and explicit f32 accumulation."""
        return jnp.dot(
            self.cast_compute(a),
            self.cast_compute(b),
            precision=self.precision,
            preferred_element_type=self.accum_dtype,
        )

    def einsum(self, spec, *args):
        return jnp.einsum(
            spec,
            *(self.cast_compute(a) for a in args),
            precision=self.precision,
            preferred_element_type=self.accum_dtype,
        )


REFERENCE = Policy(compute_dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST)
BF16 = Policy(compute_dtype=jnp.bfloat16)


def policy_for(numerics: str) -> Policy:
    if numerics == "reference":
        return REFERENCE
    if numerics == "tpu":
        return BF16
    raise ValueError(f"unknown numerics preset {numerics!r}")
