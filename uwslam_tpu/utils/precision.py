"""Matmul precision helpers.

On the GPU an f32 matmul at default precision may run in TF32, which keeps
about three decimal digits; geometry math (Lie algebra, 3x3/4x4 composes,
normal equations) needs full f32 or it loses digits per product. These
helpers pin HIGHEST precision; the FLOP cost is
negligible for small matrices, and bulk kernels that tolerate bf16 (e.g.
descriptor matching) opt in to default precision explicitly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Full-precision matmul for geometry-sized operands."""
    return jnp.matmul(a, b, precision=HIGHEST)


def einsum(subscripts: str, *operands: jax.Array) -> jax.Array:
    """Full-precision einsum."""
    return jnp.einsum(subscripts, *operands, precision=HIGHEST)
