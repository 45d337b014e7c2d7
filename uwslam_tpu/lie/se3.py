"""SE(3) rigid-body transforms in pure JAX.

Capability parity with Sophus SE3 as used by the reference tracker
(/root/reference/thirdparty/sophus/se3.hpp:201,285,723 — exp/log/matrix/
inverse/operator*; pose update T <- T * exp(delta) at
/root/reference/src/Tracker.cpp:849), re-designed for batched arrays:

- Transforms are (..., 4, 4) homogeneous matrices; compose = matmul.
- Twists are (..., 6) arrays ordered [v(3), w(3)] (translation first, matching
  the reference's Jacobian column order at src/Tracker.cpp:455-467).
- exp/log share the Taylor-guarded SO(3) kernels, safe under jit and vmap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import so3
from ..utils.precision import einsum as _einsum, mm as _mm


def identity(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)


def from_rotation_translation(R: jax.Array, t: jax.Array) -> jax.Array:
    """Build (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def rotation(T: jax.Array) -> jax.Array:
    return T[..., :3, :3]


def translation(T: jax.Array) -> jax.Array:
    return T[..., :3, 3]


def exp(xi: jax.Array) -> jax.Array:
    """Exponential map: twist (..., 6) [v, w] -> transform (..., 4, 4).

    R = exp(w), t = V(w) v with V the SO(3) left Jacobian.
    """
    v, w = xi[..., :3], xi[..., 3:]
    R = so3.exp(w)
    V = so3.left_jacobian(w)
    t = _einsum("...ij,...j->...i", V, v)
    return from_rotation_translation(R, t)


def log(T: jax.Array) -> jax.Array:
    """Logarithm map: transform (..., 4, 4) -> twist (..., 6) [v, w]."""
    w = so3.log(rotation(T))
    Vinv = so3.left_jacobian_inverse(w)
    v = _einsum("...ij,...j->...i", Vinv, translation(T))
    return jnp.concatenate([v, w], axis=-1)


def inverse(T: jax.Array) -> jax.Array:
    """Closed-form inverse [R^T, -R^T t] (cheaper + stabler than linalg.inv)."""
    Rt = jnp.swapaxes(rotation(T), -1, -2)
    t = translation(T)
    return from_rotation_translation(Rt, -_einsum("...ij,...j->...i", Rt, t))


def compose(Ta: jax.Array, Tb: jax.Array) -> jax.Array:
    return _mm(Ta, Tb)


def apply(T: jax.Array, p: jax.Array) -> jax.Array:
    """Transform points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return (
        _einsum("...ij,...j->...i", rotation(T), p) + translation(T)
    )


def adjoint(T: jax.Array) -> jax.Array:
    """Adjoint (..., 6, 6) for the [v, w] twist ordering:

        Ad = [[R, hat(t) R], [0, R]]
    """
    R = rotation(T)
    t = translation(T)
    tR = _mm(so3.hat(t), R)
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([zero, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def normalize(T: jax.Array) -> jax.Array:
    """Re-orthonormalize the rotation block after long compose chains."""
    return from_rotation_translation(so3.normalize(rotation(T)), translation(T))


def interpolate(Ta: jax.Array, Tb: jax.Array, t) -> jax.Array:
    """Geodesic interpolation on SE(3): Ta * exp(t * log(Ta^-1 Tb))."""
    rel = log(compose(inverse(Ta), Tb))
    return compose(Ta, exp(rel * jnp.asarray(t)[..., None]))


def right_update(T: jax.Array, delta: jax.Array) -> jax.Array:
    """Forward-compositional GN update T <- T * exp(delta).

    Mirrors the reference's update rule at src/Tracker.cpp:849; renormalizes
    so repeated f32 updates do not drift off the manifold.
    """
    return normalize(compose(T, exp(delta)))


def to_quaternion_translation(T: jax.Array) -> tuple[jax.Array, jax.Array]:
    """-> ([w,x,y,z] quaternion, translation); the trajectory export format."""
    return so3.to_quaternion(rotation(T)), translation(T)


def from_quaternion_translation(q: jax.Array, t: jax.Array) -> jax.Array:
    return from_rotation_translation(so3.from_quaternion(q), t)
