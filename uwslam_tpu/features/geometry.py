"""Two-view geometry: essential decomposition, pose recovery, triangulation.

Capability parity with the reference's standalone essential-matrix VO
(/root/reference/src/feature_detector.cpp:262-281: findEssentialMat ->
recoverPose -> triangulatePoints), batched and jittable.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..lie import se3
from ..utils.precision import HIGHEST


def decompose_essential(E: jax.Array):
    """E -> four candidate (R, t) pairs. t is unit-norm (monocular scale)."""
    U, _, Vt = jnp.linalg.svd(E)
    # Ensure proper rotations.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def triangulate_linear(
    T_a: jax.Array, T_b: jax.Array, xy_a: jax.Array, xy_b: jax.Array
) -> jax.Array:
    """DLT midpoint triangulation in normalized camera coords.

    T_a/T_b: (4,4) world->camera transforms; xy: (K, 2) normalized coords.
    Returns (K, 3) world points (cv::triangulatePoints equivalent,
    reference src/feature_detector.cpp:276-281)."""
    Pa = T_a[:3, :]  # (3, 4)
    Pb = T_b[:3, :]

    def tri_one(xa, xb):
        rows = jnp.stack(
            [
                xa[0] * Pa[2] - Pa[0],
                xa[1] * Pa[2] - Pa[1],
                xb[0] * Pb[2] - Pb[0],
                xb[1] * Pb[2] - Pb[1],
            ]
        )  # (4, 4)
        # Homogeneous DLT: the null vector of the (4, 4) rows by eigh.
        AtA4 = jnp.einsum("mi,mj->ij", rows, rows, precision=HIGHEST)
        Xh = jnp.linalg.eigh(AtA4)[1][:, 0]
        return Xh[:3] / jnp.where(jnp.abs(Xh[3]) < 1e-12, 1e-12, Xh[3])

    return jax.vmap(tri_one)(xy_a, xy_b)


class RecoveredPose(NamedTuple):
    T: jax.Array           # (4, 4) b <- a with unit translation
    points: jax.Array      # (K, 3) triangulated points in frame a
    cheirality: jax.Array  # (K,) bool: in front of both cameras
    num_good: jax.Array


@partial(jax.jit, static_argnames=())
def recover_pose(
    E: jax.Array, xy_a: jax.Array, xy_b: jax.Array, valid: jax.Array
) -> RecoveredPose:
    """Pick the (R, t) candidate with the best cheirality vote
    (cv::recoverPose equivalent, reference src/feature_detector.cpp:266-269)."""
    candidates = decompose_essential(E)
    T_a = jnp.eye(4)

    def score(RT):
        R, t = RT
        T_b = se3.from_rotation_translation(R, t)
        pts = triangulate_linear(T_a, T_b, xy_a, xy_b)
        z_a = pts[:, 2]
        pts_b = se3.apply(T_b, pts)
        z_b = pts_b[:, 2]
        good = valid & (z_a > 1e-4) & (z_b > 1e-4)
        return good.sum(), (T_b, pts, good)

    scores, payloads = zip(*[score(rt) for rt in candidates])
    scores = jnp.stack(scores)
    best = jnp.argmax(scores)
    Ts = jnp.stack([p[0] for p in payloads])
    Ps = jnp.stack([p[1] for p in payloads])
    Gs = jnp.stack([p[2] for p in payloads])
    return RecoveredPose(
        T=Ts[best], points=Ps[best], cheirality=Gs[best], num_good=scores[best]
    )
