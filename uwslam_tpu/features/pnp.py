"""Batched PnP RANSAC: camera pose from 2D-3D correspondences.

The reference has no relocalization at all — a diverged Gauss-Newton just
writes a bad pose (SURVEY.md §5 "Tracking failure is not even detected").
This module supplies the missing capability as batched arrays: a fixed batch of
minimal DLT hypotheses evaluated with vmap, MSAC scoring, and a robust
Gauss-Newton polish on SE(3) — the same static-shape RANSAC shape as
features.ransac.

Used by SlamSystem for relocalization after tracking failure: match current
features against keyframe features, PnP against the keyframe's 3D points.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..lie import se3
from ..utils.precision import HIGHEST
from ..utils.linalg import cholesky_solve_unrolled, smallest_eigvec_spd


class PnPResult(NamedTuple):
    T: jax.Array           # (4, 4) camera <- world (points' frame)
    inliers: jax.Array     # (K,) bool
    num_inliers: jax.Array
    ok: jax.Array


def _dlt_pose(p3d: jax.Array, xy: jax.Array, w: jax.Array):
    """Weighted DLT: projection matrix from >=6 2D-3D pairs, then the nearest
    rigid (R, t). p3d: (M, 3), xy: (M, 2) normalized coords, w: (M,)."""
    X = jnp.concatenate([p3d, jnp.ones_like(p3d[:, :1])], axis=-1)  # (M, 4)
    zero = jnp.zeros_like(X)
    x, y = xy[:, 0:1], xy[:, 1:2]
    rows_u = jnp.concatenate([X, zero, -x * X], axis=-1)   # (M, 12)
    rows_v = jnp.concatenate([zero, X, -y * X], axis=-1)
    A = jnp.concatenate([rows_u * w[:, None], rows_v * w[:, None]], axis=0)
    AtA = jnp.einsum("mi,mj->ij", A, A, precision=HIGHEST)
    P = smallest_eigvec_spd(AtA).reshape(3, 4)
    # Resolve the null vector's arbitrary global sign by cheirality BEFORE
    # factorization: with P = -sigma*R the "nearest rotation" problem is
    # DEGENERATE (det < 0 with equal singular values has a continuum of
    # minimizers), so U diag(1,1,-1) V^T depends on the SVD's internal
    # basis choice.
    # With the sign fixed the factorization is continuous and unique.
    depth = p3d @ P[2, :3] + P[2, 3]
    s_z = jnp.sum(jnp.where(w > 0, jnp.sign(depth), 0.0))
    P = P * jnp.where(s_z < 0, -1.0, 1.0)
    M, m = P[:, :3], P[:, 3]
    # Nearest rotation: R = U Vt; scale from singular values; cheirality by
    # requiring positive mean depth over the (weighted) points.
    U, S, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    R = U @ jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, d])) @ Vt
    scale = jnp.mean(S) * d
    t = m / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    z = (p3d @ R.T + t)[:, 2]
    flip = jnp.sum(jnp.where(w > 0, jnp.sign(z), 0.0)) < 0
    R = jnp.where(flip, -R, R)  # (-R, -t) also satisfies the DLT equations
    t = jnp.where(flip, -t, t)
    # -R is not a rotation (det=-1): re-project onto SO(3).
    Ur, _, Vtr = jnp.linalg.svd(R)
    Dr = jnp.diag(jnp.array([1.0, 1.0, jnp.sign(jnp.linalg.det(Ur @ Vtr))]))
    R = Ur @ Dr @ Vtr
    return se3.from_rotation_translation(R, t)


def _planar_poses(p3d: jax.Array, xy: jax.Array):
    """Two candidate poses from a (near-)coplanar minimal sample via the
    homography construction used in planar calibration: fit the points'
    plane, estimate the plane->image homography H, and read the pose from
    H ~ [R e1, R e2, R c + t]. DLT on the projection matrix is DEGENERATE
    for coplanar points, so this family is what makes PnP work on planar
    scenes (walls, seafloor patches — the monocular-SLAM common case).

    Returns (T_plus, T_minus): both homography scale signs; the caller's
    MSAC scoring picks by cheirality."""
    c = p3d.mean(axis=0)
    Q = p3d - c
    C = jnp.einsum("mi,mj->ij", Q, Q, precision=HIGHEST)
    _, V = jnp.linalg.eigh(C)
    e1, e2 = V[:, 2], V[:, 1]        # in-plane basis (largest variance)
    uv_pl = jnp.stack([Q @ e1, Q @ e2], axis=-1)  # (M, 2) plane coords

    # DLT homography plane->normalized-image (rows like the 8-point setup).
    u, v = uv_pl[:, 0], uv_pl[:, 1]
    x, y = xy[:, 0], xy[:, 1]
    one = jnp.ones_like(u)
    zero = jnp.zeros_like(u)
    rows_x = jnp.stack([u, v, one, zero, zero, zero, -x * u, -x * v, -x], -1)
    rows_y = jnp.stack([zero, zero, zero, u, v, one, -y * u, -y * v, -y], -1)
    A = jnp.concatenate([rows_x, rows_y], axis=0)
    AtA = jnp.einsum("mi,mj->ij", A, A, precision=HIGHEST)
    H = smallest_eigvec_spd(AtA).reshape(3, 3)

    def pose_from(lam):
        r1 = lam * H[:, 0]
        r2 = lam * H[:, 1]
        t_pl = lam * H[:, 2]
        # Orthogonalize [r1 r2 r1xr2] -> nearest rotation.
        Rp = jnp.stack([r1, r2, jnp.cross(r1, r2)], axis=-1)
        U, _, Vt = jnp.linalg.svd(Rp)
        D = jnp.diag(
            jnp.array([1.0, 1.0, jnp.sign(jnp.linalg.det(U @ Vt))])
        )
        Rp = U @ D @ Vt
        # X_cam = Rp [u, v, 0]^T + t_pl with plane basis B = [e1 e2 n]:
        # R = Rp B^T, t = t_pl - R c.
        B = jnp.stack([e1, e2, jnp.cross(e1, e2)], axis=-1)
        R = Rp @ B.T
        t = t_pl - R @ c
        return se3.from_rotation_translation(R, t)

    lam = 2.0 / (jnp.linalg.norm(H[:, 0]) + jnp.linalg.norm(H[:, 1]) + 1e-12)
    return pose_from(lam), pose_from(-lam)


def _reproj_sq(T: jax.Array, p3d: jax.Array, xy: jax.Array, scale):
    """Squared reprojection error, per-axis scaled (pass (fx, fy) to measure
    in PIXELS with anisotropic focals); behind-camera points get +inf so
    they can never count as inliers."""
    pc = p3d @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    proj = pc[:, :2] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)[:, None]
    d = jnp.sum(((proj - xy) * scale) ** 2, axis=-1)
    return jnp.where(z > 1e-6, d, jnp.inf)


def _gn_polish_pose(
    T0: jax.Array,
    p3d: jax.Array,
    xy: jax.Array,
    valid: jax.Array,
    t2: float,
    scale,
    iters: int = 8,
):
    """Robust Gauss-Newton on SE(3) minimizing truncated reprojection error."""
    vw = valid.astype(jnp.float32)

    def residuals(T):
        pc = p3d @ T[:3, :3].T + T[:3, 3]
        z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        return (pc[:, :2] / z[:, None] - xy) * scale  # (K, 2)

    def score(T):
        d = _reproj_sq(T, p3d, xy, scale)
        return jnp.where(valid, jnp.minimum(d, t2), 0.0).sum()

    def step(carry, _):
        T, best_T, best_s = carry

        def r_of(xi):
            return residuals(se3.compose(T, se3.exp(xi))).reshape(-1)

        xi0 = jnp.zeros(6)
        r = r_of(xi0)
        J = jax.jacfwd(r_of)(xi0)  # (2K, 6)
        d = _reproj_sq(T, p3d, xy, scale)
        wr = jnp.repeat(vw * jnp.where(d < t2, 1.0 / (1.0 + d / t2), 0.0), 2)
        A = jnp.einsum("ki,k,kj->ij", J, wr, J, precision=HIGHEST)
        g = jnp.einsum("ki,k->i", J, wr * r, precision=HIGHEST)
        xi = -cholesky_solve_unrolled(A + 1e-8 * jnp.eye(6), g)
        T_new = se3.normalize(se3.compose(T, se3.exp(xi)))
        s = score(T_new)
        better = s <= best_s
        best_T = jnp.where(better, T_new, best_T)
        best_s = jnp.where(better, s, best_s)
        return (T_new, best_T, best_s), None

    s0 = score(T0)
    (_, bT, bs), _ = jax.lax.scan(step, (T0, T0, s0), None, length=iters)
    return bT, bs


@partial(jax.jit, static_argnames=("num_hypotheses", "min_inliers"))
def pnp_ransac(
    p3d: jax.Array,
    xy: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    threshold_norm: float = 3.0 / 500.0,
    num_hypotheses: int = 128,
    min_inliers: int = 12,
    axis_scale=(1.0, 1.0),
) -> PnPResult:
    """Robust camera pose from 2D-3D matches.

    p3d: (K, 3) points in the reference frame; xy: (K, 2) NORMALIZED image
    coords of their observations; valid: (K,) mask. Returns T (camera <-
    reference) with MSAC-selected inliers and a GN polish from the top-4
    hypotheses.

    axis_scale: per-axis residual scaling. Pass (fx, fy) together with a
    threshold in PIXELS to measure error isotropically in pixels even with
    anisotropic focals (a single normalized threshold under-tolerates the
    y axis when fy < fx)."""
    K = p3d.shape[0]
    t2 = threshold_norm * threshold_norm
    scale = jnp.asarray(axis_scale, jnp.float32)

    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (num_hypotheses, K), minval=1e-9, maxval=1.0)
    ))
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    _, sample_idx = jax.lax.top_k(scores, 6)  # (H, 6)

    def solve_one(idx):
        T_dlt = _dlt_pose(p3d[idx], xy[idx], jnp.ones((6,)))
        T_hp, T_hm = _planar_poses(p3d[idx], xy[idx])
        return jnp.stack([T_dlt, T_hp, T_hm])

    Ts = jax.vmap(solve_one)(sample_idx).reshape(-1, 4, 4)  # (3H, 4, 4)

    def msac(T):
        d = _reproj_sq(T, p3d, xy, scale)
        inl = valid & (d < t2)
        return inl, jnp.where(valid, jnp.minimum(d, t2), 0.0).sum()

    _, scores_h = jax.vmap(msac)(Ts)
    k = min(4, num_hypotheses)
    _, top_idx = jax.lax.top_k(-scores_h, k)
    T_pol, score_pol = jax.vmap(
        lambda T: _gn_polish_pose(T, p3d, xy, valid, t2, scale)
    )(Ts[top_idx])
    j = jnp.argmax(-score_pol)
    T_best = T_pol[j]
    inliers, _ = msac(T_best)
    n = inliers.sum()
    return PnPResult(T=T_best, inliers=inliers, num_inliers=n,
                     ok=n >= min_inliers)


def pnp_from_pixels(
    cam,
    p3d: jax.Array,
    uv: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    threshold_px: float = 3.0,
    num_hypotheses: int = 128,
    min_inliers: int = 12,
) -> PnPResult:
    """PnP from PIXEL observations: normalizes with the camera intrinsics and
    thresholds in pixels (per-axis exact). The shared entry for
    relocalization and loop-closure verification."""
    f = jnp.asarray([cam.fx, cam.fy], jnp.float32)
    c = jnp.asarray([cam.cx, cam.cy], jnp.float32)
    return pnp_ransac(
        p3d, (uv - c) / f, valid, key,
        threshold_norm=threshold_px,
        num_hypotheses=num_hypotheses,
        min_inliers=min_inliers,
        axis_scale=(float(cam.fx), float(cam.fy)),
    )
