"""Windowed photometric bundle adjustment — direct alignment over keyframes.

The reference *intended* exactly this: its commented-out Ceres scaffolding is
a photometric cost (`ResidualIntensity`, /root/reference/include/Tracker.h:
295-505) over SE(3) poses, never finished. This module supplies it for real,
DSO-style, as batched arrays (SURVEY.md §7 layer 7 "photometric/reprojection BA"):

- Each keyframe owns a fixed-capacity set of semi-dense points (pixel +
  inverse depth + reference intensity). Every point is photometrically
  observed in every OTHER keyframe of the window: the observation lattice is
  the dense (owner i, observer j, point n) grid with a validity mask —
  no sparse graphs, no scatter; XLA sees static shapes end to end.
- One batched pass produces all residuals r = I_j(pi(X_j)) - I_i(x) and
  analytic Jacobians wrt both poses and inverse depths; sampling runs on the
  dense one-hot formulation (image.pyramid.bilinear_sample_dense).
- Inverse depths are scalars per point, so the landmark block Hdd is DIAGONAL
  and the Schur complement S = Hpp - Hpd Hdd^-1 Hpd^T is a couple of einsums
  — the textbook sparse-BA elimination becomes dense batched linear algebra.
- Levenberg-Marquardt with Huber weights; gauge fixed by a strong prior on
  keyframe 0; a weak inverse-depth prior regularizes the monocular scale
  direction.

Pose convention matches ba.schur: T_cw (camera-from-world), LEFT update
exp(delta) * T_cw, twist [v, w].
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..camera.model import PinholeCamera
from ..image.pyramid import bilinear_sample_dense
from ..lie import se3, so3
from ..utils.precision import HIGHEST


class PhotoBAProblem(NamedTuple):
    """K keyframes x N points each, one pyramid level.

    images/grad_x/grad_y: (K, H, W); T_cw: (K, 4, 4); uv: (K, N, 2) owner
    pixels; inv_depth: (K, N); intensity: (K, N) reference intensities;
    valid: (K, N)."""

    images: jax.Array
    grad_x: jax.Array
    grad_y: jax.Array
    T_cw: jax.Array
    uv: jax.Array
    inv_depth: jax.Array
    intensity: jax.Array
    valid: jax.Array


class PhotoBAResult(NamedTuple):
    T_cw: jax.Array
    inv_depth: jax.Array
    cost: jax.Array
    initial_cost: jax.Array
    iterations: jax.Array


def _observations(
    problem: PhotoBAProblem,
    cam: PinholeCamera,
    observer_idx: jax.Array | None = None,
):
    """All-pairs photometric residuals + Jacobians in one batched pass.

    observer_idx selects which GLOBAL keyframes this call observes with:
    problem.images/grad_x/grad_y then hold only those Kj observer frames
    (the distributed path shards the observer axis over the mesh; owner-side
    data stays replicated — it is tiny next to the images). None means all
    K keyframes observe (single-device, Kj == K).

    Returns r (K,Kj,N), Jp (K,Kj,N,K*6) pose Jacobian, Jd (K,Kj,N)
    inverse-depth Jacobian, valid (K,Kj,N)."""
    K, N = problem.inv_depth.shape
    T_cw = problem.T_cw
    if observer_idx is None:
        observer_idx = jnp.arange(K)
    T_cw_obs = T_cw[observer_idx]                           # (Kj, 4, 4)
    rho = jnp.maximum(problem.inv_depth, 1e-6)

    # Owner-frame points X_i = unproject(uv) / rho.
    ray = cam.unproject(problem.uv.reshape(K * N, 2),
                        jnp.ones(K * N)).reshape(K, N, 3)
    X_i = ray / rho[..., None]                              # (K, N, 3)

    # Relative transforms T_ji = T_cw[j] @ T_cw[i]^-1 for all pairs.
    T_wi = se3.inverse(T_cw)                                # (K, 4, 4)
    T_ji = jnp.einsum(
        "jab,ibc->jiac", T_cw_obs, T_wi, precision=HIGHEST
    ).transpose(1, 0, 2, 3)                                 # (i, j, 4, 4)
    R_ji = T_ji[..., :3, :3]                                # (K, Kj, 3, 3)
    t_ji = T_ji[..., :3, 3]                                 # (K, Kj, 3)

    # Observer-frame points X_j[i, j, n] = R_ji X_i + t_ji.
    X_j = (
        jnp.einsum("ijab,inb->ijna", R_ji, X_i, precision=HIGHEST)
        + t_ji[:, :, None, :]
    )                                                       # (K, K, N, 3)
    uv_j = cam.project(X_j.reshape(-1, 3)).reshape(
        K, observer_idx.shape[0], N, 2
    )

    # Sample observer intensity + gradients: group by observer j.
    Kj = observer_idx.shape[0]
    stacked = jnp.stack(
        [problem.images, problem.grad_x, problem.grad_y], axis=1
    )                                                       # (Kj, 3, H, W)
    uv_by_j = uv_j.transpose(1, 0, 2, 3).reshape(Kj, K * N, 2)
    vals, in_img = jax.vmap(bilinear_sample_dense)(stacked, uv_by_j)
    vals = vals.reshape(Kj, 3, K, N).transpose(2, 0, 3, 1)  # (i, j, n, 3)
    in_img = in_img.reshape(Kj, K, N).transpose(1, 0, 2)    # (i, j, n)
    i_t, gx, gy = vals[..., 0], vals[..., 1], vals[..., 2]

    # Exclude self-observation (global j == i).
    eye_off = jnp.arange(K)[:, None] != observer_idx[None, :]
    valid = (
        problem.valid[:, None, :]
        & in_img
        & (X_j[..., 2] > 1e-3)
        & eye_off[:, :, None]
    )
    r = jnp.where(valid, i_t - problem.intensity[:, None, :], 0.0)

    # g = image-gradient row times projection Jacobian (1x3 per obs).
    Jpi = cam.project_jacobian(X_j.reshape(-1, 3)).reshape(K, Kj, N, 2, 3)
    g = gx[..., None] * Jpi[..., 0, :] + gy[..., None] * Jpi[..., 1, :]

    # Observer pose (left update on T_cw[j]): dX_j/dxi_j = [I, -hat(X_j)].
    B_v = g
    B_w = -jnp.einsum(
        "ijnk,ijnkl->ijnl", g, so3.hat(X_j), precision=HIGHEST
    )
    B = jnp.concatenate([B_v, B_w], axis=-1)                # (K, K, N, 6)

    # Owner pose: dX_j/dxi_i = -R_ji [I, -hat(X_i)].
    gR = jnp.einsum("ijnk,ijkl->ijnl", g, R_ji, precision=HIGHEST)
    A_v = -gR
    A_w = jnp.einsum(
        "ijnk,inkl->ijnl", gR, so3.hat(X_i), precision=HIGHEST
    )
    A = jnp.concatenate([A_v, A_w], axis=-1)                # (K, K, N, 6)

    # Inverse depth: dX_j/drho = -R_ji X_i / rho.
    Jd = -jnp.einsum(
        "ijnk,ink->ijn", gR, X_i / rho[..., None], precision=HIGHEST
    )

    # Assemble the K*6 pose Jacobian without scatter: one-hot slot selectors
    # (the observer's selector row maps its LOCAL j to its GLOBAL slot).
    I_K = jnp.eye(K, dtype=A.dtype)
    sel_obs = I_K[observer_idx]                             # (Kj, K)
    Jp = (
        jnp.einsum("ijnd,ik->ijnkd", A, I_K)
        + jnp.einsum("ijnd,jk->ijnkd", B, sel_obs)
    ).reshape(K, Kj, N, K * 6)

    m = valid[..., None]
    return r, jnp.where(m, Jp, 0.0), jnp.where(valid, Jd, 0.0), valid


def _huber_w(r, valid, delta):
    w = jnp.minimum(1.0, delta / jnp.abs(r).clip(1e-12))
    return jnp.where(valid, w, 0.0)


def _cost(r, valid, delta):
    # Huber rho(r) averaged over valid observations.
    a = jnp.abs(r)
    rho = jnp.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return jnp.sum(jnp.where(valid, rho, 0.0)) / jnp.maximum(
        jnp.sum(valid), 1
    )


class _State(NamedTuple):
    T_cw: jax.Array
    inv_depth: jax.Array
    cost: jax.Array
    lam: jax.Array
    k: jax.Array
    done: jax.Array


@partial(
    jax.jit,
    static_argnames=("cam", "max_iters", "optimize_depths"),
)
def photometric_bundle_adjust(
    problem: PhotoBAProblem,
    cam: PinholeCamera,
    max_iters: int = 12,
    huber_delta: float = 12.0,
    pose0_weight: float = 1e8,
    depth_prior: float = 1e-2,
    init_lambda: float = 1e-3,
    optimize_depths: bool = True,
) -> PhotoBAResult:
    """Joint LM over {T_cw} and {inverse depths} with Schur elimination of
    the (diagonal) depth block. Keyframe 0 is the gauge anchor."""
    K, N = problem.inv_depth.shape

    def cost_at(T_cw, inv_depth):
        p = problem._replace(T_cw=T_cw, inv_depth=inv_depth)
        r, _, _, valid = _observations(p, cam)
        return _cost(r, valid, huber_delta)

    def step(T_cw, inv_depth, lam):
        p = problem._replace(T_cw=T_cw, inv_depth=inv_depth)
        r, Jp, Jd, valid = _observations(p, cam)
        w = _huber_w(r, valid, huber_delta)
        wr = w * r

        Hpp = jnp.einsum("ijnp,ijnq->pq", w[..., None] * Jp, Jp,
                         precision=HIGHEST)
        bp = -jnp.einsum("ijnp,ijn->p", Jp, wr, precision=HIGHEST)
        # Gauge: strong prior pinning keyframe 0's 6-dof block.
        gauge = jnp.zeros(K * 6).at[:6].set(pose0_weight)
        Hpp = Hpp + jnp.diag(gauge)
        Hpp = Hpp + lam * jnp.diag(jnp.diag(Hpp)) + 1e-6 * jnp.eye(K * 6)

        if optimize_depths:
            Hpd = jnp.einsum("ijnp,ijn->pin", w[..., None] * Jp, Jd,
                             precision=HIGHEST)          # (K6, K, N)
            Hdd = jnp.einsum("ijn,ijn->in", w * Jd, Jd,
                             precision=HIGHEST)          # (K, N)
            bd = -jnp.einsum("ijn,ijn->in", Jd, wr, precision=HIGHEST)
            Hdd = Hdd * (1.0 + lam) + depth_prior
            Hdd_inv = 1.0 / jnp.maximum(Hdd, 1e-12)
            S = Hpp - jnp.einsum(
                "pin,in,qin->pq", Hpd, Hdd_inv, Hpd, precision=HIGHEST
            )
            rhs = bp - jnp.einsum(
                "pin,in,in->p", Hpd, Hdd_inv, bd, precision=HIGHEST
            )
            dp = jnp.linalg.solve(S, rhs)
            dd = Hdd_inv * (
                bd - jnp.einsum("pin,p->in", Hpd, dp, precision=HIGHEST)
            )
        else:
            dp = jnp.linalg.solve(Hpp, bp)
            dd = jnp.zeros_like(inv_depth)

        dp = dp.reshape(K, 6)
        T_new = jax.vmap(
            lambda d, T: se3.normalize(se3.compose(se3.exp(d), T))
        )(dp, T_cw)
        depth_new = jnp.maximum(inv_depth + dd, 1e-4)
        ok = jnp.all(jnp.isfinite(dp)) & jnp.all(jnp.isfinite(dd))
        return jnp.where(ok, T_new, T_cw), jnp.where(
            ok, depth_new, inv_depth
        ), ok

    c0 = cost_at(problem.T_cw, problem.inv_depth)

    def body(s: _State):
        T_new, d_new, ok = step(s.T_cw, s.inv_depth, s.lam)
        c_new = cost_at(T_new, d_new)
        accept = ok & jnp.isfinite(c_new) & (c_new < s.cost)
        return _State(
            T_cw=jnp.where(accept, T_new, s.T_cw),
            inv_depth=jnp.where(accept, d_new, s.inv_depth),
            cost=jnp.where(accept, c_new, s.cost),
            lam=jnp.where(accept, s.lam * 0.5, s.lam * 4.0).clip(1e-8, 1e4),
            k=s.k + 1,
            done=(s.lam > 1e3)
            | (accept & (jnp.abs(s.cost - c_new) < 1e-7 * (s.cost + 1e-9))),
        )

    init = _State(
        T_cw=problem.T_cw,
        inv_depth=problem.inv_depth,
        cost=c0,
        lam=jnp.asarray(init_lambda),
        k=jnp.asarray(0),
        done=jnp.asarray(False),
    )
    out = jax.lax.while_loop(
        lambda s: (~s.done) & (s.k < max_iters), body, init
    )
    return PhotoBAResult(
        T_cw=out.T_cw,
        inv_depth=out.inv_depth,
        cost=out.cost,
        initial_cost=c0,
        iterations=out.k,
    )


def photo_ba_problem_from_keyframes(
    pyramids, T_cw, points, level: int = 1
) -> PhotoBAProblem:
    """Convenience builder: K keyframe pyramids + level-0 TrackPoints ->
    a PhotoBAProblem at the given pyramid level (coarser levels are cheaper
    and smoother; DSO runs its window on downscaled pyramids too).

    Pass cam.scaled(level) to photometric_bundle_adjust — uv and intrinsics
    must live at the same level."""
    scale = 1.0 / (1 << level)
    images = jnp.stack([p.images[level] for p in pyramids])
    gx = jnp.stack([p.grad_x[level] for p in pyramids])
    gy = jnp.stack([p.grad_y[level] for p in pyramids])
    uv = jnp.stack([pt.uv for pt in points]) * scale
    inv_depth = jnp.stack(
        [1.0 / jnp.maximum(pt.p3d[:, 2], 1e-6) for pt in points]
    )
    K_, N = inv_depth.shape
    # Reference intensity re-sampled at this level for consistency.
    intensity = jax.vmap(
        lambda im, u: bilinear_sample_dense(im[None], u)[0][0]
    )(images, uv)
    valid = jnp.stack([pt.valid for pt in points])
    return PhotoBAProblem(
        images=images, grad_x=gx, grad_y=gy,
        T_cw=jnp.stack([jnp.asarray(t) for t in T_cw]),
        uv=uv, inv_depth=inv_depth, intensity=intensity, valid=valid,
    )
