"""Sliding-window bundle adjustment: Schur complement, LM, batched on-device.

The reference *intended* BA — it links Ceres and ships commented-out
ResidualIntensity/LocalParameterizationSE3 scaffolding
(/root/reference/include/Tracker.h:295-505, src/Tracker.cpp:1742-1817) that
was never finished. This module supplies it for real, as batched arrays
(SURVEY.md §7 layer 7):

- Fixed-capacity observation table (obs -> (kf, lm, uv, valid)) instead of
  sparse graphs; invalid slots carry zero weight.
- All per-observation Jacobians in one batched pass; normal-equation blocks
  accumulated with segment_sum (XLA scatter-add).
- Landmark (3x3) blocks inverted in closed form; the reduced camera system
  S = U - W V^-1 W^T is built by one einsum over landmarks and solved densely
  (the window is small: 6M x 6M) under a Levenberg-Marquardt loop with
  gauge fixing on keyframe 0.

Pose convention: T_cw (camera-from-world), left-multiplicative update
exp(delta) * T_cw, twist [v, w].
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..camera.model import PinholeCamera
from ..lie import se3, so3
from ..utils.precision import HIGHEST


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. M keyframes, L landmarks, O observations."""

    T_cw: jax.Array       # (M, 4, 4) camera-from-world poses
    points: jax.Array     # (L, 3) world landmarks
    obs_kf: jax.Array     # (O,) int32 keyframe index
    obs_lm: jax.Array     # (O,) int32 landmark index
    obs_uv: jax.Array     # (O, 2) measured pixel coords
    obs_valid: jax.Array  # (O,) bool


class BAResult(NamedTuple):
    T_cw: jax.Array
    points: jax.Array
    cost: jax.Array        # final mean robust cost
    initial_cost: jax.Array
    iterations: jax.Array


def reproject_residuals(
    problem: BAProblem, cam: PinholeCamera
) -> tuple[jax.Array, jax.Array]:
    """Residuals (O, 2) and validity (O,) for the current state."""
    T = problem.T_cw[problem.obs_kf]               # (O, 4, 4)
    X = problem.points[problem.obs_lm]             # (O, 3)
    p_c = se3.apply(T, X)
    uv_hat = cam.project(p_c)
    r = uv_hat - problem.obs_uv
    valid = problem.obs_valid & (p_c[..., 2] > 1e-3)
    return jnp.where(valid[:, None], r, 0.0), valid


def _obs_jacobians(problem: BAProblem, cam: PinholeCamera):
    """Per-observation A (2,6) pose and B (2,3) point Jacobians + residuals."""
    T = problem.T_cw[problem.obs_kf]
    X = problem.points[problem.obs_lm]
    p_c = se3.apply(T, X)
    uv_hat = cam.project(p_c)
    r = uv_hat - problem.obs_uv
    valid = problem.obs_valid & (p_c[..., 2] > 1e-3)

    Jp = cam.project_jacobian(p_c)                       # (O, 2, 3)
    # Left update exp(delta) T: dp_c/ddelta = [I | -hat(p_c)].
    A_t = Jp                                             # translation block
    A_w = jnp.einsum(
        "oij,ojk->oik", Jp, -so3.hat(p_c), precision=HIGHEST
    )
    A = jnp.concatenate([A_t, A_w], axis=-1)             # (O, 2, 6)
    R = se3.rotation(T)
    B = jnp.einsum("oij,ojk->oik", Jp, R, precision=HIGHEST)  # (O, 2, 3)

    m = valid[:, None, None]
    return (
        jnp.where(m, A, 0.0),
        jnp.where(m, B, 0.0),
        jnp.where(valid[:, None], r, 0.0),
        valid,
    )


def _huber_weights(r: jax.Array, valid: jax.Array, delta: float) -> jax.Array:
    """Per-observation Huber IRLS weight on the residual norm."""
    nrm = jnp.linalg.norm(r, axis=-1)
    w = jnp.minimum(1.0, delta / jnp.maximum(nrm, 1e-9))
    return jnp.where(valid, w, 0.0)


def _robust_cost(r: jax.Array, valid: jax.Array, delta: float) -> jax.Array:
    """Mean Huber cost (for LM accept/reject)."""
    nrm = jnp.linalg.norm(r, axis=-1)
    quad = 0.5 * nrm * nrm
    lin = delta * (nrm - 0.5 * delta)
    c = jnp.where(nrm <= delta, quad, lin)
    n = jnp.maximum(valid.sum(), 1)
    return jnp.where(valid, c, 0.0).sum() / n


def _inv3x3(M: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def build_normal_equations(
    problem: BAProblem, cam: PinholeCamera, huber_delta: float = 2.0
):
    """One batched pass -> (U (M,6,6), V (L,3,3), W (L,M,6,3),
    g_p (M,6), g_l (L,3), cost)."""
    M = problem.T_cw.shape[0]
    L = problem.points.shape[0]
    A, B, r, valid = _obs_jacobians(problem, cam)
    w = _huber_weights(r, valid, huber_delta)

    wA = w[:, None, None] * A
    # Per-observation blocks.
    AtA = jnp.einsum("oia,oib->oab", wA, A, precision=HIGHEST)   # (O, 6, 6)
    BtB = jnp.einsum("oia,oib->oab", w[:, None, None] * B, B,
                     precision=HIGHEST)                           # (O, 3, 3)
    AtB = jnp.einsum("oia,oib->oab", wA, B, precision=HIGHEST)   # (O, 6, 3)
    Atr = jnp.einsum("oia,oi->oa", wA, r, precision=HIGHEST)     # (O, 6)
    Btr = jnp.einsum("oia,oi->oa", w[:, None, None] * B, r,
                     precision=HIGHEST)                           # (O, 3)

    U = jax.ops.segment_sum(AtA, problem.obs_kf, num_segments=M)
    V = jax.ops.segment_sum(BtB, problem.obs_lm, num_segments=L)
    pair = problem.obs_lm * M + problem.obs_kf
    W = jax.ops.segment_sum(AtB, pair, num_segments=L * M).reshape(L, M, 6, 3)
    g_p = -jax.ops.segment_sum(Atr, problem.obs_kf, num_segments=M)
    g_l = -jax.ops.segment_sum(Btr, problem.obs_lm, num_segments=L)
    cost = _robust_cost(r, valid, huber_delta)
    return U, V, W, g_p, g_l, cost


def solve_schur(
    U, V, W, g_p, g_l, lam, fix_first_pose: bool = True,
    num_fixed_poses: int = 1,
):
    """Schur-complement solve -> (delta_poses (M,6), delta_points (L,3)).

    S = U + lam*I - W V_damped^-1 W^T ; S dp = g_p - W V^-1 g_l ;
    dl = V^-1 (g_l - W^T dp).

    num_fixed_poses: gauge anchors. 1 fixes the 6-dof frame gauge; monocular
    windows should use 2 so the free scale direction is anchored too."""
    M = U.shape[0]
    L = V.shape[0]
    eye3 = jnp.eye(3, dtype=V.dtype)
    eye6 = jnp.eye(6, dtype=U.dtype)
    V_d = V + lam * eye3[None] * jnp.maximum(
        jnp.diagonal(V, axis1=-2, axis2=-1).mean(-1)[:, None, None], 1e-6
    )
    Vinv = _inv3x3(V_d)

    WVinv = jnp.einsum("lmab,lbc->lmac", W, Vinv, precision=HIGHEST)  # (L,M,6,3)
    # Reduced camera matrix: (M,6,M,6).
    S_red = jnp.einsum("lmac,lnbc->manb", WVinv, W, precision=HIGHEST)
    U_d = U + lam * eye6[None] * jnp.maximum(
        jnp.diagonal(U, axis1=-2, axis2=-1).mean(-1)[:, None, None], 1e-6
    )
    S = jnp.zeros((M, 6, M, 6), U.dtype)
    idx = jnp.arange(M)
    S = S.at[idx, :, idx, :].set(U_d)
    S = S - S_red
    rhs = g_p - jnp.einsum("lmac,lc->ma", WVinv, g_l, precision=HIGHEST)

    if fix_first_pose:
        # Gauge fixing: zero rows/cols of the anchored poses, identity diag.
        for a in range(max(1, num_fixed_poses)):
            S = S.at[a].set(0.0).at[:, :, a].set(0.0)
            S = S.at[a, :, a, :].set(jnp.eye(6, dtype=S.dtype))
            rhs = rhs.at[a].set(0.0)

    Sd = S.reshape(M * 6, M * 6)
    dp = jnp.linalg.solve(
        Sd + 1e-8 * jnp.eye(M * 6, dtype=Sd.dtype), rhs.reshape(-1)
    ).reshape(M, 6)

    dl = jnp.einsum(
        "lab,lb->la",
        Vinv,
        g_l - jnp.einsum("lmab,ma->lb", W, dp, precision=HIGHEST),
        precision=HIGHEST,
    )
    return dp, dl


class _BAState(NamedTuple):
    T_cw: jax.Array
    points: jax.Array
    lam: jax.Array
    cost: jax.Array
    k: jax.Array
    done: jax.Array


@partial(
    jax.jit,
    static_argnames=(
        "cam", "max_iters", "fix_first_pose", "trim_px", "num_fixed_poses",
        "pose_prior_weight",
    ),
)
def bundle_adjust(
    problem: BAProblem,
    cam: PinholeCamera,
    max_iters: int = 20,
    huber_delta: float = 2.0,
    init_lambda: float = 1e-3,
    fix_first_pose: bool = True,
    trim_px: float | None = 10.0,
    num_fixed_poses: int = 1,
    pose_prior_weight: float = 0.0,
) -> BAResult:
    """LM bundle adjustment over the window. Returns refined poses/points.

    If trim_px is set, observations whose residual norm exceeds it after the
    first LM convergence are invalidated and a second LM pass refines without
    them (gross-outlier rejection beyond Huber's linear influence).

    pose_prior_weight > 0 adds a diagonal prior anchoring each pose to its
    INITIAL value (residual log(T_cur T_init^-1), J = I for left updates).
    Use when the initial odometry is trusted: it pins the weakly-constrained
    directions of short planar/small-baseline windows without blocking
    well-observed corrections."""


    T_init_prior = problem.T_cw

    def _apply_pose_prior(U, g_p, T_cur):
        if pose_prior_weight <= 0.0:
            return U, g_p
        r_prior = jax.vmap(
            lambda Tc, Ti: se3.log(se3.compose(Tc, se3.inverse(Ti)))
        )(T_cur, T_init_prior)
        U = U + pose_prior_weight * jnp.eye(6, dtype=U.dtype)[None]
        g_p = g_p - pose_prior_weight * r_prior
        return U, g_p

    def cost_at(T_cw, points):
        p = problem._replace(T_cw=T_cw, points=points)
        r, valid = reproject_residuals(p, cam)
        c = _robust_cost(r, valid, huber_delta)
        if pose_prior_weight > 0.0:
            r_prior = jax.vmap(
                lambda Tc, Ti: se3.log(se3.compose(Tc, se3.inverse(Ti)))
            )(T_cw, T_init_prior)
            c = c + 0.5 * pose_prior_weight * jnp.mean(
                jnp.sum(r_prior * r_prior, axis=-1)
            )
        return c

    def cond(s: _BAState):
        return (~s.done) & (s.k < max_iters)

    def body(s: _BAState):
        p = problem._replace(T_cw=s.T_cw, points=s.points)
        U, V, W, g_p, g_l, cost = build_normal_equations(p, cam, huber_delta)
        U, g_p = _apply_pose_prior(U, g_p, s.T_cw)
        cost = cost_at(s.T_cw, s.points)
        dp, dl = solve_schur(
            U, V, W, g_p, g_l, s.lam, fix_first_pose, num_fixed_poses
        )
        T_new = jax.vmap(lambda T, d: se3.normalize(se3.compose(se3.exp(d), T)))(
            s.T_cw, dp
        )
        pts_new = s.points + dl
        new_cost = cost_at(T_new, pts_new)
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        step = jnp.sqrt(jnp.sum(dp * dp) + jnp.sum(dl * dl))
        return _BAState(
            T_cw=jnp.where(accept, T_new, s.T_cw),
            points=jnp.where(accept, pts_new, s.points),
            lam=jnp.where(accept, s.lam * 0.3, s.lam * 5.0).clip(1e-9, 1e6),
            cost=jnp.where(accept, new_cost, cost),
            k=s.k + 1,
            done=(accept & (step < 1e-6)) | (s.lam > 1e5),
        )

    c0 = cost_at(problem.T_cw, problem.points)
    init = _BAState(
        T_cw=problem.T_cw,
        points=problem.points,
        lam=jnp.asarray(init_lambda, jnp.float32),
        cost=c0,
        k=jnp.asarray(0),
        done=jnp.asarray(False),
    )
    out = jax.lax.while_loop(cond, body, init)

    if trim_px is not None:
        # Gross-outlier trim: invalidate observations far off after the first
        # convergence, then refine. Huber bounds influence only linearly;
        # trimming removes it entirely.
        p1 = problem._replace(T_cw=out.T_cw, points=out.points)
        r, valid = reproject_residuals(p1, cam)
        keep = valid & (jnp.linalg.norm(r, axis=-1) < trim_px)
        trimmed = problem._replace(obs_valid=problem.obs_valid & keep)

        def cost_at2(T_cw, points):
            p = trimmed._replace(T_cw=T_cw, points=points)
            r2, v2 = reproject_residuals(p, cam)
            return _robust_cost(r2, v2, huber_delta)

        def body2(s: _BAState):
            p = trimmed._replace(T_cw=s.T_cw, points=s.points)
            U, V, W, g_p, g_l, cost = build_normal_equations(
                p, cam, huber_delta
            )
            U, g_p = _apply_pose_prior(U, g_p, s.T_cw)
            cost = cost_at2(s.T_cw, s.points)
            dp, dl = solve_schur(
                U, V, W, g_p, g_l, s.lam, fix_first_pose, num_fixed_poses
            )
            T_new = jax.vmap(
                lambda T, d: se3.normalize(se3.compose(se3.exp(d), T))
            )(s.T_cw, dp)
            pts_new = s.points + dl
            new_cost = cost_at2(T_new, pts_new)
            accept = (new_cost < cost) & jnp.isfinite(new_cost)
            step = jnp.sqrt(jnp.sum(dp * dp) + jnp.sum(dl * dl))
            return _BAState(
                T_cw=jnp.where(accept, T_new, s.T_cw),
                points=jnp.where(accept, pts_new, s.points),
                lam=jnp.where(accept, s.lam * 0.3, s.lam * 5.0).clip(1e-9, 1e6),
                cost=jnp.where(accept, new_cost, cost),
                k=s.k + 1,
                done=(accept & (step < 1e-6)) | (s.lam > 1e5),
            )

        init2 = _BAState(
            T_cw=out.T_cw,
            points=out.points,
            lam=jnp.asarray(init_lambda, jnp.float32),
            cost=cost_at2(out.T_cw, out.points),
            k=out.k,
            done=jnp.asarray(False),
        )
        out = jax.lax.while_loop(
            lambda s: (~s.done) & (s.k < 2 * max_iters), body2, init2
        )

    return BAResult(
        T_cw=out.T_cw,
        points=out.points,
        cost=out.cost,
        initial_cost=c0,
        iterations=out.k,
    )
