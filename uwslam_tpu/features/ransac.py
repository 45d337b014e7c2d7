"""Masked, vmapped RANSAC for fundamental/essential matrices.

Mirrors the reference's geometric verification
(/root/reference/src/Tracker.cpp:105-169: findFundamentalMat RANSAC, distance
3.0 px, confidence 0.99, optional 8-point refit on inliers) and the standalone
five-point essential pipeline (src/feature_detector.cpp:262-269) — batched:

- a FIXED batch of hypotheses evaluated in parallel with vmap (no sequential
  adaptive termination: the hypothesis batch is sized for the 0.99-confidence
  worst case up front, so control flow is static);
- each hypothesis is a Hartley-normalized 8-point solve; the batched SVDs and
  the Sampson-distance inlier counts are dense linear algebra XLA maps well;
- invalid matches are masked out of sampling (Gumbel top-k over the validity
  mask) and of inlier counts.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..lie import so3
from ..utils.precision import HIGHEST
from ..utils.linalg import cholesky_solve_unrolled, smallest_eigvec_spd

RANSAC_THRESH_PX = 3.0   # reference src/Tracker.cpp:150
NUM_HYPOTHESES = 256     # > log(1-0.99)/log(1-0.5^8) ≈ 1177 for 50% outliers;
                         # 256 covers ~35% outliers, post-ratio-test typical


class RansacResult(NamedTuple):
    F: jax.Array           # (3, 3) best model (fundamental or essential)
    inliers: jax.Array     # (K,) bool
    num_inliers: jax.Array
    ok: jax.Array          # bool: enough inliers found


def _normalize_points(uv: jax.Array, valid: jax.Array):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(w.sum(), 1.0)
    mean = (uv * w[:, None]).sum(0) / n
    d = jnp.linalg.norm(uv - mean, axis=-1)
    scale = jnp.sqrt(2.0) / jnp.maximum((d * w).sum() / n, 1e-6)
    T = jnp.array(
        [
            [scale, 0.0, -scale * mean[0]],
            [0.0, scale, -scale * mean[1]],
            [0.0, 0.0, 1.0],
        ],
        dtype=jnp.float32,
    )
    return (uv - mean) * scale, T


def _eight_point(pa: jax.Array, pb: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted 8-point: rows w_i * [xb*xa, xb*ya, xb, yb*xa, yb*ya, yb, xa, ya, 1].

    pa/pb: (M, 2) normalized coords, w: (M,) weights. Returns (3, 3) F with
    rank-2 enforcement."""
    xa, ya = pa[:, 0], pa[:, 1]
    xb, yb = pb[:, 0], pb[:, 1]
    one = jnp.ones_like(xa)
    A = jnp.stack(
        [xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya, one], axis=-1
    ) * w[:, None]
    # min |Af|: eigenvector of A^T A with smallest eigenvalue.
    AtA = jnp.einsum("mi,mj->ij", A, A, precision=HIGHEST)
    f = smallest_eigvec_spd(AtA)
    F = f.reshape(3, 3)
    # Rank-2 enforcement WITHOUT an SVD: F = U S V^T => F v3 = s3 u3, so
    # dropping the smallest singular value is F (I - v3 v3^T) with v3 the
    # smallest eigenvector of F^T F.
    _, Vf = jnp.linalg.eigh(jnp.einsum("ji,jk->ik", F, F, precision=HIGHEST))
    v3 = Vf[:, 0]
    return F - jnp.outer(F @ v3, v3)


def sampson_distance(F: jax.Array, uv_a: jax.Array, uv_b: jax.Array):
    """First-order geometric (Sampson) distance per correspondence (K,)."""
    ones = jnp.ones_like(uv_a[:, :1])
    xa = jnp.concatenate([uv_a, ones], axis=-1)  # (K, 3)
    xb = jnp.concatenate([uv_b, ones], axis=-1)
    Fxa = xa @ F.T  # rows are (F @ xa): the epipolar line in image b
    Ftxb = xb @ F   # rows F^T xb
    num = jnp.sum(xb * Fxa, axis=-1) ** 2
    den = Fxa[:, 0] ** 2 + Fxa[:, 1] ** 2 + Ftxb[:, 0] ** 2 + Ftxb[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def _project_essential(F: jax.Array) -> jax.Array:
    """Project onto the essential manifold: singular values -> (s, s, 0)."""
    U, S, Vt = jnp.linalg.svd(F)
    s = 0.5 * (S[0] + S[1])
    return (U * jnp.array([s, s, 0.0])[None, :]) @ Vt


def _decompose_rt(E: jax.Array):
    """One (R, t) with [t]x R proportional to E (Sampson is sign-invariant,
    so any of the four decompositions parameterizes the same manifold point)."""
    U, _, Vt = jnp.linalg.svd(E)
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U[:, 2]


def _gn_polish_essential(
    R0: jax.Array,
    t0: jax.Array,
    xy_a: jax.Array,
    xy_b: jax.Array,
    valid: jax.Array,
    t2: float,
    iters: int = 8,
):
    """Gauss-Newton on the essential manifold (5 dof: so(3) x tangent(S^2))
    minimizing robustly-weighted Sampson residuals.

    The 8-point + singular-value-projection pipeline is not a descent method
    on geometric error and fails on near-planar scenes (the reason Nister's
    5-point exists); a batched manifold GN from several starts is the
    array substitute: tiny dense solves, static shapes, vmappable."""
    ones = jnp.ones_like(xy_a[:, :1])
    ha = jnp.concatenate([xy_a, ones], axis=-1)
    hb = jnp.concatenate([xy_b, ones], axis=-1)
    vw = valid.astype(jnp.float32)

    def basis_perp(t):
        # Two unit vectors spanning t^perp (branch on the smallest component).
        a = jnp.where(jnp.abs(t[0]) < 0.9,
                      jnp.array([1.0, 0.0, 0.0]),
                      jnp.array([0.0, 1.0, 0.0]))
        b1 = jnp.cross(t, a)
        b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
        b2 = jnp.cross(t, b1)
        return b1, b2

    def residuals(R, t):
        E = so3.hat(t) @ R
        Ex = ha @ E.T       # (K,3) rows E @ xa
        Etx = hb @ E        # rows E^T xb
        num = jnp.sum(hb * Ex, axis=-1)
        den = jnp.sqrt(
            Ex[:, 0] ** 2 + Ex[:, 1] ** 2 + Etx[:, 0] ** 2 + Etx[:, 1] ** 2
            + 1e-18
        )
        return num / den  # signed Sampson residual; r^2 = Sampson distance

    def score(R, t):
        d = residuals(R, t) ** 2
        return jnp.where(valid, jnp.minimum(d, t2), 0.0).sum()

    def step(carry, _):
        R, t, best_R, best_t, best_s = carry
        b1, b2 = basis_perp(t)

        def r_of(theta):
            w, a = theta[:3], theta[3:]
            Rn = R @ so3.exp(w)
            tn = t + a[0] * b1 + a[1] * b2
            tn = tn / jnp.maximum(jnp.linalg.norm(tn), 1e-12)
            return residuals(Rn, tn)

        theta0 = jnp.zeros(5)
        r = r_of(theta0)
        J = jax.jacfwd(r_of)(theta0)  # (K, 5)
        d = r ** 2
        wrob = vw * jnp.where(d < t2, 1.0 / (1.0 + d / t2), 0.0)
        A = jnp.einsum("ki,k,kj->ij", J, wrob, J, precision=HIGHEST)
        g = jnp.einsum("ki,k->i", J, wrob * r, precision=HIGHEST)
        # Unrolled Cholesky (utils.linalg): elementwise math that fuses
        # across the vmapped hypotheses. A + ridge is SPD.
        delta = -cholesky_solve_unrolled(
            A + 1e-8 * jnp.eye(5) + 1e-10 * jnp.trace(A) * jnp.eye(5), g
        )
        w, a = delta[:3], delta[3:]
        Rn = R @ so3.exp(w)
        tn = t + a[0] * b1 + a[1] * b2
        tn = tn / jnp.maximum(jnp.linalg.norm(tn), 1e-12)
        s = score(Rn, tn)
        better = s <= best_s
        best_R = jnp.where(better, Rn, best_R)
        best_t = jnp.where(better, tn, best_t)
        best_s = jnp.where(better, s, best_s)
        return (Rn, tn, best_R, best_t, best_s), None

    s0 = score(R0, t0)
    (Rl, tl, bR, bt, bs), _ = jax.lax.scan(
        step, (R0, t0, R0, t0, s0), None, length=iters
    )
    E = so3.hat(bt) @ bR
    return E / jnp.maximum(jnp.linalg.norm(E), 1e-12), bs


def _ransac_core(
    uv_a: jax.Array,
    uv_b: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    threshold: float,
    num_hypotheses: int,
    min_inliers: int,
    essential: bool,
) -> RansacResult:
    """RANSAC F/E matrix with MSAC scoring and iterated inlier refit.

    uv_a/uv_b: (K, 2) matched pixel coords; valid: (K,) mask. When
    `essential`, every hypothesis is projected onto the essential manifold
    BEFORE scoring — projecting only the winning fundamental matrix after
    selection can turn the best-scoring F into a badly wrong E."""
    K = uv_a.shape[0]
    pa_n, Ta = _normalize_points(uv_a, valid)
    pb_n, Tb = _normalize_points(uv_b, valid)

    # Sample 8 valid indices per hypothesis: Gumbel top-k over the mask.
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (num_hypotheses, K), minval=1e-9, maxval=1.0)
    ))
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    _, sample_idx = jax.lax.top_k(scores, 8)  # (H, 8)

    def solve_one(idx):
        return _eight_point(pa_n[idx], pb_n[idx], jnp.ones((8,)))

    Fs_n = jax.vmap(solve_one)(sample_idx)  # (H, 3, 3) in normalized coords

    # Denormalize: F = Tb^T Fn Ta ; Sampson threshold applies in pixels.
    Fs = jnp.einsum("ji,hjk,kl->hil", Tb, Fs_n, Ta, precision=HIGHEST)
    if essential:
        Fs = jax.vmap(_project_essential)(Fs)

    # MSAC scoring: sum of truncated squared Sampson distances. Binary
    # inlier counting is too coarse — a wrong model that barely absorbs one
    # extra outlier beats the true model; truncated residuals discriminate.
    t2 = threshold * threshold

    def msac(F):
        d = sampson_distance(F, uv_a, uv_b)
        inl = valid & (d < t2)
        score = jnp.where(valid, jnp.minimum(d, t2), 0.0).sum()
        return inl, score

    _, scores_h = jax.vmap(msac)(Fs)

    # Locally-optimized RANSAC: independently refit the top-k minimal
    # hypotheses with IRLS (Sampson-weighted 8-point + per-step essential
    # projection), then pick the best final model. A single refit chain from
    # the single best minimal sample can stay in a wrong basin — algebraic
    # LSQ + blunt essential projection is not a descent step on the MSAC
    # objective, so several starts are needed.
    k = min(8, num_hypotheses)
    _, top_idx = jax.lax.top_k(-scores_h, k)

    def refine(F0):
        def chain(carry, _):
            F, best_F, best_score = carry
            d = sampson_distance(F, uv_a, uv_b)
            w = jnp.where(valid & (d < t2), 1.0 / (1.0 + d / t2), 0.0)
            F_new = Tb.T @ _eight_point(pa_n, pb_n, w) @ Ta
            if essential:
                F_new = _project_essential(F_new)
            _, score = msac(F_new)
            better = score <= best_score
            best_F = jnp.where(better, F_new, best_F)
            best_score = jnp.where(better, score, best_score)
            return (F_new, best_F, best_score), None

        _, s0 = msac(F0)
        (F_last, best_F, best_score), _ = jax.lax.scan(
            chain, (F0, F0, s0), None, length=3
        )
        return best_F, best_score

    F_ref, score_ref = jax.vmap(refine)(Fs[top_idx])

    if essential:
        # Manifold GN polish. Near-planar scenes have TWO strong local minima
        # (the homography two-fold ambiguity) that can be far apart on the
        # t-sphere, so local perturbation is not enough: polish from each
        # refined model AND from a deterministic global grid of translation
        # directions crossed with both decomposition rotations of the best
        # model, then keep the best final score.
        Rs, ts = jax.vmap(_decompose_rt)(F_ref)
        jbest = jnp.argmax(-score_ref)
        U, _, Vt = jnp.linalg.svd(F_ref[jbest])
        U = U * jnp.sign(jnp.linalg.det(U))
        Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
        W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        # Both decomposition rotations of the best model, plus identity —
        # frame-to-frame VO has near-identity rotation, and GN needs a start
        # with roughly-correct R to descend into the true basin.
        R_cands = jnp.stack([U @ W @ Vt, U @ W.T @ Vt, jnp.eye(3)])
        # 10 directions: icosahedron-vertex half (antipodes are equivalent).
        phi = 1.618034
        t_grid = jnp.array(
            [
                [0.0, 1.0, phi], [0.0, 1.0, -phi],
                [1.0, phi, 0.0], [1.0, -phi, 0.0],
                [phi, 0.0, 1.0], [-phi, 0.0, 1.0],
                [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                [1.0, 1.0, 1.0],
            ]
        )
        t_grid = t_grid / jnp.linalg.norm(t_grid, axis=-1, keepdims=True)
        R_pert = jnp.repeat(R_cands, t_grid.shape[0], axis=0)  # (30, 3, 3)
        t_pert = jnp.tile(t_grid, (R_cands.shape[0], 1))       # (30, 3)
        R_all = jnp.concatenate([Rs, R_pert], axis=0)
        t_all = jnp.concatenate([ts, t_pert], axis=0)
        F_pol, score_pol = jax.vmap(
            lambda R, t: _gn_polish_essential(R, t, uv_a, uv_b, valid, t2)
        )(R_all, t_all)
        F_ref = jnp.concatenate([F_ref, F_pol], axis=0)
        score_ref = jnp.concatenate([score_ref, score_pol], axis=0)

    j = jnp.argmax(-score_ref)
    F_final = F_ref[j]
    inliers, _ = msac(F_final)
    n = inliers.sum()
    return RansacResult(
        F=F_final / jnp.maximum(jnp.abs(F_final[2, 2]), 1e-12),
        inliers=inliers,
        num_inliers=n,
        ok=n >= min_inliers,
    )


@partial(jax.jit, static_argnames=("num_hypotheses", "min_inliers"))
def fundamental_ransac(
    uv_a: jax.Array,
    uv_b: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    threshold: float = RANSAC_THRESH_PX,
    num_hypotheses: int = NUM_HYPOTHESES,
    min_inliers: int = 15,
) -> RansacResult:
    """RANSAC fundamental matrix on pixel coords (reference's
    findFundamentalMat verification, src/Tracker.cpp:105-169)."""
    return _ransac_core(
        uv_a, uv_b, valid, key, threshold, num_hypotheses, min_inliers,
        essential=False,
    )


@partial(jax.jit, static_argnames=("num_hypotheses", "min_inliers"))
def essential_ransac(
    xy_a: jax.Array,
    xy_b: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    threshold_norm: float = 3.0 / 500.0,
    num_hypotheses: int = NUM_HYPOTHESES,
    min_inliers: int = 15,
) -> RansacResult:
    """Essential matrix RANSAC on NORMALIZED camera coords (x, y) = K^-1 u.

    8-point solve + per-hypothesis projection onto the essential manifold
    (the reference's five-point cv::findEssentialMat at
    src/feature_detector.cpp:262-265 serves the same role; 8-point on
    normalized coords is SVD-batched and shape-static)."""
    return _ransac_core(
        xy_a, xy_b, valid, key, threshold_norm, num_hypotheses, min_inliers,
        essential=True,
    )
