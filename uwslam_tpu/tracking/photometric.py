"""Direct photometric pose tracking over SE(3) — the framework's hot path.

Re-imagines the reference's Gauss-Newton pose estimators
(/root/reference/src/Tracker.cpp:362-1122: EstimatePose /
EstimatePoseFeatures / FastEstimatePose) as one fused, jitted,
coarse-to-fine Levenberg-Marquardt program:

- The reference's per-point push_back loop (src/Tracker.cpp:706-764, the #1
  hot spot) becomes a single batched warp->sample->residual->Jacobian pass;
  the normal equations H = J^T W J, b = -J^T W r are one (6,N)x(N,6) einsum.
- Its ad-hoc damping hacks (residual x50 at :563, z_factor at :738,
  quaternion-doubling level upscaling at :580-590) are replaced by proper LM
  trust-region damping; termination mirrors :508/:783 (error increase,
  |delta| < eps, max iters) inside a lax.while_loop.
- Forward-compositional update T <- T * exp(delta) (:849) with gradients
  sampled in the *target* image at the warped location (the reference samples
  the reference-frame gradient — a first-order approximation; documented
  divergence, higher accuracy).

Convention: T maps reference-camera coordinates to target-camera coordinates
(T_t<-r). Twists are [v, w].
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import platform
from ..camera.model import PinholeCamera
from ..image.pyramid import FramePyramid, bilinear_sample, sample_stack
from ..lie import se3, so3
from ..utils.precision import HIGHEST
from .points import TrackPoints
from .robust import WeightKind, robust_cost, weights


def _warp_sample(stacked: jax.Array, p3d: jax.Array, T: jax.Array, cam):
    """Warp -> project -> bilinear sample of a (C, H, W) channel stack at
    the SE(3)-warped points. Returns ((C, N) samples, (N,) ok) where ok =
    in front of the camera AND inside the bilinear window.

    With one channel (the inverse-compositional LM) the GPU runs the Pallas
    Triton kernel ops/warp_sample.py: on an H100 the 96-frame IC chunk took
    3.19 ms of device time with it against 3.55 ms with XLA's form. With
    three channels XLA's form is faster (4.90 vs 5.40 ms, PERF.md)."""
    if stacked.shape[0] == 1:
        from ..ops.warp_sample import warp_sample

        return platform.choose(partial(_warp_sample_xla, cam=cam),
                               partial(warp_sample, cam=cam), stacked, p3d, T)
    return _warp_sample_xla(stacked, p3d, T, cam)


def _warp_sample_xla(stacked: jax.Array, p3d: jax.Array, T: jax.Array, cam):
    p_t = se3.apply(T, p3d)
    vals, in_img = sample_stack(stacked, cam.project(p_t))
    ok = in_img & (p_t[..., 2] > 1e-3)
    return jnp.where(ok[None, :], vals, 0.0), ok


class TrackResult(NamedTuple):
    T: jax.Array            # (4, 4) refined pose (target <- reference)
    error: jax.Array        # final mean robust error
    iterations: jax.Array   # total LM iterations across levels
    inliers: jax.Array      # valid residual count at the finest level
    converged: jax.Array    # bool
    affine: jax.Array | None = None  # (a, b) brightness estimate (affine=True)


def residuals_and_jacobian(
    T: jax.Array,
    pts: TrackPoints,
    ref_intensity: jax.Array,
    image: jax.Array,
    grad_x: jax.Array,
    grad_y: jax.Array,
    cam: PinholeCamera,
):
    """One fused pass: warp -> project -> sample -> residual + analytic J.

    Returns r (N,), J (N, 6), valid (N,). J columns follow the [v, w] twist
    (translation first — same layout as the reference's Jw at
    src/Tracker.cpp:455-467).
    """
    p_t = se3.apply(T, pts.p3d)                       # (N, 3) target-cam points
    stacked = jnp.stack([image, grad_x, grad_y])
    vals, ok = _warp_sample(stacked, pts.p3d, T, cam)
    i_t, gx, gy = vals[0], vals[1], vals[2]

    r = i_t - ref_intensity                           # photometric residual
    valid = pts.valid & ok

    # dI/d(uv) (1x2) . d(uv)/dp_t (2x3): image-gradient-weighted projection rows.
    Jp = cam.project_jacobian(p_t)                    # (N, 2, 3)
    g = gx[..., None] * Jp[..., 0, :] + gy[..., None] * Jp[..., 1, :]  # (N, 3)

    # dp_t/d(delta) for right-update T*exp(delta): [R | -R hat(p)].
    R = se3.rotation(T)
    gR = jnp.einsum("nj,jk->nk", g, R, precision=HIGHEST)              # (N, 3)
    # translation block: gR ; rotation block: g . (-R hat(p)) = -(gR) x-form:
    # (-R hat(p)) columns = -R [e_i x p] => g^T(-R hat(p)) = -(gR) hat(p)...
    # using hat(p)^T = -hat(p):  (gR) @ hat(p) gives g^T R hat(p); need minus.
    Jw = jnp.einsum(
        "nj,njk->nk", gR, -so3.hat(pts.p3d), precision=HIGHEST
    )                                                                   # (N, 3)
    J = jnp.concatenate([gR, Jw], axis=-1)            # (N, 6)
    z = jnp.zeros_like(r)
    return jnp.where(valid, r, z), jnp.where(valid[..., None], J, 0.0), valid


def _cholesky_solve6(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve the small SPD system A x = b via a statically-unrolled Cholesky
    (n = A.shape[-1], 6 for pure SE(3), 8 with affine brightness).

    Unlike jnp.linalg.solve (an LU library call), this unrolled form is
    pure elementwise math that XLA folds into the surrounding fusion and
    vectorizes over any batch dims. A must be SPD —
    the LM damping (lam*diag + eps*I) guarantees it on the solve path."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n                      # forward solve L y = b
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n                      # back solve L^T x = y
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def _solve_damped(H: jax.Array, b: jax.Array, lam: jax.Array) -> jax.Array:
    """Solve (H + lam * diag(H)) delta = b — LM with Marquardt scaling."""
    n = H.shape[-1]
    Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(n, dtype=H.dtype)
    return _cholesky_solve6(Hd, b)


class _LMState(NamedTuple):
    T: jax.Array          # candidate pose to evaluate next
    T_best: jax.Array     # best accepted pose so far
    ab: jax.Array         # candidate affine brightness (a, b)
    ab_best: jax.Array    # affine brightness at T_best
    r_best: jax.Array     # residuals at T_best
    J_best: jax.Array     # Jacobian at T_best
    valid_best: jax.Array  # validity mask at T_best
    error: jax.Array      # error at T_best
    lam: jax.Array
    k: jax.Array
    done: jax.Array
    n_inlier: jax.Array




def _affine_residual(r, ref_intensity, ab, valid):
    """Brightness-compensated residual: r - a*I_ref - b (masked).

    The photometric model is I_tgt(w(x)) = (1+a) * I_ref(x) + b — underwater
    scenes (the reference's domain, /root/reference/README.md:3) violate
    brightness constancy through attenuation and artificial lighting; this
    is the standard DSO-style affine compensation. r is the plain
    brightness-constancy residual I_tgt - I_ref."""
    return jnp.where(valid, r - ab[0] * ref_intensity - ab[1], 0.0)


def _affine_columns(ref_intensity, valid):
    """d(residual)/d(a, b) = (-I_ref, -1): two constant Jacobian columns."""
    ja = jnp.where(valid, -ref_intensity, 0.0)
    jb = jnp.where(valid, -1.0, 0.0)
    return jnp.stack([ja, jb], axis=-1)  # (N, 2)


@partial(
    jax.jit, static_argnames=("cam", "max_iters", "weight_kind", "affine")
)
def lm_level(
    T0: jax.Array,
    pts: TrackPoints,
    ref_intensity: jax.Array,
    image: jax.Array,
    grad_x: jax.Array,
    grad_y: jax.Array,
    cam: PinholeCamera,
    max_iters: int = 10,
    eps: float = 1e-4,
    weight_kind: WeightKind = WeightKind.HUBER,
    init_lambda: float = 1e-4,
    affine: bool = False,
    ab0: jax.Array | None = None,
):
    """LM refinement at a single pyramid level (reference GN inner loop,
    src/Tracker.cpp:688-852, with real damping).

    Sampling-pass economy vs textbook LM (the dense-sampling matmuls dominate
    the budget): deferred-evaluation stepping — each iteration does ONE
    residual+Jacobian pass (at the current candidate). Acceptance of the
    *previous* step is decided by comparing this error against the best so
    far; on rejection the step is re-solved from the carried best-state
    (r, J) with a larger lambda. Halves the hot-loop sampling work. The
    robust scale sigma is MAD-estimated ONCE per level from the initial
    residuals for Huber (standard IRLS practice; it saves two sorts per
    iteration at equal ATE) and per-iteration for
    Tukey, whose redescending rejection needs a scale that tracks the
    shrinking residuals.

    affine=True jointly estimates DSO-style affine brightness (a, b) —
    the state becomes 8-DOF [xi, a, b] with two constant extra Jacobian
    columns (-I_ref, -1).
    """
    ab0 = jnp.zeros(2, jnp.float32) if ab0 is None else ab0
    from .robust import mad_sigma

    def eval_at(T, ab):
        r_raw, J, valid = residuals_and_jacobian(
            T, pts, ref_intensity, image, grad_x, grad_y, cam
        )
        if affine:
            r = _affine_residual(r_raw, ref_intensity, ab, valid)
            J = jnp.concatenate(
                [J, _affine_columns(ref_intensity, valid)], axis=-1
            )
        else:
            r = r_raw
        return r, J, valid

    r0, J0, valid0 = eval_at(T0, ab0)
    sigma0 = mad_sigma(r0, valid0)
    err0 = robust_cost(r0, valid0, weight_kind, sigma=sigma0)

    def solve_from(r, J, valid, lam):
        # Tukey hard-rejects beyond b*sigma, so its scale must track the
        # shrinking residuals — estimated over the CURRENT validity mask
        # (points that warped out of frame carry zeroed residuals that would
        # drag the MAD toward 0 under a stale mask). Huber degrades
        # gracefully with a stale scale, so it keeps the per-level sigma0
        # (saves 2 sorts/iteration at equal ATE).
        sig = (
            mad_sigma(r, valid)
            if weight_kind == WeightKind.TUKEY
            else sigma0
        )
        w = weights(r, valid, weight_kind, sigma=sig)
        wJ = w[:, None] * J
        H = jnp.einsum("ni,nj->ij", J, wJ, precision=HIGHEST)
        b = -jnp.einsum("ni,n->i", wJ, r, precision=HIGHEST)
        return _solve_damped(H, b, lam)

    def apply_delta(T, ab, delta):
        T_next = se3.right_update(T, delta[:6])
        ab_next = ab + delta[6:8] if affine else ab
        return T_next, ab_next

    def cond(s: _LMState):
        return (~s.done) & (s.k < max_iters)

    def body(s: _LMState):
        # One pass: evaluate the current candidate. The accept metric is
        # the rho objective (robust_cost), NOT the IRLS surrogate
        # sum(w r^2): for redescending Tukey the surrogate rewards steps
        # that eject points past the rejection threshold (w -> 0 zeroes
        # their cost), which walked tracking into biased poses.
        r, J, valid = eval_at(s.T, s.ab)
        err = robust_cost(r, valid, weight_kind, sigma=sigma0)

        accept = (err < s.error) & jnp.isfinite(err)
        T_base = jnp.where(accept, s.T, s.T_best)
        ab_base = jnp.where(accept, s.ab, s.ab_best)
        r_base = jnp.where(accept, r, s.r_best)
        J_base = jnp.where(accept, J, s.J_best)
        v_base = jnp.where(accept, valid, s.valid_best)
        err_base = jnp.where(accept, err, s.error)
        lam_next = jnp.where(accept, s.lam * 0.5, s.lam * 4.0).clip(1e-7, 1e3)

        delta = solve_from(r_base, J_base, v_base, lam_next)
        ok = jnp.all(jnp.isfinite(delta))
        T_next, ab_next = apply_delta(T_base, ab_base, delta)
        T_next = jnp.where(ok, T_next, T_base)
        ab_next = jnp.where(ok, ab_next, ab_base)
        small_step = jnp.linalg.norm(delta) < eps
        done = (accept & small_step) | (lam_next > 500.0) | ~ok
        return _LMState(
            T=T_next,
            T_best=T_base,
            ab=ab_next,
            ab_best=ab_base,
            r_best=r_base,
            J_best=J_base,
            valid_best=v_base,
            error=err_base,
            lam=lam_next,
            k=s.k + 1,
            done=done,
            # Inlier count of the BEST pose, not of a possibly-rejected
            # candidate — callers gate tracking failure on it.
            n_inlier=jnp.where(accept, jnp.sum(valid), s.n_inlier),
        )

    delta0 = solve_from(r0, J0, valid0, jnp.asarray(init_lambda, T0.dtype))
    T1, ab1 = apply_delta(T0, ab0, delta0)
    init = _LMState(
        T=T1,
        T_best=T0,
        ab=ab1,
        ab_best=ab0,
        r_best=r0,
        J_best=J0,
        valid_best=valid0,
        error=err0,
        lam=jnp.asarray(init_lambda, T0.dtype),
        k=jnp.asarray(0),
        done=jnp.asarray(False),
        n_inlier=jnp.sum(valid0),
    )
    out = jax.lax.while_loop(cond, body, init)
    # The final candidate s.T may be unevaluated; report the best ACCEPTED.
    return out._replace(T=out.T_best, ab=out.ab_best)


@partial(
    jax.jit, static_argnames=("cam", "max_iters", "weight_kind", "affine")
)
def lm_level_ic(
    T0: jax.Array,
    pts: TrackPoints,
    ref_intensity: jax.Array,
    ref_grad_x: jax.Array,
    ref_grad_y: jax.Array,
    image: jax.Array,
    cam: PinholeCamera,
    max_iters: int = 10,
    eps: float = 1e-4,
    weight_kind: WeightKind = WeightKind.HUBER,
    init_lambda: float = 1e-4,
    affine: bool = False,
    ab0: jax.Array | None = None,
):
    """Inverse-compositional LM at one level (Baker-Matthews; the proxy-
    template photometric-BA literature builds on the same identity).

    The Jacobian is evaluated ONCE on the REFERENCE frame at the identity
    warp — it is constant across iterations, so the hot loop samples only
    the target INTENSITY (1 channel instead of intensity+2 gradients):
    ~3x less of the HBM-bound sampling work than the forward-compositional
    path. Update rule: T <- T * exp(delta)^-1 (the increment warps the
    reference, composed inversely).

    affine=True adds DSO-style affine brightness (a, b): the two extra
    Jacobian columns (-I_ref, -1) are constant too, so the IC economy is
    preserved exactly.
    """
    ab0 = jnp.zeros(2, jnp.float32) if ab0 is None else ab0
    # Constant J from reference gradients at the reference pixels.
    # ref_grad_x/y may arrive presampled per-point (1-D, from track()'s
    # fused C=3 reference pass — saves sampling the same uv a second
    # time) or as full (H, W) gradient images.
    if ref_grad_x.ndim == 1:
        gx, gy = ref_grad_x, ref_grad_y
    else:
        gvals, _ = sample_stack(jnp.stack([ref_grad_x, ref_grad_y]), pts.uv)
        gx, gy = gvals[0], gvals[1]
    Jp = cam.project_jacobian(pts.p3d)                 # (N, 2, 3) at identity
    g = gx[..., None] * Jp[..., 0, :] + gy[..., None] * Jp[..., 1, :]
    Jw = jnp.einsum("nj,njk->nk", g, -so3.hat(pts.p3d), precision=HIGHEST)
    J = jnp.concatenate([g, Jw], axis=-1)              # (N, 6)
    J = jnp.where(pts.valid[..., None], J, 0.0)
    if affine:
        J = jnp.concatenate(
            [J, _affine_columns(ref_intensity, pts.valid)], axis=-1
        )

    def sample_target(T, ab):
        vals, ok = _warp_sample(image[None], pts.p3d, T, cam)
        i_t = vals[0]
        valid = pts.valid & ok
        r = jnp.where(valid, i_t - ref_intensity, 0.0)
        if affine:
            r = _affine_residual(r, ref_intensity, ab, valid)
        return r, valid

    from .robust import mad_sigma

    r0, valid0 = sample_target(T0, ab0)
    sigma0 = mad_sigma(r0, valid0)

    def eval_err(r, valid):
        # rho objective (see lm_level): valid for redescending kernels.
        return robust_cost(r, valid, weight_kind, sigma=sigma0)

    err0 = eval_err(r0, valid0)

    def solve_from(r, valid, lam):
        sig = (
            mad_sigma(r, valid)
            if weight_kind == WeightKind.TUKEY
            else sigma0
        )
        w = weights(r, valid, weight_kind, sigma=sig)
        Jm = jnp.where(valid[..., None], J, 0.0)
        wJ = w[:, None] * Jm
        H = jnp.einsum("ni,nj->ij", Jm, wJ, precision=HIGHEST)
        b = -jnp.einsum("ni,n->i", wJ, r, precision=HIGHEST)
        return _solve_damped(H, b, lam)

    def apply_delta(T, ab, delta):
        # Inverse composition: with r = I_tgt - I_ref and b = -J^T W r, the
        # optimal reference-side increment is exp(-delta), and
        # T ∘ exp(-delta)^-1 = T ∘ exp(delta) — the same update form as FC.
        # The affine params live on the reference side and update additively.
        T_next = se3.normalize(se3.compose(T, se3.exp(delta[:6])))
        ab_next = ab + delta[6:8] if affine else ab
        return T_next, ab_next

    class S(NamedTuple):
        T: jax.Array
        T_best: jax.Array
        ab: jax.Array
        ab_best: jax.Array
        r_best: jax.Array
        valid_best: jax.Array
        error: jax.Array
        lam: jax.Array
        k: jax.Array
        done: jax.Array
        n_inlier: jax.Array

    def body(s: S):
        r, valid = sample_target(s.T, s.ab)
        err = eval_err(r, valid)
        accept = (err < s.error) & jnp.isfinite(err)
        T_base = jnp.where(accept, s.T, s.T_best)
        ab_base = jnp.where(accept, s.ab, s.ab_best)
        r_base = jnp.where(accept, r, s.r_best)
        v_base = jnp.where(accept, valid, s.valid_best)
        err_base = jnp.where(accept, err, s.error)
        lam_next = jnp.where(accept, s.lam * 0.5, s.lam * 4.0).clip(1e-7, 1e3)
        delta = solve_from(r_base, v_base, lam_next)
        ok = jnp.all(jnp.isfinite(delta))
        T_next, ab_next = apply_delta(T_base, ab_base, delta)
        T_next = jnp.where(ok, T_next, T_base)
        ab_next = jnp.where(ok, ab_next, ab_base)
        small = jnp.linalg.norm(delta) < eps
        return S(
            T=T_next, T_best=T_base, ab=ab_next, ab_best=ab_base,
            r_best=r_base, valid_best=v_base,
            error=err_base, lam=lam_next, k=s.k + 1,
            done=(accept & small) | (lam_next > 500.0) | ~ok,
            n_inlier=jnp.where(accept, jnp.sum(valid), s.n_inlier),
        )

    delta0 = solve_from(r0, valid0, jnp.asarray(init_lambda, T0.dtype))
    T1, ab1 = apply_delta(T0, ab0, delta0)
    init = S(
        T=T1,
        T_best=T0, ab=ab1, ab_best=ab0, r_best=r0, valid_best=valid0,
        error=err0,
        lam=jnp.asarray(init_lambda, T0.dtype),
        k=jnp.asarray(0), done=jnp.asarray(False),
        n_inlier=jnp.sum(valid0),
    )
    out = jax.lax.while_loop(lambda s: (~s.done) & (s.k < max_iters), body, init)
    return _LMState(
        T=out.T_best, T_best=out.T_best, ab=out.ab_best, ab_best=out.ab_best,
        r_best=out.r_best,
        J_best=J, valid_best=out.valid_best, error=out.error, lam=out.lam,
        k=out.k, done=out.done, n_inlier=out.n_inlier,
    )


@partial(
    jax.jit,
    static_argnames=(
        "cam", "levels", "max_iters", "weight_kind", "mode", "affine",
    ),
)
def track(
    ref: FramePyramid,
    tgt: FramePyramid,
    pts: TrackPoints,
    cam: PinholeCamera,
    T_init: jax.Array | None = None,
    levels: tuple[int, ...] = (3, 2, 1, 0),
    max_iters: int = 10,
    weight_kind: WeightKind = WeightKind.HUBER,
    mode: str = "fc",
    affine: bool = False,
) -> TrackResult:
    """Coarse-to-fine photometric tracking: returns T (target <- reference).

    `pts` are level-0 selections in the reference frame; each level resamples
    its reference intensity at the scaled pixel coordinates (replacing the
    reference's quaternion-doubling upscale hack, src/Tracker.cpp:580-590,
    with the standard per-level intrinsics schedule).

    mode: "fc" (forward-compositional; gradients sampled in the TARGET at the
    warped points — most accurate) or "ic" (inverse-compositional; constant
    reference-side Jacobian, ~3x less sampling per iteration).

    affine=True jointly estimates DSO-style affine brightness (a, b) per
    frame pair, threaded coarse-to-fine like the pose — for scenes that
    violate brightness constancy (underwater attenuation/lighting, exposure
    changes). The estimate is reported in TrackResult.affine.
    """
    T = jnp.eye(4, dtype=jnp.float32) if T_init is None else T_init
    T_start = T
    ab = jnp.zeros(2, jnp.float32)
    total_iters = jnp.asarray(0)
    last = None
    pts_finest = None
    # max_iters may be one budget for all levels or a per-level schedule
    # (aligned with `levels`, coarse first). Sampling cost scales with the
    # level-0 image area, so "polish" budgets at fine levels buy most of the
    # hot-loop time back with no accuracy loss (coarse levels do the motion).
    iters_schedule = (
        max_iters if isinstance(max_iters, tuple)
        else tuple(max_iters for _ in levels)
    )
    for lvl, lvl_iters in zip(levels, iters_schedule):
        scale = 1.0 / (1 << lvl)
        cam_l = cam.scaled(lvl)
        # Full point set at every level (per-level reslices of the strongest
        # points break XLA's buffer reuse across levels).
        pts_full = pts
        uv_l = pts_full.uv * scale
        ref_gx_pts = ref_gy_pts = None
        if lvl == 0 and pts.gx0 is not None:
            # Selection cached the level-0 intensity and gradients at these
            # exact integer pixels (TrackPoints.gx0/gy0) — the bilinear
            # reference sample here would be an expensive identity.
            ref_int_l, ref_ok = pts.intensity, pts.valid
            ref_gx_pts, ref_gy_pts = pts.gx0, pts.gy0
        elif mode == "ic":
            # One C=3 reference pass: intensity + both gradients at the
            # same uv.
            vals, ref_ok = sample_stack(
                jnp.stack(
                    [ref.images[lvl], ref.grad_x[lvl], ref.grad_y[lvl]]
                ),
                uv_l,
            )
            ref_int_l, ref_gx_pts, ref_gy_pts = vals[0], vals[1], vals[2]
        else:
            ref_int_l, ref_ok = bilinear_sample(ref.images[lvl], uv_l)
        pts_l = TrackPoints(
            uv=uv_l,
            p3d=pts_full.p3d,
            intensity=ref_int_l,
            valid=pts_full.valid & ref_ok,
        )
        if mode == "ic":
            out = lm_level_ic(
                T,
                pts_l,
                ref_int_l,
                ref_gx_pts if ref_gx_pts is not None else ref.grad_x[lvl],
                ref_gy_pts if ref_gy_pts is not None else ref.grad_y[lvl],
                tgt.images[lvl],
                cam_l,
                max_iters=lvl_iters,
                weight_kind=weight_kind,
                affine=affine,
                ab0=ab,
            )
        else:
            out = lm_level(
                T,
                pts_l,
                ref_int_l,
                tgt.images[lvl],
                tgt.grad_x[lvl],
                tgt.grad_y[lvl],
                cam_l,
                max_iters=lvl_iters,
                weight_kind=weight_kind,
                affine=affine,
                ab0=ab,
            )
        T = out.T
        ab = out.ab
        total_iters = total_iters + out.k
        last = out
        pts_finest = (pts_l, cam_l)
    # Basin guard: coarse-to-fine can walk into an ALIASED minimum — on
    # (quasi-)periodic texture (sand ripples, tiling, the synthetic
    # sinusoid scenes) the coarsest level's texture period is sub-pixel, so
    # its deepest minimum can sit a whole period off, and the finer levels
    # then refine that wrong basin monotonically (per-level LM acceptance
    # never compares ACROSS levels). One extra intensity pass evaluates the
    # finest-level residual at the ORIGINAL init under the final photometric
    # (a, b); if the refined pose explains the image worse than the init
    # did, the pyramid jumped basins — return the init instead (measured:
    # two period-jumps of 5.4 px on the 20-frame synthetic verify sequence,
    # ATE 0.1255 -> 0.0031 with the guard).
    pts_g, cam_g = pts_finest
    vals_g, ok_g = _warp_sample(
        tgt.images[levels[-1]][None], pts_g.p3d, T_start, cam_g
    )
    i_g = vals_g[0]
    valid_g = pts_g.valid & ok_g
    r_g = jnp.where(valid_g, i_g - pts_g.intensity, 0.0)
    if affine:
        r_g = _affine_residual(r_g, pts_g.intensity, ab, valid_g)
    e_init = jnp.sum(jnp.abs(r_g)) / jnp.maximum(jnp.sum(valid_g), 1)
    e_final = jnp.sum(jnp.abs(last.r_best)) / jnp.maximum(
        jnp.sum(last.valid_best), 1
    )
    # Strictly-worse test with slack: near-ties keep the refined pose.
    jumped = e_final > e_init * 1.05
    T = jnp.where(jumped, T_start, T)
    return TrackResult(
        T=T,
        error=jnp.where(jumped, e_init, last.error),
        iterations=total_iters,
        inliers=jnp.where(jumped, jnp.sum(valid_g), last.n_inlier),
        converged=(last.done | (last.error < 1e3)) & ~jumped,
        affine=ab,
    )
