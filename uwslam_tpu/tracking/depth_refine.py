"""Per-point photometric inverse-depth refinement (LSD-SLAM-style filter).

Given a tracked relative pose T (target <- reference), each reference point's
inverse depth rho is refined by Gauss-Newton on the SAME photometric residual
the pose tracker uses — the 1-D depth direction of the joint problem:

    r(rho) = I_tgt(pi(R x + rho t)) - I_ref,   x = K^-1 [u, v, 1]

(pi is scale-invariant, so the unit-inverse-depth parameterization
pi((1/rho) R x + t) == pi(R x + rho t) holds for rho > 0.)

dr/drho = grad I_tgt . J_pi(R x + rho t) . t  — analytic, batched over all
points, one fused 3-channel sampling pass per iteration (the identical
machinery as the pose hot loop, so it inherits its sampling form).

This is the monocular depth estimator the reference lacks entirely (its
mono path hardcodes z=1, /root/reference/src/Tracker.cpp:1228-1232); the
capability its dead `Obtain3DPoints` declaration (include/Tracker.h:157)
gestured at.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..camera.model import PinholeCamera
from ..lie import se3
from .points import TrackPoints


class RefinedDepth(NamedTuple):
    inv_depth: jax.Array   # (N,) refined inverse depths (reference frame)
    good: jax.Array        # (N,) refinement believed (converged, observable)
    slope: jax.Array       # (N,) |dr/drho| at convergence — the estimate's
    #                        observability; its square ~ inverse variance
    #                        (confidence weight for grid fusion)


@partial(jax.jit, static_argnames=("cam", "iters"))
def refine_inverse_depth(
    pts: TrackPoints,
    T: jax.Array,
    image: jax.Array,
    grad_x: jax.Array,
    grad_y: jax.Array,
    cam: PinholeCamera,
    iters: int = 4,
    min_depth: float = 0.05,
    max_depth: float = 50.0,
    min_slope: float = 0.5,
    max_residual: float = 12.0,
    ab: jax.Array | None = None,
) -> RefinedDepth:
    """GN on per-point inverse depth at fixed pose (target-frame image +
    gradients at the finest level). Gates: the photometric depth slope
    |dr/drho| must be observable (parallax x texture), the final residual
    small, and the depth in bounds — otherwise the point keeps its prior
    depth and is marked not-good.

    ab: the tracker's affine-brightness estimate (a, b) for this frame
    pair. The depth residual must be compensated by the SAME photometric
    model the pose was solved under: with per-frame gain/bias drift an
    uncompensated brightness offset of a few intensity units divided by a
    min_slope-sized depth slope walks rho by whole units — measured on the
    drifting-exposure TUM stand-in as the dominant depth-prior error
    source (round 5)."""
    from .photometric import _affine_residual
    from ..image.pyramid import sample_stack

    R = se3.rotation(T)
    t = se3.translation(T)
    x = cam.unproject(pts.uv, jnp.ones(pts.uv.shape[:-1]))   # (N, 3), unit z
    Rx = x @ R.T                                             # (N, 3)
    rho0 = 1.0 / jnp.maximum(pts.p3d[..., 2], 1e-6)
    stacked = jnp.stack([image, grad_x, grad_y])

    def eval_at(rho):
        p = Rx + rho[:, None] * t                            # ~ target dir
        uv_t = cam.project(p)
        vals, inb = sample_stack(stacked, uv_t)
        i_t, gx, gy = vals[0], vals[1], vals[2]
        r = i_t - pts.intensity
        if ab is not None:
            r = _affine_residual(r, pts.intensity, ab, jnp.ones_like(r, bool))
        Jp = cam.project_jacobian(p)                         # (N, 2, 3)
        duv = jnp.einsum("nij,j->ni", Jp, t)                 # (N, 2)
        g = gx * duv[:, 0] + gy * duv[:, 1]                  # dr/drho
        ok = inb & (p[..., 2] > 1e-6)
        return r, g, ok

    rho = rho0
    for _ in range(iters):
        r, g, ok = eval_at(rho)
        step = jnp.where(ok, g * r / (g * g + 1e-4), 0.0)
        # Trust region: inverse depth moves at most 30% per iteration.
        step = jnp.clip(step, -0.3 * rho, 0.3 * rho)
        rho = jnp.clip(
            rho - step, 1.0 / max_depth, 1.0 / min_depth
        )

    r, g, ok = eval_at(rho)
    good = (
        pts.valid
        & ok
        & (jnp.abs(g) > min_slope)        # depth observable at this point
        & (jnp.abs(r) < max_residual)     # alignment actually explains it
        & (rho > 1.0 / max_depth) & (rho < 1.0 / min_depth)
    )
    return RefinedDepth(inv_depth=rho, good=good, slope=jnp.abs(g))


@partial(jax.jit, static_argnames=("cam",))
def transfer_depths(
    pts: TrackPoints,
    inv_depth: jax.Array,
    good: jax.Array,
    T: jax.Array,
    cam: PinholeCamera,
):
    """Carry refined reference-frame depths into the TARGET frame: transform
    the refined 3D points by T, project. Returns (uv_tgt, depth_tgt, ok) —
    ready to splat into the target frame's depth prior."""
    p_ref = cam.unproject(pts.uv, 1.0 / jnp.maximum(inv_depth, 1e-6))
    p_t = se3.apply(T, p_ref)
    uv_t = cam.project(p_t)
    ok = (
        good
        & (p_t[..., 2] > 1e-3)
        & (uv_t[..., 0] >= 0) & (uv_t[..., 0] <= cam.width - 1)
        & (uv_t[..., 1] >= 0) & (uv_t[..., 1] <= cam.height - 1)
    )
    return uv_t, p_t[..., 2], ok
