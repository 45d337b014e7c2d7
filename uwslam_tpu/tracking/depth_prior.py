"""Monocular depth bootstrapping — triangulated sparse depth -> dense prior.

The reference feeds constant z=1 to pure-mono tracking
(/root/reference/src/Tracker.cpp:1228-1232), which is exact only for a
fronto-parallel plane; on real structure the wrong depths bend the estimated
motion. This module closes that gap (VERDICT.md round-1 missing item 3):

1. triangulate the feature matches the front-end already computes
   (features.geometry.triangulate_linear) against the tracked relative pose,
2. rasterize the inverse depths into a coarse block grid (scatter-free:
   one segment_sum over static Hb*Wb bins — shape-static),
3. fill unobserved blocks with the global median and sample the grid
   bilinearly at the next frame's track-point pixels.

Inverse depth is the right interpolation variable: it is what the
photometric warp is linear in, and averaging it favors near structure the
way parallax information does.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..camera.model import PinholeCamera
from ..features.geometry import triangulate_linear
from ..lie import se3


@jax.tree_util.register_pytree_node_class
class DepthPrior:
    """Coarse inverse-depth grid over the image (block-sized cells).

    Registered as a pytree with `block` as STATIC aux data, so jitted
    consumers can use it for shapes/static args."""

    __slots__ = ("inv_depth", "weight", "block")

    def __init__(self, inv_depth, weight, block: int):
        self.inv_depth = inv_depth   # (Hb, Wb) f32 inverse depth per cell
        self.weight = weight         # (Hb, Wb) f32 support count
        self.block = block           # cell size in pixels (static)

    def tree_flatten(self):
        return (self.inv_depth, self.weight), self.block

    @classmethod
    def tree_unflatten(cls, block, children):
        return cls(children[0], children[1], block)

    @property
    def ok(self) -> jax.Array:
        return jnp.sum(self.weight) > 0

    def _replace(self, **kw) -> "DepthPrior":
        return DepthPrior(
            inv_depth=kw.get("inv_depth", self.inv_depth),
            weight=kw.get("weight", self.weight),
            block=kw.get("block", self.block),
        )


class TriangulatedDepth(NamedTuple):
    depth_a: jax.Array     # (K,) depth in frame a at uv_a
    depth_b: jax.Array     # (K,) depth in frame b at uv_b
    good: jax.Array        # (K,) bool quality gate


@partial(jax.jit, static_argnames=("cam",))
def triangulate_matches(
    cam: PinholeCamera,
    T_ba: jax.Array,
    uv_a: jax.Array,
    uv_b: jax.Array,
    valid: jax.Array,
    min_depth: float = 0.05,
    max_depth: float = 50.0,
    max_reproj_px: float = 2.0,
    min_parallax: float = 2e-3,
) -> TriangulatedDepth:
    """Triangulate matched pixels against relative pose T_ba (b <- a).

    Gates: cheirality in both frames, depth bounds, reprojection error in b,
    and a minimum ray parallax angle (rad) — tiny-baseline triangulations
    have unbounded depth variance and would poison the grid."""
    xy_a = cam.unproject(uv_a, jnp.ones(uv_a.shape[:-1]))[..., :2]
    xy_b = cam.unproject(uv_b, jnp.ones(uv_b.shape[:-1]))[..., :2]
    pts_a = triangulate_linear(jnp.eye(4), T_ba, xy_a, xy_b)  # frame a
    z_a = pts_a[:, 2]
    pts_b = se3.apply(T_ba, pts_a)
    z_b = pts_b[:, 2]

    uv_b_hat = cam.project(pts_b)
    reproj = jnp.linalg.norm(uv_b_hat - uv_b, axis=-1)

    # Parallax: angle between the two observation rays (in frame a).
    ra = jnp.concatenate([xy_a, jnp.ones_like(z_a)[:, None]], axis=-1)
    R_ab = se3.rotation(se3.inverse(T_ba))
    rb = jnp.einsum(
        "ij,nj->ni",
        R_ab,
        jnp.concatenate([xy_b, jnp.ones_like(z_b)[:, None]], axis=-1),
    )
    cosang = jnp.sum(ra * rb, axis=-1) / (
        jnp.linalg.norm(ra, axis=-1) * jnp.linalg.norm(rb, axis=-1)
    )
    parallax = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))

    good = (
        valid
        & (z_a > min_depth) & (z_a < max_depth)
        & (z_b > min_depth) & (z_b < max_depth)
        & (reproj < max_reproj_px)
        & (parallax > min_parallax)
    )
    return TriangulatedDepth(depth_a=z_a, depth_b=z_b, good=good)


@partial(jax.jit, static_argnames=("height", "width", "block"))
def prior_from_points(
    uv: jax.Array,
    depth: jax.Array,
    valid: jax.Array,
    height: int,
    width: int,
    block: int = 32,
    weights: jax.Array | None = None,
) -> DepthPrior:
    """Rasterize sparse depths into a coarse inverse-depth grid.

    Scatter-free: cell ids are computed per point and reduced with
    segment_sum over the static Hb*Wb bins.

    weights: optional per-point confidences (e.g. inverse variance of a
    photometric depth estimate, ~ slope^2). Without them every valid point
    votes equally and one badly-observable point drags its whole cell."""
    Hb = -(-height // block)
    Wb = -(-width // block)
    cx = jnp.clip((uv[:, 0] // block).astype(jnp.int32), 0, Wb - 1)
    cy = jnp.clip((uv[:, 1] // block).astype(jnp.int32), 0, Hb - 1)
    cell = cy * Wb + cx
    inv = jnp.where(valid, 1.0 / jnp.maximum(depth, 1e-6), 0.0)
    w = valid.astype(jnp.float32)
    if weights is not None:
        w = w * jnp.maximum(weights, 0.0)
    num = jax.ops.segment_sum(inv * w, cell, num_segments=Hb * Wb)
    den = jax.ops.segment_sum(w, cell, num_segments=Hb * Wb)
    inv_grid = jnp.where(den > 0, num / jnp.maximum(den, 1.0), 0.0)
    return DepthPrior(
        inv_depth=inv_grid.reshape(Hb, Wb),
        weight=den.reshape(Hb, Wb),
        block=block,
    )


def _masked_median(x: jax.Array, mask: jax.Array) -> jax.Array:
    """Median of x over mask (sort-based; NaN-free for empty masks)."""
    n = jnp.sum(mask)
    big = jnp.where(mask, x, jnp.inf)
    s = jnp.sort(big.ravel())
    idx = jnp.clip((n - 1) // 2, 0, x.size - 1)
    med = s[idx]
    return jnp.where(n > 0, med, 1.0)


@jax.jit
def fill_prior(prior: DepthPrior) -> DepthPrior:
    """Fill unobserved cells: 3 rounds of neighbor averaging (weighted by
    support), then global median for anything still empty. Pure
    shift-and-add — no scatter, no dynamic shapes."""
    inv, w = prior.inv_depth, jnp.minimum(prior.weight, 8.0)

    def spread(inv, w):
        acc_v = inv * w
        acc_w = w
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            sv = jnp.roll(inv * w, (dy, dx), axis=(0, 1))
            sw = jnp.roll(w, (dy, dx), axis=(0, 1))
            # zero the wrapped edge
            if dy == -1:
                sv = sv.at[-1].set(0); sw = sw.at[-1].set(0)
            if dy == 1:
                sv = sv.at[0].set(0); sw = sw.at[0].set(0)
            if dx == -1:
                sv = sv.at[:, -1].set(0); sw = sw.at[:, -1].set(0)
            if dx == 1:
                sv = sv.at[:, 0].set(0); sw = sw.at[:, 0].set(0)
            acc_v = acc_v + 0.5 * sv
            acc_w = acc_w + 0.5 * sw
        new_inv = jnp.where(acc_w > 0, acc_v / jnp.maximum(acc_w, 1e-6), 0.0)
        # observed cells keep their value; empty ones adopt the neighborhood
        keep = w > 0
        return jnp.where(keep, inv, new_inv), jnp.where(
            keep, w, (acc_w > 0).astype(w.dtype) * 0.25
        )

    for _ in range(3):
        inv, w = spread(inv, w)
    med = _masked_median(inv, w > 0)
    # A grid with NO support at all stays all-zero (sample_prior then falls
    # back to mono_depth) instead of median-filling to a fabricated constant
    # — lets callers fuse device-side-gated sources without a host check.
    med = jnp.where(jnp.sum(prior.weight) > 0, med, 0.0)
    inv = jnp.where(w > 0, inv, med)
    w = jnp.maximum(w, 1e-3)
    return DepthPrior(inv_depth=inv, weight=w, block=prior.block)


@jax.jit
def gauge_ratio(
    new: DepthPrior, ref: DepthPrior, min_weight: float = 0.2
) -> jax.Array:
    """Median ratio new/ref of inverse depths over jointly-supported cells.

    Monocular scale is a gauge freedom: per-frame triangulation and
    photometric refinement measure STRUCTURE reliably but their absolute
    scale rides on the noisy estimated translation, and fusing that scale
    back into the prior compounds into scale drift (measured 1.5%/frame on
    the multi-plane synthetic — the drift Sim(3)-aligned ATE cannot absorb).
    Anchoring each measurement grid to the geometrically-propagated prior's
    gauge (divide its inverse depths by this ratio) pins the scale to the
    bootstrap initialization for the whole run."""
    mask = (
        (new.weight >= min_weight)
        & (ref.weight >= min_weight)
        & (new.inv_depth > 1e-6)
        & (ref.inv_depth > 1e-6)
    )
    ratio = new.inv_depth / jnp.maximum(ref.inv_depth, 1e-6)
    med = _masked_median(ratio, mask)
    n = jnp.sum(mask)
    return jnp.where(n >= 8, med, 1.0)


@partial(jax.jit, static_argnames=("shrink",))
def sample_prior(
    prior: DepthPrior,
    uv: jax.Array,
    fallback: float | jax.Array = 1.0,
    shrink: float = 1.0,
) -> jax.Array:
    """Bilinear sample of the inverse-depth grid at pixel coords (N, 2);
    returns DEPTH. Cells are centered at (i + 0.5) * block. The grid is
    coarse (tens of cells), so a plain 4-tap gather is cheap.

    shrink < 1 blends each read toward the grid's median inverse depth:
    inv <- shrink*inv + (1-shrink)*median. Round-5 finding: the grid's
    per-point structure carries ~35% gauge-removed depth error whose
    SPATIAL STRUCTURE destabilizes the photometric LM (measured 3x
    smaller, wildly inconsistent displacements), while a mostly-smooth
    depth field keeps the pose estimate coherent — shrink=0.25 beat both
    the raw grid AND constant depth on the multi-plane TUM stand-in
    (0.0479 vs 0.0875 raw / 0.0535 constant ATE; sweep: 0.25 > 0.5 > 1.0).
    """
    inv, _ = _sample_prior_taps(prior, uv)
    if shrink < 1.0:
        med = _masked_median(prior.inv_depth, prior.weight > 0)
        inv = jnp.where(inv > 1e-6, shrink * inv + (1.0 - shrink) * med, inv)
    ok = inv > 1e-6
    return jnp.where(ok, 1.0 / jnp.maximum(inv, 1e-6), fallback)


@partial(jax.jit, static_argnames=("shrink",))
def sample_prior_checked(
    prior: DepthPrior,
    uv: jax.Array,
    fallback: float | jax.Array = 1.0,
    max_edge_ratio: float = 1.6,
    min_support: float = 0.5,
    shrink: float = 1.0,
) -> tuple[jax.Array, jax.Array]:
    """sample_prior + a discontinuity flag: (depth, ok). ok is False where
    the 4 interpolation cells disagree by more than max_edge_ratio — a
    bilinear read across a depth edge lands BETWEEN the surfaces, and
    high-gradient track points live exactly on those edges (same phantom-
    depth failure tracking.points._depth_at rejects for real depth maps).
    The threshold is loose because cell-to-cell variation on a 32px grid is
    mostly real slant, not an edge."""
    inv, taps = _sample_prior_taps(prior, uv)
    tmin = jnp.min(taps, axis=0)
    tmax = jnp.max(taps, axis=0)
    # Support gate: fill_prior gives hole-filled cells token weight (<=0.25)
    # while observed cells carry real counts (>=1); a point in a filled
    # cell would track against the global-median guess — pure pose noise.
    w, _ = _sample_prior_taps(
        DepthPrior(prior.weight, prior.weight, prior.block), uv
    )
    ok = (
        (inv > 1e-6)
        & (tmin > 1e-6)
        & (tmax <= tmin * max_edge_ratio)
        & (w >= min_support)
    )
    if shrink < 1.0:
        med = _masked_median(prior.inv_depth, prior.weight > 0)
        inv = jnp.where(inv > 1e-6, shrink * inv + (1.0 - shrink) * med, inv)
    return jnp.where(ok, 1.0 / jnp.maximum(inv, 1e-6), fallback), ok


def _sample_prior_taps(prior: DepthPrior, uv: jax.Array):
    Hb, Wb = prior.inv_depth.shape
    gx = uv[:, 0] / prior.block - 0.5
    gy = uv[:, 1] / prior.block - 0.5
    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, Wb - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, Hb - 2)
    dx = jnp.clip(gx - x0, 0.0, 1.0)
    dy = jnp.clip(gy - y0, 0.0, 1.0)
    g = prior.inv_depth
    i00 = g[y0, x0]
    i01 = g[y0, x0 + 1]
    i10 = g[y0 + 1, x0]
    i11 = g[y0 + 1, x0 + 1]
    inv = (
        i00 * (1 - dx) * (1 - dy)
        + i01 * dx * (1 - dy)
        + i10 * (1 - dx) * dy
        + i11 * dx * dy
    )
    return inv, jnp.stack([i00, i01, i10, i11])


@partial(jax.jit, static_argnames=("cam",))
def propagate_prior(
    prior: DepthPrior, T_ba: jax.Array, cam: PinholeCamera
) -> DepthPrior:
    """Warp a frame-a prior into frame b using relative pose T_ba: unproject
    cell centers at their depths, transform, re-rasterize. Keeps the prior
    alive across frames with no matches (textureless patches, dropped
    features)."""
    Hb, Wb = prior.inv_depth.shape
    yy, xx = jnp.meshgrid(jnp.arange(Hb), jnp.arange(Wb), indexing="ij")
    uv = jnp.stack(
        [(xx.ravel() + 0.5) * prior.block, (yy.ravel() + 0.5) * prior.block],
        axis=-1,
    ).astype(jnp.float32)
    inv = prior.inv_depth.ravel()
    w = prior.weight.ravel()
    depth = 1.0 / jnp.maximum(inv, 1e-6)
    p_a = cam.unproject(uv, depth)
    p_b = se3.apply(T_ba, p_a)
    uv_b = cam.project(p_b)
    valid = (
        (w > 0) & (inv > 1e-6) & (p_b[:, 2] > 1e-3)
        & (uv_b[:, 0] >= 0) & (uv_b[:, 0] < cam.width)
        & (uv_b[:, 1] >= 0) & (uv_b[:, 1] < cam.height)
    )
    new = prior_from_points(
        uv_b, p_b[:, 2], valid, cam.height, cam.width, block=prior.block
    )
    # Propagated support decays so fresh triangulations dominate when present.
    return new._replace(weight=jnp.minimum(new.weight, 4.0) * 0.5)
