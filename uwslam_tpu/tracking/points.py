"""Candidate-point selection for direct tracking — fixed-capacity, mask-based.

Re-imagines the reference's three point builders (SURVEY.md §2 #9):
- ObtainPatchesPoints  (src/Tracker.cpp:1178-1242): patches around matched
  keypoints -> `patch_points`
- ObtainCandidatePoints (src/Tracker.cpp:1314-1398): gradient-threshold sparse
  selection -> `topk_gradient_points` (top-K replaces mean+std thresholding so
  the output shape is static for XLA)
- ObtainAllPoints (src/Tracker.cpp:1259-1310): dense all-pixels -> dense grid
  helpers in the tracker itself.

Depth semantics follow the reference: TUM depth PNGs scaled by 1/5000
(factor 0.0002 at src/Tracker.cpp:1223), z=1 for pure mono (:1228-1232).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..camera.model import PinholeCamera
from ..image.pyramid import bilinear_sample

TUM_DEPTH_FACTOR = 0.0002  # reference src/Tracker.cpp:1223


class TrackPoints(NamedTuple):
    """Fixed-capacity reference-frame points for photometric tracking.

    All arrays have leading dim N (static capacity); `valid` masks real
    entries. This is the array replacement for the reference's
    variable-length candidatePoints_ Mats (include/System.h:84-87)."""

    uv: jax.Array          # (N, 2) float32 pixel coords in the ref frame, level 0
    p3d: jax.Array         # (N, 3) float32 camera-frame 3D points
    intensity: jax.Array   # (N,) float32 reference intensities
    valid: jax.Array       # (N,) bool
    # Optional level-0 Scharr gradients AT the selected pixels, captured for
    # free as sort payloads during selection (see topk_gradient_points).
    # When present, track() skips the level-0 reference sampling pass
    # entirely — the points sit at integer pixels of the very image the
    # cache was read from, so the bilinear sample would return exactly
    # these values. None for builders that don't carry them (patch/dense).
    gx0: jax.Array | None = None   # (N,) float32 Scharr-x at uv, level 0
    gy0: jax.Array | None = None   # (N,) float32 Scharr-y at uv, level 0


def _depth_at(depth_image, uv, mono_z: float, max_edge_ratio: float = 1.15):
    """Sample depth; fall back to mono_z where depth is missing/zero.

    Depth-edge rejection: a bilinear read that straddles a depth
    discontinuity interpolates BETWEEN the two surfaces — and high-gradient
    track points sit exactly on those edges. The phantom depths bias the
    pose (measured: a consistent +5%% translation-scale error on the
    multi-plane synthetic with ground-truth depth maps). Reading the 4
    corner texels explicitly gives the same bilinear value plus a
    discontinuity test for free; a corner at 0 also catches TUM depth-hole
    bleed (a hole interpolated against a valid neighbor passes a naive
    d>0 check with a badly wrong value)."""
    if depth_image is None:
        d = jnp.full(uv.shape[:-1], mono_z, dtype=jnp.float32)
        ok = jnp.ones(uv.shape[:-1], dtype=bool)
        return d, ok
    H, W = depth_image.shape
    u0 = jnp.clip(jnp.floor(uv[..., 0]), 0, W - 2)
    v0 = jnp.clip(jnp.floor(uv[..., 1]), 0, H - 2)
    fu = jnp.clip(uv[..., 0] - u0, 0.0, 1.0)
    fv = jnp.clip(uv[..., 1] - v0, 0.0, 1.0)
    corners = []
    for du, dv in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cuv = jnp.stack([u0 + du, v0 + dv], axis=-1)
        ci, _ = bilinear_sample(depth_image, cuv)
        corners.append(ci * TUM_DEPTH_FACTOR)
    c00, c10, c01, c11 = corners
    d = (
        c00 * (1 - fu) * (1 - fv)
        + c10 * fu * (1 - fv)
        + c01 * (1 - fu) * fv
        + c11 * fu * fv
    )
    stack = jnp.stack(corners)
    dmin = jnp.min(stack, axis=0)
    dmax = jnp.max(stack, axis=0)
    inb = (
        (uv[..., 0] >= 0) & (uv[..., 0] <= W - 1)
        & (uv[..., 1] >= 0) & (uv[..., 1] <= H - 1)
    )
    ok = inb & (dmin > 1e-6) & (dmax <= dmin * max_edge_ratio)
    return jnp.where(ok, d, mono_z), ok


@partial(jax.jit, static_argnames=("num_points", "block"))
def topk_gradient_points(
    image: jax.Array,
    grad_mag: jax.Array,
    cam: PinholeCamera,
    depth_image: jax.Array | None = None,
    num_points: int = 2048,
    mono_z: float = 1.0,
    border: int = 4,
    block: int = 8,
    grad_x: jax.Array | None = None,
    grad_y: jax.Array | None = None,
) -> TrackPoints:
    """Select the `num_points` highest-gradient pixels, spatially spread by
    first taking the per-block argmax over `block`x`block` tiles (the array
    version of the reference's 32x32 mask grid, src/Tracker.cpp:342-359, and its
    mean+std threshold, :1324-1329 — top-k keeps shapes static).

    All per-pixel values the selected points need downstream — intensity and
    (when `grad_x`/`grad_y` are passed) the Scharr gradients — ride the
    selection as SORT PAYLOADS instead of being re-read afterwards: the
    points land on integer pixels, so a post-hoc bilinear sample is just an
    expensive identity. Passing the gradients lets IC tracking skip
    its whole level-0 reference pass (see TrackPoints.gx0).

    The per-block argmax itself is transpose-free: gradient magnitudes are
    bitcast to int32 (monotone for non-negative floats) and the in-block
    index is packed into the low 6 mantissa bits, so one max over the block
    axes yields value AND location, and an equality test against the packed
    max gives an exact one-hot for payload extraction (ties resolve to the
    lowest in-block index — the same winner argmax picked). Costs 6 low
    mantissa bits (2^-18 relative) of selection resolution.
    """
    H, W = grad_mag.shape
    # Suppress the border (warp Jacobians need in-bounds neighborhoods).
    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    interior = (
        (row >= border) & (row < H - border) & (col >= border) & (col < W - border)
    )
    g = jnp.where(interior, jnp.maximum(grad_mag, 0.0), 0.0)

    Hb, Wb = H // block, W // block
    nb = block * block

    def blocks(x):
        return x[: Hb * block, : Wb * block].reshape(Hb, block, Wb, block)

    gi = jax.lax.bitcast_convert_type(blocks(g.astype(jnp.float32)), jnp.int32)
    inner = (
        jnp.arange(block, dtype=jnp.int32)[:, None] * block
        + jnp.arange(block, dtype=jnp.int32)[None, :]
    )[None, :, None, :]
    packed = (gi & ~(nb - 1)) | (nb - 1 - inner)
    pmax = jnp.max(packed, axis=(1, 3))                      # (Hb, Wb)
    onehot = packed == pmax[:, None, :, None]                # exactly one True

    def pick(x):
        return jnp.sum(jnp.where(onehot, blocks(x), 0.0), axis=(1, 3))

    best_val = pick(g).reshape(-1)
    best_int = pick(image).reshape(-1)
    inner_sel = (nb - 1) - (pmax & (nb - 1))
    by = jax.lax.broadcasted_iota(jnp.int32, (Hb, Wb), 0)
    bx = jax.lax.broadcasted_iota(jnp.int32, (Hb, Wb), 1)
    vv = (by * block + inner_sel // block).astype(jnp.float32).reshape(-1)
    uu = (bx * block + inner_sel % block).astype(jnp.float32).reshape(-1)

    # Top-K via a multi-operand sort that carries the pixel coordinates and
    # per-pixel values as payloads, instead of top_k followed by scattered
    # gathers of each value.
    k = min(num_points, Hb * Wb)
    operands = [-best_val, uu, vv, best_int]
    if grad_x is not None:
        operands += [pick(grad_x).reshape(-1), pick(grad_y).reshape(-1)]
    sorted_ops = jax.lax.sort(tuple(operands), num_keys=1)
    top_val = -sorted_ops[0][:k]
    u, v, intensity = (o[:k] for o in sorted_ops[1:4])
    uv = jnp.stack([u, v], axis=-1)
    gx0 = gy0 = None
    if grad_x is not None:
        gx0, gy0 = sorted_ops[4][:k], sorted_ops[5][:k]
    if k < num_points:  # pad to capacity
        pad = num_points - k
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), jnp.float32)])
        top_val = jnp.concatenate([top_val, jnp.full((pad,), -1.0)])
        intensity = jnp.concatenate([intensity, jnp.zeros((pad,), jnp.float32)])
        if gx0 is not None:
            zpad = jnp.zeros((pad,), jnp.float32)
            gx0 = jnp.concatenate([gx0, zpad])
            gy0 = jnp.concatenate([gy0, zpad])

    depth, dok = _depth_at(depth_image, uv, mono_z)
    p3d = cam.unproject(uv, depth)
    valid = (top_val > 0) & dok
    return TrackPoints(
        uv=uv, p3d=p3d, intensity=intensity, valid=valid, gx0=gx0, gy0=gy0
    )


@partial(jax.jit, static_argnames=("stride", "border"))
def dense_points(
    image: jax.Array,
    cam: PinholeCamera,
    depth_image: jax.Array | None = None,
    mono_z: float = 1.0,
    stride: int = 1,
    border: int = 4,
) -> TrackPoints:
    """Every pixel (optionally strided) as a track point — the reference's
    ObtainAllPoints dense builder (src/Tracker.cpp:1259-1310) feeding its
    dense EstimatePose / FastEstimatePose variants (:362-597, :875-1122).

    Shape is static: (H//stride * W//stride) points; the border band is
    masked out rather than dropped."""
    H, W = image.shape
    v, u = jnp.meshgrid(
        jnp.arange(0, H - (H % stride), stride, dtype=jnp.float32),
        jnp.arange(0, W - (W % stride), stride, dtype=jnp.float32),
        indexing="ij",
    )
    uv = jnp.stack([u.ravel(), v.ravel()], axis=-1)
    interior = (
        (uv[:, 0] >= border) & (uv[:, 0] < W - border)
        & (uv[:, 1] >= border) & (uv[:, 1] < H - border)
    )
    # The grid is exactly the strided integer pixels — read values by
    # slicing, no sampling op (a one-hot sampler here would build an
    # (H*W, H) weight matrix; a gather would serialize).
    Hs, Ws = H - (H % stride), W - (W % stride)
    intensity = image[:Hs:stride, :Ws:stride].ravel()
    if depth_image is None:
        depth = jnp.full(intensity.shape, mono_z, dtype=jnp.float32)
        dok = jnp.ones(intensity.shape, dtype=bool)
    else:
        d = depth_image[:Hs:stride, :Ws:stride].ravel() * TUM_DEPTH_FACTOR
        dok = d > 1e-6
        depth = jnp.where(dok, d, mono_z)
    p3d = cam.unproject(uv, depth)
    return TrackPoints(
        uv=uv, p3d=p3d, intensity=intensity, valid=interior & dok
    )


@partial(jax.jit, static_argnames=("patch_size", "max_keypoints"))
def patch_points(
    image: jax.Array,
    keypoints_uv: jax.Array,
    keypoints_valid: jax.Array,
    cam: PinholeCamera,
    depth_image: jax.Array | None = None,
    mono_z: float = 1.0,
    patch_size: int = 5,
    max_keypoints: int = 200,
) -> TrackPoints:
    """Patches of pixels around matched keypoints, the reference's
    ObtainPatchesPoints (<=200 keypoints, patch around each;
    src/Tracker.cpp:1190-1242 — note its start_point precedence bug makes the
    effective patch 9x9; we implement the intended patch_size x patch_size).
    """
    kp = keypoints_uv[:max_keypoints]
    kv = keypoints_valid[:max_keypoints]
    half = patch_size // 2
    offs = jnp.arange(-half, half + 1, dtype=jnp.float32)
    du, dv = jnp.meshgrid(offs, offs, indexing="xy")
    offsets = jnp.stack([du.ravel(), dv.ravel()], axis=-1)  # (P, 2)

    uv = (kp[:, None, :] + offsets[None, :, :]).reshape(-1, 2)  # (K*P, 2)
    valid_kp = jnp.repeat(kv, offsets.shape[0])
    H, W = image.shape
    inb = (
        (uv[:, 0] >= 0) & (uv[:, 0] <= W - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1)
    )
    depth, dok = _depth_at(depth_image, uv, mono_z)
    p3d = cam.unproject(uv, depth)
    intensity, iok = bilinear_sample(image, uv)
    return TrackPoints(
        uv=uv, p3d=p3d, intensity=intensity,
        valid=valid_kp & inb & dok & iok,
    )
