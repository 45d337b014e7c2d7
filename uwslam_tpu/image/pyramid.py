"""Image pyramids, gradients, and sampling — the per-frame preprocessing.

Capability parity with the reference's frame ingest + gradient pass:
- 5-level half-scale pyramid (cv::resize INTER_LINEAR 0.5x chain at
  /root/reference/src/System.cpp:246-251)
- Scharr x/y gradients + abs-weighted magnitude per level
  (/root/reference/src/Tracker.cpp:1127-1142)

The whole pyramid + all gradients are produced by ONE jitted function of the
level-0 image; levels are a tuple of static-shape arrays so XLA fuses the
downsample/convolution chain, and everything stays device-resident (the
reference re-uploads to the GPU every frame, src/Tracker.cpp:179-180).

Images are float32 (H, W) in [0, 255] to keep residual scales comparable with
the reference's uint8 math.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import platform

PYRAMID_LEVELS = 5  # reference: src/Options.cpp:26


class FramePyramid(NamedTuple):
    """Device-resident per-frame data. Each field is a tuple with one entry per
    pyramid level (static shapes halving per level)."""

    images: tuple[jax.Array, ...]       # (H_l, W_l) float32 intensity
    grad_x: tuple[jax.Array, ...]       # (H_l, W_l) float32 Scharr-x / 32
    grad_y: tuple[jax.Array, ...]       # (H_l, W_l) float32 Scharr-y / 32
    grad_mag: tuple[jax.Array, ...]     # 0.5*(|gx|+|gy|), reference's gradient_

    @property
    def levels(self) -> int:
        return len(self.images)


def downsample2x(image: jax.Array) -> jax.Array:
    """2x2 area-mean downsample (matches cv::resize INTER_LINEAR at exactly
    0.5x, which degenerates to 2x2 averaging)."""
    H, W = image.shape
    return image.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))


# Scharr is separable: [-3 0 3; -10 0 10; -3 0 3] = [3 10 3]^T x [-1 0 1].
# Implemented as padded slicing (elementwise adds/muls that XLA fuses into
# one loop). Normalized by 1/32
# so gradient units are intensity/pixel (cv::Scharr is unnormalized; the
# reference only uses relative magnitudes, so this is documented, not
# behavioral).


def _smooth_310(x: jax.Array, axis: int) -> jax.Array:
    """[3, 10, 3]/16 smoothing along axis with edge replication."""
    pad = [(0, 0), (0, 0)]
    pad[axis] = (1, 1)
    p = jnp.pad(x, pad, mode="edge")
    if axis == 0:
        return (3.0 * p[:-2, :] + 10.0 * p[1:-1, :] + 3.0 * p[2:, :]) / 16.0
    return (3.0 * p[:, :-2] + 10.0 * p[:, 1:-1] + 3.0 * p[:, 2:]) / 16.0


def _central_diff(x: jax.Array, axis: int) -> jax.Array:
    """[-1, 0, 1]/2 central difference along axis with edge replication."""
    pad = [(0, 0), (0, 0)]
    pad[axis] = (1, 1)
    p = jnp.pad(x, pad, mode="edge")
    if axis == 0:
        return (p[2:, :] - p[:-2, :]) * 0.5
    return (p[:, 2:] - p[:, :-2]) * 0.5


def scharr_gradients(image: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Scharr x/y derivatives of one level (reference src/Tracker.cpp:1133-1138).

    Direct 9-tap form off ONE edge-padded buffer (both gradients share every
    tap load, and XLA fuses the whole thing into a single elementwise
    pass)."""
    p = jnp.pad(image, ((1, 1), (1, 1)), mode="edge")
    a = p[:-2, :-2]
    b = p[:-2, 1:-1]
    c = p[:-2, 2:]
    d = p[1:-1, :-2]
    f = p[1:-1, 2:]
    g = p[2:, :-2]
    h = p[2:, 1:-1]
    i = p[2:, 2:]
    gx = (3.0 * (c - a) + 10.0 * (f - d) + 3.0 * (i - g)) * (1.0 / 32.0)
    gy = (3.0 * (g - a) + 10.0 * (h - b) + 3.0 * (i - c)) * (1.0 / 32.0)
    return gx, gy


@partial(jax.jit, static_argnames=("levels",))
def build_pyramid(image: jax.Array, levels: int = PYRAMID_LEVELS) -> FramePyramid:
    """Level-0 image (H, W) float32 -> full pyramid with gradients, one fused
    XLA program. H and W must be divisible by 2^(levels-1)."""
    images = [image]
    for _ in range(levels - 1):
        images.append(downsample2x(images[-1]))
    gxs, gys, gms = [], [], []
    for img in images:
        gx, gy = scharr_gradients(img)
        gxs.append(gx)
        gys.append(gy)
        # reference: gradient_ = 0.5|gx| + 0.5|gy| (addWeighted at :1141)
        gms.append(0.5 * jnp.abs(gx) + 0.5 * jnp.abs(gy))
    return FramePyramid(
        images=tuple(images),
        grad_x=tuple(gxs),
        grad_y=tuple(gys),
        grad_mag=tuple(gms),
    )


def _scharr_batched(images: jax.Array):
    """(B, H, W) -> (gx, gy, 0.5(|gx| + |gy|)) through XLA."""
    gx, gy = jax.vmap(scharr_gradients)(images)
    return gx, gy, 0.5 * jnp.abs(gx) + 0.5 * jnp.abs(gy)


@partial(jax.jit, static_argnames=("levels",))
def build_pyramid_batched(
    images: jax.Array, levels: int = PYRAMID_LEVELS
) -> FramePyramid:
    """Batched pyramid build: (B, H, W) -> FramePyramid of (B, H_l, W_l)
    levels; identical math to vmap(build_pyramid). The GPU's gradient pass
    is the Pallas Triton kernel ops/scharr.py: on an H100 it runs level 0
    of the 96x480x640 chunk in 0.20 ms against XLA's 0.64 ms and the
    offline chunk 15% faster (PERF.md); the CPU has no Triton."""
    from ..ops.scharr import scharr_gradients_batched

    imgs = [images]
    for _ in range(levels - 1):
        b, h, w = imgs[-1].shape
        imgs.append(imgs[-1].reshape(b, h // 2, 2, w // 2, 2).mean(axis=(2, 4)))
    gxs, gys, gms = [], [], []
    for im in imgs:
        gx, gy, gm = platform.choose(
            _scharr_batched, scharr_gradients_batched, im
        )
        gxs.append(gx)
        gys.append(gy)
        gms.append(gm)
    return FramePyramid(
        images=tuple(imgs),
        grad_x=tuple(gxs),
        grad_y=tuple(gys),
        grad_mag=tuple(gms),
    )


@partial(jax.jit, static_argnames=("levels",))
def build_depth_pyramid(depth: jax.Array, levels: int = PYRAMID_LEVELS):
    """Depth pyramid via min-pooling-aware mean: zeros (invalid) are excluded
    from the average so borders of missing depth don't bleed.

    The reference naively cv::resizes depth (src/System.cpp:249-250); we keep
    shape parity but fix the invalid-bleed, documented divergence."""
    depths = [depth]
    for _ in range(levels - 1):
        d = depths[-1]
        H, W = d.shape
        blocks = d.reshape(H // 2, 2, W // 2, 2)
        valid = (blocks > 0).astype(d.dtype)
        num = (blocks * valid).sum(axis=(1, 3))
        den = valid.sum(axis=(1, 3))
        depths.append(jnp.where(den > 0, num / jnp.maximum(den, 1), 0.0))
    return tuple(depths)


def bilinear_sample_dense(images: jax.Array, uv: jax.Array):
    """Bilinear sampling as two dense one-hot contractions.

    images: (C, H, W) channel stack; uv: (N, 2). Returns ((C, N), valid (N,)).

    sample[c, n] = sum_h sum_w Wv[n, h] * images[c, h, w] * Wu[n, w]
    where Wv/Wu have the two bilinear taps per row. Cost O(N*H*W) MACs, so
    point tracking uses the 4-tap gather (`sample_stack`, 5x faster on an
    H100, PERF.md); photometric BA keeps this form. Out-of-bounds rows
    produce all-zero weights (fill = 0). Both contractions run at HIGHEST
    precision: full f32, no TF32 rounding on the GPU.
    """
    C, H, W = images.shape
    u, v = uv[..., 0], uv[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    du = (u - u0)[:, None]
    dv = (v - v0)[:, None]
    rows = jax.lax.broadcasted_iota(jnp.float32, (1, H), 1)
    cols = jax.lax.broadcasted_iota(jnp.float32, (1, W), 1)
    # Two taps per row: weight (1-dv) at v0, dv at v0+1 (same for u).
    Wv = (rows == v0[:, None]) * (1.0 - dv) + (rows == v0[:, None] + 1.0) * dv
    Wu = (cols == u0[:, None]) * (1.0 - du) + (cols == u0[:, None] + 1.0) * du
    hi = jax.lax.Precision.HIGHEST
    S = jnp.einsum("nh,chw->cnw", Wv, images,
                   preferred_element_type=jnp.float32, precision=hi)
    out = jnp.einsum("cnw,nw->cn", S, Wu,
                     preferred_element_type=jnp.float32, precision=hi)
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return jnp.where(valid[None, :], out, 0.0), valid


def sample_stack(images: jax.Array, uv: jax.Array):
    """Bilinear sampling of a (C, H, W) stack at (N, 2) points: one 4-tap
    gather per channel. Returns ((C, N) samples, zero outside, and (N,)
    in-window validity)."""
    chans = [bilinear_sample(images[c], uv) for c in range(images.shape[0])]
    return jnp.stack([c[0] for c in chans]), chans[0][1]


def bilinear_sample(image: jax.Array, uv: jax.Array, fill: float = 0.0):
    """Bilinear interpolation at subpixel coords: image (H, W), uv (..., 2).

    The reference rounds to nearest (src/Tracker.cpp:746); bilinear is a
    documented accuracy improvement (SURVEY.md §7.3)."""
    H, W = image.shape
    u, v = uv[..., 0], uv[..., 1]
    u0 = jnp.floor(u); v0 = jnp.floor(v)
    du = u - u0; dv = v - v0
    u0i = jnp.clip(u0.astype(jnp.int32), 0, W - 2)
    v0i = jnp.clip(v0.astype(jnp.int32), 0, H - 2)
    i00 = image[v0i, u0i]
    i01 = image[v0i, u0i + 1]
    i10 = image[v0i + 1, u0i]
    i11 = image[v0i + 1, u0i + 1]
    out = (
        i00 * (1 - du) * (1 - dv)
        + i01 * du * (1 - dv)
        + i10 * (1 - du) * dv
        + i11 * du * dv
    )
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return jnp.where(valid, out, fill), valid
