"""Patch descriptors: normalized intensity patches projected to a compact code.

Array replacement for SURF/ORB descriptors (reference
/root/reference/src/Tracker.cpp:195-223): each keypoint gets a (P*P) patch
sampled bilinearly at its detection scale, photometrically normalized
(zero-mean / unit-norm => invariant to affine lighting), then projected by a
fixed random Gaussian matrix to D dims (a Johnson-Lindenstrauss sketch — the
projection is one (K, P^2) x (P^2, D) matmul). Matching is then a
single (K, D) x (D, K) matmul; see match.py.

No rotation invariance — like the reference's tracking use-case (sequential
video, small inter-frame rotation); upright SURF ("U-SURF") makes the same
trade.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..image.pyramid import bilinear_sample

PATCH = 8          # patch side length (samples)
PATCH_SPACING = 2.0  # sample spacing in pixels at the detection level
DESC_DIM = 64


def _projection_matrix(dim_in: int, dim_out: int) -> jax.Array:
    key = jax.random.PRNGKey(1234)
    m = jax.random.normal(key, (dim_in, dim_out), dtype=jnp.float32)
    return m / jnp.sqrt(dim_in)


@partial(jax.jit, static_argnames=("patch", "dim"))
def describe(
    image_pyr: tuple[jax.Array, ...],
    uv: jax.Array,
    level: jax.Array,
    valid: jax.Array,
    patch: int = PATCH,
    dim: int = DESC_DIM,
) -> jax.Array:
    """Compute (K, dim) L2-normalized descriptors.

    `uv` are level-0 coords; each keypoint samples its patch from its own
    detection level (sum over levels with masks keeps shapes static).
    """
    K = uv.shape[0]
    half = (patch - 1) / 2.0
    offs = (jnp.arange(patch, dtype=jnp.float32) - half) * PATCH_SPACING
    du, dv = jnp.meshgrid(offs, offs, indexing="xy")
    offsets = jnp.stack([du.ravel(), dv.ravel()], axis=-1)  # (P2, 2)

    patches = jnp.zeros((K, patch * patch), jnp.float32)
    ok = jnp.zeros((K,), bool)
    for l, img in enumerate(image_pyr):
        uv_l = uv / (1 << l)
        coords = (uv_l[:, None, :] + offsets[None, :, :]).reshape(-1, 2)
        vals_f, inb_f = bilinear_sample(img, coords)
        vals = vals_f.reshape(K, patch * patch)
        inb = inb_f.reshape(K, patch * patch)
        sel = level == l
        patches = jnp.where(sel[:, None], vals, patches)
        ok = jnp.where(sel, jnp.all(inb, axis=-1), ok)

    mean = patches.mean(axis=-1, keepdims=True)
    centered = patches - mean
    norm = jnp.linalg.norm(centered, axis=-1, keepdims=True).clip(1e-6)
    normalized = centered / norm

    proj = _projection_matrix(patch * patch, dim)
    desc = jnp.dot(normalized, proj, preferred_element_type=jnp.float32)
    desc = desc / jnp.linalg.norm(desc, axis=-1, keepdims=True).clip(1e-6)
    return jnp.where((valid & ok)[:, None], desc, 0.0)
