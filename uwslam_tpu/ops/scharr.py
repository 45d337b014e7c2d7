"""Scharr gradients of a batch of frames as ONE Pallas kernel through Triton.

XLA's form (image/pyramid.scharr_gradients: edge-padded 9-tap stencil, then
0.5(|gx|+|gy|)) is memory-bound. This kernel reads each (TH, TW) output
tile's 9 taps straight from the frame (edge replication by clamped
indices, the taps hit L1/L2) and writes gx, gy and |g| once: 4 x 4 bytes
per pixel, the least a separate gradient pass can move.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _tile(n: int, cap: int) -> int:
    """Largest power of two <= cap that divides n (tiles cover the frame
    exactly, so no store is masked)."""
    t = 1
    while t * 2 <= cap and n % (t * 2) == 0:
        t *= 2
    return t


def _kernel(img_ref, gx_ref, gy_ref, gm_ref, *, H, W, TH, TW):
    b, i, j = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    r = i * TH + jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 0)
    c = j * TW + jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 1)
    base = b * (H * W)

    def tap(dr, dc):
        rr = jnp.clip(r + dr, 0, H - 1)
        cc = jnp.clip(c + dc, 0, W - 1)
        return img_ref[base + rr * W + cc]

    a, b_, c_ = tap(-1, -1), tap(-1, 0), tap(-1, 1)
    d, f = tap(0, -1), tap(0, 1)
    g, h, i_ = tap(1, -1), tap(1, 0), tap(1, 1)
    gx = (3.0 * (c_ - a) + 10.0 * (f - d) + 3.0 * (i_ - g)) * (1.0 / 32.0)
    gy = (3.0 * (g - a) + 10.0 * (h - b_) + 3.0 * (i_ - c_)) * (1.0 / 32.0)
    out = base + r * W + c
    gx_ref[out] = gx
    gy_ref[out] = gy
    gm_ref[out] = 0.5 * jnp.abs(gx) + 0.5 * jnp.abs(gy)


@functools.partial(jax.jit, static_argnames=("interpret",))
def scharr_gradients_batched(x: jax.Array, interpret: bool = False):
    """(B, H, W) f32 -> (gx, gy, 0.5(|gx|+|gy|)), each (B, H, W)."""
    B, H, W = x.shape
    TH, TW = _tile(H, 16), _tile(W, 64)
    flat = jax.ShapeDtypeStruct((B * H * W,), jnp.float32)
    anyspec = pl.BlockSpec(memory_space=pl.ANY)
    gx, gy, gm = pl.pallas_call(
        functools.partial(_kernel, H=H, W=W, TH=TH, TW=TW),
        grid=(B, H // TH, W // TW),
        in_specs=[anyspec],
        out_specs=[anyspec, anyspec, anyspec],
        out_shape=[flat, flat, flat],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="scharr_gradients",
    )(x.astype(jnp.float32).reshape(B * H * W))
    return gx.reshape(B, H, W), gy.reshape(B, H, W), gm.reshape(B, H, W)
