"""Warp, project and 4-tap bilinear gather of a channel stack as ONE Pallas
kernel through Triton: the GPU's form of tracking.photometric._warp_sample
for one channel (inverse-compositional LM). Timed against XLA's form by
benchmarks/bringup_ab.py.

Each program takes a block of points: it applies the SE(3) warp, projects
with the pinhole model and gathers the four taps of every channel straight
from the level image (a 640x480 f32 level is 1.2 MB; the taps hit L2).
Semantics are those of `_warp_sample`: taps clamped to the image, a sample
is valid inside [0, W-1] x [0, H-1] and in front of the camera, invalid
samples are 0.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _kernel(T_ref, x_ref, y_ref, z_ref, img_ref, val_ref, ok_ref, *,
            C, H, W, NP, fx, fy, cx, cy, BLOCK):
    i = pl.program_id(0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    idx = i * BLOCK + lane

    def t(k):   # T[k // 4, k % 4], broadcast over the block
        return T_ref[jnp.full((BLOCK,), k, jnp.int32)]

    x, y, z = x_ref[...], y_ref[...], z_ref[...]
    xt = t(0) * x + t(1) * y + t(2) * z + t(3)
    yt = t(4) * x + t(5) * y + t(6) * z + t(7)
    zt = t(8) * x + t(9) * y + t(10) * z + t(11)
    sz = jnp.where(jnp.abs(zt) < 1e-9, 1e-9, zt)
    u = fx * xt / sz + cx
    v = fy * yt / sz + cy
    ok = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (zt > 1e-3)
    # Clamp in float before the int conversion (NaN and inf included).
    uf = jnp.floor(jnp.clip(jnp.where(u == u, u, 0.0), -2.0, W + 1.0))
    vf = jnp.floor(jnp.clip(jnp.where(v == v, v, 0.0), -2.0, H + 1.0))
    du, dv = u - uf, v - vf
    u0 = jnp.clip(uf.astype(jnp.int32), 0, W - 2)
    v0 = jnp.clip(vf.astype(jnp.int32), 0, H - 2)
    w00, w01 = (1 - du) * (1 - dv), du * (1 - dv)
    w10, w11 = (1 - du) * dv, du * dv
    for c in range(C):
        a = c * H * W + v0 * W + u0
        s = (img_ref[a] * w00 + img_ref[a + 1] * w01
             + img_ref[a + W] * w10 + img_ref[a + W + 1] * w11)
        val_ref[c * NP + idx] = jnp.where(ok, s, 0.0)
    ok_ref[...] = ok.astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("cam", "block", "interpret"))
def warp_sample(stacked: jax.Array, p3d: jax.Array, T: jax.Array, cam,
                block: int = 256, interpret: bool = False):
    """(C, H, W) stack, (N, 3) reference-frame points, (4, 4) T -> ((C, N)
    samples, (N,) ok), as tracking.photometric._warp_sample."""
    C, H, W = stacked.shape
    N = p3d.shape[0]
    NP = -(-N // block) * block
    coords = [jnp.pad(p3d[:, k], (0, NP - N), constant_values=1.0)
              for k in range(3)]
    anyspec = pl.BlockSpec(memory_space=pl.ANY)
    blk = pl.BlockSpec((block,), lambda i: (i,))
    vals, ok = pl.pallas_call(
        functools.partial(_kernel, C=C, H=H, W=W, NP=NP, fx=cam.fx,
                          fy=cam.fy, cx=cam.cx, cy=cam.cy, BLOCK=block),
        grid=(NP // block,),
        in_specs=[anyspec, blk, blk, blk, anyspec],
        out_specs=[anyspec, blk],
        out_shape=[jax.ShapeDtypeStruct((C * NP,), jnp.float32),
                   jax.ShapeDtypeStruct((NP,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="warp_sample",
    )(T.astype(jnp.float32).reshape(16), *coords,
      stacked.astype(jnp.float32).reshape(C * H * W))
    return vals.reshape(C, NP)[:, :N], ok[:N] != 0
