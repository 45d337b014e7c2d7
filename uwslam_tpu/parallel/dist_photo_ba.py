"""Distributed photometric window BA: observer keyframes sharded over a mesh.

The photometric BA lattice (owner i, observer j, point n) is data-parallel in
the OBSERVER axis: each device holds a slice of the window's keyframe images
(the big arrays — a 10-keyframe 640x480 window is ~37 MB of pyramid level
data; owner-side points/uv/intensities are a few hundred KB and stay
replicated) and computes the residuals/Jacobians for its observers. The
normal-equation blocks Hpp (K6,K6), Hpd (K6,K,N), Hdd (K,N), bp, bd are
psum-reduced across devices; the (tiny) Schur solve and the LM accept/reject run
replicated on every device, so the iterates stay bit-identical without any
further communication — one psum per LM iteration is the entire comm cost.

This is the photometric counterpart of parallel.dist_ba (landmark-sharded
reprojection BA); both compose with parallel.sequence's frame-chunk axis.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ba.photometric import (
    PhotoBAProblem,
    PhotoBAResult,
    _cost,
    _huber_w,
    _observations,
)
from ..camera.model import PinholeCamera
from ..lie import se3
from ..utils.precision import HIGHEST

PHOTO_AXIS = "obs"


@partial(
    jax.jit,
    static_argnames=("cam", "mesh", "max_iters", "optimize_depths"),
)
def distributed_photometric_ba(
    problem: PhotoBAProblem,
    cam: PinholeCamera,
    mesh: Mesh,
    max_iters: int = 12,
    huber_delta: float = 12.0,
    pose0_weight: float = 1e8,
    depth_prior: float = 1e-2,
    init_lambda: float = 1e-3,
    optimize_depths: bool = True,
) -> PhotoBAResult:
    """photometric_bundle_adjust over a mesh with axis `obs`.

    K must be padded to a multiple of the mesh size by the caller (pad with
    repeated keyframes marked fully invalid via problem.valid if needed);
    results are identical to the single-device optimizer up to float
    reduction order."""
    K, N = problem.inv_depth.shape
    D = mesh.shape[PHOTO_AXIS]
    assert K % D == 0, (
        f"window size {K} must divide over the {D}-device '{PHOTO_AXIS}' axis"
    )
    Kj = K // D

    # Shard observer-side images; replicate owner-side data.
    obs_idx = jnp.arange(K).reshape(D, Kj)

    def shard_body(images, gx, gy, obs_idx_local, T_cw0, uv, inv_d0,
                   intensity, valid):
        obs_idx_local = obs_idx_local[0]
        images, gx, gy = images[0], gx[0], gy[0]

        def make_problem(T_cw, inv_depth):
            return PhotoBAProblem(
                images=images, grad_x=gx, grad_y=gy, T_cw=T_cw, uv=uv,
                inv_depth=inv_depth, intensity=intensity, valid=valid,
            )

        def cost_at(T_cw, inv_depth):
            r, _, _, v = _observations(
                make_problem(T_cw, inv_depth), cam,
                observer_idx=obs_idx_local,
            )
            a = jnp.abs(r)
            rho = jnp.where(
                a <= huber_delta,
                0.5 * r * r,
                huber_delta * (a - 0.5 * huber_delta),
            )
            num = jax.lax.psum(jnp.where(v, rho, 0.0).sum(), PHOTO_AXIS)
            den = jax.lax.psum(v.sum(), PHOTO_AXIS)
            return num / jnp.maximum(den, 1)

        def step(T_cw, inv_depth, lam):
            r, Jp, Jd, v = _observations(
                make_problem(T_cw, inv_depth), cam,
                observer_idx=obs_idx_local,
            )
            w = _huber_w(r, v, huber_delta)
            wr = w * r
            Hpp = jax.lax.psum(
                jnp.einsum("ijnp,ijnq->pq", w[..., None] * Jp, Jp,
                           precision=HIGHEST),
                PHOTO_AXIS,
            )
            bp = jax.lax.psum(
                -jnp.einsum("ijnp,ijn->p", Jp, wr, precision=HIGHEST),
                PHOTO_AXIS,
            )
            gauge = jnp.zeros(K * 6).at[:6].set(pose0_weight)
            Hpp = Hpp + jnp.diag(gauge)
            Hpp = (
                Hpp + lam * jnp.diag(jnp.diag(Hpp))
                + 1e-6 * jnp.eye(K * 6)
            )
            if optimize_depths:
                Hpd = jax.lax.psum(
                    jnp.einsum("ijnp,ijn->pin", w[..., None] * Jp, Jd,
                               precision=HIGHEST),
                    PHOTO_AXIS,
                )
                Hdd = jax.lax.psum(
                    jnp.einsum("ijn,ijn->in", w * Jd, Jd,
                               precision=HIGHEST),
                    PHOTO_AXIS,
                )
                bd = jax.lax.psum(
                    -jnp.einsum("ijn,ijn->in", Jd, wr, precision=HIGHEST),
                    PHOTO_AXIS,
                )
                Hdd = Hdd * (1.0 + lam) + depth_prior
                Hdd_inv = 1.0 / jnp.maximum(Hdd, 1e-12)
                S = Hpp - jnp.einsum(
                    "pin,in,qin->pq", Hpd, Hdd_inv, Hpd, precision=HIGHEST
                )
                rhs = bp - jnp.einsum(
                    "pin,in,in->p", Hpd, Hdd_inv, bd, precision=HIGHEST
                )
                dp = jnp.linalg.solve(S, rhs)
                dd = Hdd_inv * (
                    bd - jnp.einsum("pin,p->in", Hpd, dp,
                                    precision=HIGHEST)
                )
            else:
                dp = jnp.linalg.solve(Hpp, bp)
                dd = jnp.zeros_like(inv_depth)
            dp = dp.reshape(K, 6)
            T_new = jax.vmap(
                lambda d, T: se3.normalize(se3.compose(se3.exp(d), T))
            )(dp, T_cw)
            d_new = jnp.maximum(inv_depth + dd, 1e-4)
            ok = jnp.all(jnp.isfinite(dp)) & jnp.all(jnp.isfinite(dd))
            return (
                jnp.where(ok, T_new, T_cw),
                jnp.where(ok, d_new, inv_depth),
                ok,
            )

        c0 = cost_at(T_cw0, inv_d0)

        def body(s):
            T, d, c, lam, k, done = s
            T_new, d_new, ok = step(T, d, lam)
            c_new = cost_at(T_new, d_new)
            accept = ok & jnp.isfinite(c_new) & (c_new < c)
            return (
                jnp.where(accept, T_new, T),
                jnp.where(accept, d_new, d),
                jnp.where(accept, c_new, c),
                jnp.where(accept, lam * 0.5, lam * 4.0).clip(1e-8, 1e4),
                k + 1,
                (lam > 1e3)
                | (accept & (jnp.abs(c - c_new) < 1e-7 * (c + 1e-9))),
            )

        init = (
            T_cw0, inv_d0, c0, jnp.asarray(init_lambda), jnp.asarray(0),
            jnp.asarray(False),
        )
        T_f, d_f, c_f, _, k_f, _ = jax.lax.while_loop(
            lambda s: (~s[5]) & (s[4] < max_iters), body, init
        )
        return T_f[None], d_f[None], c_f[None], c0[None], k_f[None]

    T_f, d_f, c_f, c0, k_f = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(
            P(PHOTO_AXIS), P(PHOTO_AXIS), P(PHOTO_AXIS), P(PHOTO_AXIS),
            P(), P(), P(), P(), P(),
        ),
        out_specs=P(PHOTO_AXIS),
        check_vma=False,
    )(
        problem.images.reshape(D, Kj, *problem.images.shape[1:]),
        problem.grad_x.reshape(D, Kj, *problem.grad_x.shape[1:]),
        problem.grad_y.reshape(D, Kj, *problem.grad_y.shape[1:]),
        obs_idx,
        problem.T_cw, problem.uv, problem.inv_depth,
        problem.intensity, problem.valid,
    )
    # All shards hold identical replicated results; take shard 0's.
    return PhotoBAResult(
        T_cw=T_f[0], inv_depth=d_f[0], cost=c_f[0],
        initial_cost=c0[0], iterations=k_f[0],
    )
