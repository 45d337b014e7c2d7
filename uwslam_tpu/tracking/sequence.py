"""Batched sequence tracking: the whole frame loop as ONE device program.

The reference processes frames in a strictly sequential host loop
(/root/reference/src/main_uw_slam.cpp:139-151), paying a host<->device round
trip per frame. Here (SURVEY.md §2 parallelism table:
"batched/pipelined frame processing"): frames are stacked on device and the
per-frame pipeline — pyramid build, gradient maps, top-K point selection,
coarse-to-fine LM tracking — runs under lax.scan, so a whole chunk of N
frames costs one dispatch. Latency-sensitive callers keep the per-frame path
(tracking.track); throughput callers (offline odometry, benchmarking,
dataset evaluation) use this.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera.model import PinholeCamera
from ..image.pyramid import build_pyramid
from .photometric import track
from .points import topk_gradient_points


@partial(
    jax.jit,
    static_argnames=(
        "cam", "levels", "track_levels", "num_points", "max_iters", "block",
        "mode", "affine",
    ),
)
def track_sequence(
    frames: jax.Array,
    cam: PinholeCamera,
    depth_frames: jax.Array | None = None,
    mono_z: float = 1.0,
    levels: int = 5,
    track_levels: tuple[int, ...] = (3, 2, 1, 0),
    num_points: int = 2048,
    max_iters: int = 10,
    block: int = 8,
    mode: str = "fc",
    affine: bool = False,
):
    """Track a stacked sequence (N, H, W) -> relative poses (N-1, 4, 4).

    Each output T[i] maps frame-i coordinates to frame-i+1 coordinates.
    Constant-velocity initialization threads through the scan carry.
    Returns (T_rel (N-1,4,4), inliers (N-1,), errors (N-1,)).
    """

    def ingest(img, depth_img):
        pyr = build_pyramid(img, levels=levels)
        pts = topk_gradient_points(
            pyr.images[0], pyr.grad_mag[0], cam,
            depth_image=depth_img, num_points=num_points,
            mono_z=mono_z, block=block,
            grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0],
        )
        return pyr, pts

    # Ingest stays INSIDE the scan: prebuilding all pyramids with vmap was
    # measured 1.9x SLOWER end-to-end (147 vs 281 fps) — the (N, 5-level)
    # pyramid stacks round-trip through HBM, while inline ingest fuses into
    # the per-step program and its activations stay on-chip.
    d0 = depth_frames[0] if depth_frames is not None else None
    pyr0, pts0 = ingest(frames[0], d0)

    def step(carry, inputs):
        prev_pyr, prev_pts, T_init = carry
        if depth_frames is not None:
            img, depth = inputs
        else:
            img, depth = inputs, None
        cur_pyr, cur_pts = ingest(img, depth)
        out = track(
            prev_pyr, cur_pyr, prev_pts, cam,
            T_init=T_init, levels=track_levels, max_iters=max_iters,
            mode=mode, affine=affine,
        )
        return (cur_pyr, cur_pts, out.T), (out.T, out.inliers, out.error)

    xs = (
        (frames[1:], depth_frames[1:])
        if depth_frames is not None
        else frames[1:]
    )
    _, (T_rel, inliers, errors) = jax.lax.scan(
        step, (pyr0, pts0, jnp.eye(4, dtype=jnp.float32)), xs
    )
    return T_rel, inliers, errors


@partial(
    jax.jit,
    static_argnames=(
        "cam", "levels", "track_levels", "num_points", "max_iters", "block",
        "mode", "affine",
    ),
)
def track_sequence_batched(
    frames: jax.Array,
    cam: PinholeCamera,
    depth_frames: jax.Array | None = None,
    mono_z: float = 1.0,
    levels: int = 5,
    track_levels: tuple[int, ...] = (3, 2, 1, 0),
    num_points: int = 2048,
    max_iters: int = 10,
    block: int = 8,
    mode: str = "fc",
    affine: bool = False,
):
    """Fully data-parallel sequence tracking: every adjacent frame pair is an
    independent vmapped LM problem (identity initialization).

    Where `track_sequence` scans frames sequentially (carrying a
    constant-velocity prior — the robust choice for live odometry), this
    variant removes the serial dependency entirely: ingest is vmapped over
    frames and the coarse-to-fine LM runs vmapped over all N-1 pairs, so the
    per-iteration work is one large batched program instead of N-1 small
    dispatches inside a scan.

    Identity init assumes adjacent-frame motion is within the coarse level's
    convergence basin (the reference's own operating regime — it never uses a
    motion prior either, src/Tracker.cpp:654 starts from identity). For fast
    motion prefer `track_sequence`.

    Returns (T_rel (N-1,4,4), inliers (N-1,), errors (N-1,)) with T_rel[i]
    mapping frame-i coordinates to frame-i+1 coordinates.
    """

    from ..image.pyramid import build_pyramid_batched

    # Batched pyramid; selection stays vmapped per frame.
    pyrs = build_pyramid_batched(frames, levels=levels)

    def select(img0, gmag0, gx0, gy0, depth_img):
        return topk_gradient_points(
            img0, gmag0, cam,
            depth_image=depth_img, num_points=num_points,
            mono_z=mono_z, block=block, grad_x=gx0, grad_y=gy0,
        )

    if depth_frames is not None:
        pts = jax.vmap(select)(
            pyrs.images[0], pyrs.grad_mag[0], pyrs.grad_x[0], pyrs.grad_y[0],
            depth_frames,
        )
    else:
        pts = jax.vmap(lambda i, g, gx, gy: select(i, g, gx, gy, None))(
            pyrs.images[0], pyrs.grad_mag[0], pyrs.grad_x[0], pyrs.grad_y[0]
        )

    ref_pyr = jax.tree.map(lambda x: x[:-1], pyrs)
    tgt_pyr = jax.tree.map(lambda x: x[1:], pyrs)
    ref_pts = jax.tree.map(lambda x: x[:-1], pts)

    def one(rp, tp, p):
        out = track(
            rp, tp, p, cam, T_init=None,
            levels=track_levels, max_iters=max_iters, mode=mode,
            affine=affine,
        )
        return out.T, out.inliers, out.error

    T_rel, inliers, errors = jax.vmap(one)(ref_pyr, tgt_pyr, ref_pts)
    return T_rel, inliers, errors


def compose_trajectory(T_rel: jax.Array) -> jax.Array:
    """Relative poses (N-1, 4, 4) (cur <- prev) -> world poses (N, 4, 4)
    T_wc with frame 0 at identity, via an associative scan (log-depth compose).
    """
    from ..lie import se3
    from ..utils.precision import mm

    # T_wc[i+1] = T_wc[i] @ inv(T_rel[i]).
    steps = se3.inverse(T_rel)
    chain = jax.lax.associative_scan(mm, steps)
    eye = jnp.eye(4, dtype=T_rel.dtype)[None]
    return jnp.concatenate([eye, chain], axis=0)
