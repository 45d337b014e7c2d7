"""End-to-end tracking throughput benchmark (one JSON line).

Measures tracked frames/sec of the offline hot path — pyramid build +
gradient maps + top-K point selection + 4-level coarse-to-fine photometric
LM tracking — at the reference's TUM design point (640x480 grayscale,
/root/reference/calibration/calibrationTUM.xml) on the GPU. It fails
without one; the JSON line names the platform, device kind and count.

vs_baseline anchors to 30 frames/s, the TUM camera rate.
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def main() -> None:
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks import device as dev

    dev.require_gpu()
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.image import build_pyramid
    from uwslam_tpu.lie import se3
    from uwslam_tpu.tracking import topk_gradient_points, track
    from uwslam_tpu.utils.synthetic import plane_depth, render_plane_view

    cam = PinholeCamera(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480
    )
    plane_z = 2.0

    # Pre-render a short synthetic sequence (rendering excluded from timing).
    # The twist follows a smooth sinusoid (period 24) so EVERY adjacent pair's motion
    # stays within the coarse level's convergence basin — a sawtooth wrap
    # would make 3 of 95 pairs jump by the full excursion and diverge,
    # polluting both the timing (those lanes run to the iteration cap) and
    # the tracked-pose validity.
    import math

    num_frames = 96
    amp = jnp.asarray([0.06, 0.024, 0.008, 0.004, -0.006, 0.008], jnp.float32)
    poses = [
        se3.exp(amp * math.sin(2.0 * math.pi * i / 24.0))
        for i in range(num_frames)
    ]
    frames = [render_plane_view(cam, T, plane_z) for T in poses]
    frames = [f.block_until_ready() for f in frames]
    depth0 = plane_depth(cam, jnp.eye(4), plane_z)

    levels = (3, 2, 1, 0)
    n_points = 2048

    def ingest(img):
        """Per-frame preprocessing: pyramid + gradient maps + point selection.
        Runs ONCE per frame; the result is carried to the next step (the
        reference re-uploads and re-processes both frames every iteration,
        src/Tracker.cpp:179-180)."""
        pyr = build_pyramid(img, levels=5)
        pts = topk_gradient_points(
            pyr.images[0], pyr.grad_mag[0], cam, num_points=n_points
        )
        u = pts.uv[:, 0].astype(jnp.int32).clip(0, cam.width - 1)
        v = pts.uv[:, 1].astype(jnp.int32).clip(0, cam.height - 1)
        pts = pts._replace(p3d=cam.unproject(pts.uv, depth0[v, u]))
        return pyr, pts

    def per_frame(prev_pyr, prev_pts, cur_img, T_init):
        cur_pyr, cur_pts = ingest(cur_img)
        out = track(
            prev_pyr, cur_pyr, prev_pts, cam, T_init=T_init,
            levels=levels, max_iters=10,
        )
        return cur_pyr, cur_pts, out.T

    del per_frame, ingest  # streaming path measured via CLI; headline below

    # Data-parallel sequence tracking: ingest is vmapped over frames and the
    # coarse-to-fine LM runs vmapped over all adjacent pairs — the whole chunk
    # is ONE device program, the replacement for the reference's per-frame
    # host loop; per-frame latency mode remains in SlamSystem, the scan path
    # in track_sequence.
    from uwslam_tpu.tracking import track_sequence_batched

    stacked = jnp.stack(frames)  # (N, H, W) device-resident

    # Per-level LM budget: sampling cost scales with level area, so the
    # coarse levels (which absorb the motion) get the iterations and the
    # fine levels only polish.
    iters_schedule = (12, 8, 5, 3)

    def run_chunk(fr):
        # Inverse-compositional mode: the constant reference-side Jacobian
        # means the hot loop samples 1 channel instead of 3 (intensity +
        # two gradients).
        T_rel, inliers, errors = track_sequence_batched(
            fr, cam, mono_z=2.0, levels=5, track_levels=levels,
            num_points=n_points, max_iters=iters_schedule, mode="ic",
        )
        return T_rel

    run = jax.jit(run_chunk)
    out = run(stacked)
    jax.block_until_ready(out)  # compile + warm

    # Pipelined dispatch: enqueue every chunk (jax dispatch is async), then
    # materialize every result on the host, so host-side dispatch overlaps
    # device compute; every output still transfers fully.
    passes = 6
    chunks = [(stacked + 0.25 * p) for p in range(passes)]
    jax.block_until_ready(chunks)
    t0 = time.perf_counter()
    outs = [run(c) for c in chunks]
    for out in outs:
        np.asarray(out)  # forces device completion + host transfer
    dt = time.perf_counter() - t0
    n_tracked = passes * (num_frames - 1)

    fps = n_tracked / dt
    baseline_fps = 30.0

    # Accuracy guard in the same JSON line (a speed-for-accuracy regression
    # must not pass unnoticed): ATE of the
    # UNSHIFTED chunk's composed trajectory against the exact render poses.
    from uwslam_tpu.io import ate_rmse
    from uwslam_tpu.tracking import compose_trajectory

    T_rel = run(stacked)
    est = np.asarray(compose_trajectory(T_rel))          # world<-camera, est
    gt = np.stack([np.asarray(se3.inverse(T)) for T in poses])
    ate = ate_rmse(est[:, :3, 3], gt[:, :3, 3])

    # BA iterations/sec at the window design point (BASELINE.json's third
    # metric): 10 keyframes (reference retention window) x 1024 landmarks,
    # fully connected — the shape system._run_window_ba solves. Steady-state
    # (post-compile) timing over a fresh perturbed problem.
    ba_line = _bench_ba_iters()

    print(
        json.dumps(
            {
                "metric": "tracked_frames_per_sec",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / baseline_fps, 3),
                "ate": round(float(ate), 5),
                "ba_iters_per_sec": ba_line,
                "device": dev.device_info(),
            }
        )
    )


def _bench_ba_iters() -> float:
    """Window-BA LM iterations per second at the design point (10 kf x 1024
    landmarks x 10240 obs, Schur-eliminated landmark blocks)."""
    import jax
    import jax.numpy as jnp

    from uwslam_tpu.ba import BAProblem, bundle_adjust
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3

    cam = PinholeCamera(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480
    )
    num_kf, num_lm = 10, 1024
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(7), 5)
    pts = jnp.stack(
        [
            jax.random.uniform(k1, (num_lm,), minval=-1.5, maxval=1.5),
            jax.random.uniform(k2, (num_lm,), minval=-1.0, maxval=1.0),
            jax.random.uniform(k3, (num_lm,), minval=2.0, maxval=5.0),
        ],
        axis=-1,
    )
    T_gt = jnp.stack(
        [
            se3.exp(jnp.asarray(
                [0.04 * i, 0.015 * i, 0.008 * i, 0.0, 0.01 * i, 0.0]
            ))
            for i in range(num_kf)
        ]
    )
    kf_idx = jnp.repeat(jnp.arange(num_kf), num_lm).astype(jnp.int32)
    lm_idx = jnp.tile(jnp.arange(num_lm), num_kf).astype(jnp.int32)
    p_c = se3.apply(T_gt[kf_idx], pts[lm_idx])
    uv = cam.project(p_c) + 0.3 * jax.random.normal(k4, (num_kf * num_lm, 2))
    valid = (
        (uv[:, 0] >= 0) & (uv[:, 0] <= cam.width - 1)
        & (uv[:, 1] >= 0) & (uv[:, 1] <= cam.height - 1)
        & (p_c[:, 2] > 0.1)
    )
    dT = 0.01 * jax.random.normal(k5, (num_kf, 6))
    dT = dT.at[0].set(0.0)
    T_init = jax.vmap(lambda T, d: se3.compose(se3.exp(d), T))(T_gt, dT)
    problem = BAProblem(
        T_cw=T_init, points=pts, obs_kf=kf_idx, obs_lm=lm_idx,
        obs_uv=uv, obs_valid=valid,
    )
    max_iters = 25
    out = bundle_adjust(problem, cam, max_iters=max_iters)  # compile + warm
    int(out.iterations)
    t0 = time.perf_counter()
    out = bundle_adjust(problem, cam, max_iters=max_iters)
    iters = int(out.iterations)  # device sync
    dt = time.perf_counter() - t0
    return round(iters / max(dt, 1e-9), 1)


if __name__ == "__main__":
    main()
