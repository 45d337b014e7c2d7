"""Per-stage budget attribution for the offline headline (VERDICT r4 #4).

Times each stage of the bench.py chunk program in isolation on the GPU
(it fails without one): pyramid build, point selection, per-level LM
tracking, and the full program. Prints a JSON budget table; the per-op
budget from a profiler trace is benchmarks/attribute_trace.py.

Run: python benchmarks/offline_budget.py
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks import device as dev


def _time(fn, *args, reps=5):
    """Steady-state seconds/call, each call fenced by block_until_ready."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps


def main() -> None:
    dev.require_gpu()
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.image.pyramid import build_pyramid_batched
    from uwslam_tpu.lie import se3
    from uwslam_tpu.tracking import topk_gradient_points, track
    from uwslam_tpu.tracking.sequence import track_sequence_batched
    from uwslam_tpu.utils.synthetic import render_plane_view

    cam = PinholeCamera(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480
    )
    num_frames = 96
    amp = jnp.asarray([0.06, 0.024, 0.008, 0.004, -0.006, 0.008], jnp.float32)
    poses = [
        se3.exp(amp * math.sin(2.0 * math.pi * i / 24.0))
        for i in range(num_frames)
    ]
    frames = jnp.stack(
        [render_plane_view(cam, T, 2.0) for T in poses]
    ).block_until_ready()

    levels = (3, 2, 1, 0)
    n_points = 2048
    iters_schedule = (12, 8, 5, 3)

    rows = []

    def add(name, sec, note=""):
        rows.append(
            {"stage": name, "ms_per_chunk": round(sec * 1e3, 2), "note": note}
        )

    # 1. Batched pyramid alone.
    pyr_fn = jax.jit(lambda fr: build_pyramid_batched(fr, levels=5))
    add("pyramid5_batched(b96)", _time(pyr_fn, frames))
    pyrs = pyr_fn(frames)

    # 2. Point selection alone (on prebuilt pyramids).
    def sel(img0, gmag0):
        return topk_gradient_points(
            img0, gmag0, cam, num_points=n_points, mono_z=2.0
        )

    sel_fn = jax.jit(jax.vmap(sel))
    add("topk_select(b96)", _time(sel_fn, pyrs.images[0], pyrs.grad_mag[0]))
    pts = sel_fn(pyrs.images[0], pyrs.grad_mag[0])

    # 3. Tracking alone (on prebuilt pyramids + points), per level-prefix so
    # the marginal cost of each pyramid level is visible.
    ref_pyr = jax.tree.map(lambda x: x[:-1], pyrs)
    tgt_pyr = jax.tree.map(lambda x: x[1:], pyrs)
    ref_pts = jax.tree.map(lambda x: x[:-1], pts)

    prev = 0.0
    for n_lv in range(1, len(levels) + 1):
        lv = levels[:n_lv]
        it = iters_schedule[:n_lv]

        def one(rp, tp, p, lv=lv, it=it):
            out = track(
                rp, tp, p, cam, T_init=None, levels=lv, max_iters=it,
                mode="ic",
            )
            return out.T

        fn = jax.jit(jax.vmap(one))
        sec = _time(fn, ref_pyr, tgt_pyr, ref_pts)
        add(
            f"track_levels{lv}(b95)",
            sec,
            f"marginal level {lv[-1]}: {1e3 * (sec - prev):+.2f} ms",
        )
        prev = sec

    # 4. Full chunk program (what bench.py times), plus its pipelined rate.
    def run_chunk(fr):
        T_rel, _, _ = track_sequence_batched(
            fr, cam, mono_z=2.0, levels=5, track_levels=levels,
            num_points=n_points, max_iters=iters_schedule, mode="ic",
        )
        return T_rel

    run = jax.jit(run_chunk)
    sec = _time(run, frames)
    add("full_chunk(b96)", sec, "single-dispatch steady state")
    fps_serial = (num_frames - 1) / sec

    passes = 6
    chunks = [(frames + 0.25 * p) for p in range(passes)]
    jax.block_until_ready(chunks)
    outs = [run(c) for c in chunks]
    for o in outs:
        np.asarray(o)
    t0 = time.perf_counter()
    outs = [run(c) for c in chunks]
    for o in outs:
        np.asarray(o)
    dt = time.perf_counter() - t0
    fps_pipe = passes * (num_frames - 1) / dt

    out = {
        "device": dev.device_info(),
        "budget": rows,
        "fps_serial": round(fps_serial, 1),
        "fps_pipelined": round(fps_pipe, 1),
    }
    print(json.dumps(out, indent=1))
    if "--out" in sys.argv:
        path = sys.argv[sys.argv.index("--out") + 1]
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
