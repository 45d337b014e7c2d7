"""A/B of the forms each GPU choice was made between, on the card.

    python benchmarks/bringup_ab.py [--only chunk,pyramid,features]
                                    [--rounds 3] [--out FILE]

- chunk: the offline chunk at the bench design point (96 frames of
  640x480, 95 pairs, 2048 points, 5 levels tracked over 3..0 with
  iterations (12, 8, 5, 3)), IC and FC, in each point-sampling form:
  XLA's 4-tap gather (kept for FC), the one-hot contraction at HIGHEST
  (image.pyramid.bilinear_sample_dense), the Pallas Triton warp + project +
  gather kernel (ops/warp_sample.py, kept for IC); and the IC chunk with
  XLA's Scharr stencil in place of the Triton kernel ops/scharr.py. Every
  form is compiled ahead of time, then the forms run in interleaved rounds:
  wall median of 5 calls and the device busy time of one call per round.
  ATE is that of the composed chunk trajectory against the render poses.
- pyramid: level-0 Scharr gradients and the 5-level batched pyramid at
  96x480x640, XLA against the Triton kernel, device time and share of the
  HBM bound (the least traffic: read each level once, write gx, gy, |g|),
  beside a plain copy's device bandwidth.
- features: the feature front end as the CLI runs it (640x480, 48 frames,
  --features --depth-bootstrap): first-run wall time (compilation
  included), warm ms/frame, ATE.

Needs a GPU. Prints one JSON object per result line, each with the card's
name and power limit, and writes them all to --out.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import device as dev  # noqa: E402

B, H, W, N_PTS = 96, 480, 640, 2048
ITERS = (12, 8, 5, 3)


def device_ms(fn, *args) -> float:
    tmp = tempfile.mkdtemp(prefix="uwslam_ab_")
    try:
        with jax.profiler.trace(tmp):
            jax.block_until_ready(fn(*args))
        return dev.device_busy_us(tmp) / 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def wall_ms(fn, *args, n: int = 5) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


@contextlib.contextmanager
def form(sampler: str, scharr: str):
    """Trace the tracking code with one point-sampling form and one Scharr
    form: module attributes the tracking code reads at trace time."""
    from uwslam_tpu import platform
    from uwslam_tpu.image import pyramid
    from uwslam_tpu.tracking import photometric

    from uwslam_tpu.ops.warp_sample import warp_sample

    saved = (photometric._warp_sample, photometric.sample_stack,
             platform.choose)
    photometric._warp_sample = photometric._warp_sample_xla
    if sampler == "onehot":
        photometric.sample_stack = pyramid.bilinear_sample_dense
    elif sampler == "triton":
        photometric._warp_sample = (
            lambda stacked, p3d, T, cam: warp_sample(stacked, p3d, T, cam))
    if scharr == "xla":
        platform.choose = lambda cpu_form, gpu_form, *a: cpu_form(*a)
    jax.clear_caches()
    try:
        yield
    finally:
        (photometric._warp_sample, photometric.sample_stack,
         platform.choose) = saved
        jax.clear_caches()


def bench_frames():
    """bench.py's sequence: a textured plane at 2 m, smooth sinusoidal
    motion (period 24 frames)."""
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3
    from uwslam_tpu.utils.synthetic import render_plane_view

    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=W,
                        height=H)
    amp = jnp.asarray([0.06, 0.024, 0.008, 0.004, -0.006, 0.008])
    poses = [se3.exp(amp * math.sin(2.0 * math.pi * i / 24.0))
             for i in range(B)]
    frames = jnp.stack([render_plane_view(cam, T, 2.0) for T in poses])
    gt = np.stack([np.asarray(se3.inverse(T))[:3, 3] for T in poses])
    return cam, frames, gt


CHUNK_FORMS = (
    ("ic", "gather", "triton"), ("ic", "onehot", "triton"),
    ("ic", "triton", "triton"), ("ic", "gather", "xla"),
    ("fc", "gather", "triton"), ("fc", "onehot", "triton"),
    ("fc", "triton", "triton"),
)


def ab_chunk(emit, rounds: int):
    from uwslam_tpu.io import ate_rmse
    from uwslam_tpu.tracking import compose_trajectory, track_sequence_batched

    cam, frames, gt = bench_frames()
    compiled = {}
    for mode, sampler, scharr in CHUNK_FORMS:
        name = f"{mode}/sample={sampler}/scharr={scharr}"
        with form(sampler, scharr):
            t0 = time.perf_counter()
            run = jax.jit(lambda fr, mode=mode: track_sequence_batched(
                fr, cam, mono_z=2.0, levels=5, track_levels=(3, 2, 1, 0),
                num_points=N_PTS, max_iters=ITERS, mode=mode)[0]
            ).lower(frames).compile()
            dt = time.perf_counter() - t0
        est = np.asarray(compose_trajectory(run(frames)))[:, :3, 3]
        compiled[name] = run
        emit({"ab": "chunk", "form": name, "compile_s": dt,
              "ate_m": float(ate_rmse(est, gt))})
    for r in range(rounds):
        names = list(compiled) if r % 2 == 0 else list(compiled)[::-1]
        for name in names:
            run = compiled[name]
            emit({"ab": "chunk", "form": name, "round": r,
                  "wall_ms": wall_ms(run, frames),
                  "device_ms": device_ms(run, frames)})


def ab_pyramid(emit, rounds: int):
    from uwslam_tpu.image.pyramid import _scharr_batched, build_pyramid_batched
    from uwslam_tpu.ops.scharr import scharr_gradients_batched

    hbm = dev.peaks(jax.devices()[0].device_kind)["hbm_GBps"] * 1e9
    x = jax.random.uniform(jax.random.PRNGKey(0), (B, H, W)) * 255.0
    l0_bytes = B * H * W * 4 * 4
    pyr_bytes = sum(B * (H >> lv) * (W >> lv) * 4 * 4 for lv in range(5))
    cases = {"level0/xla": (jax.jit(_scharr_batched), l0_bytes),
             "level0/triton": (jax.jit(scharr_gradients_batched), l0_bytes)}
    for scharr in ("xla", "triton"):
        with form("gather", scharr):
            fn = jax.jit(lambda f: build_pyramid_batched(f, levels=5)
                         ).lower(x).compile()
        cases[f"pyramid5/{scharr}"] = (fn, pyr_bytes)
    copy = jax.jit(lambda f: f + 1.0)
    for r in range(rounds):
        for name, (fn, nbytes) in cases.items():
            jax.block_until_ready(fn(x))
            ms = device_ms(fn, x)
            emit({"ab": "pyramid", "case": name, "round": r,
                  "device_ms": ms, "wall_ms": wall_ms(fn, x),
                  "bound_ms": nbytes / hbm * 1e3,
                  "share_of_hbm_bound": nbytes / hbm * 1e3 / ms})
        jax.block_until_ready(copy(x))
        ms = device_ms(copy, x)
        emit({"ab": "pyramid", "case": "copy", "round": r, "device_ms": ms,
              "device_GBps": 2 * x.nbytes / ms / 1e6})


def ab_features(emit):
    import chip_smoke

    work = tempfile.mkdtemp(prefix="uwslam_ab_features_")
    try:
        tum = chip_smoke.write_tum(os.path.join(work, "tum"), n=48)
        est = os.path.join(work, "est.txt")
        t0 = time.perf_counter()
        text, fps = chip_smoke.run_cli(
            ["-d", tum["rgb"], "-c", tum["calib"], "--tum-gt", tum["gt"],
             "--levels", "5", "--num-points", str(N_PTS), "--mono-depth",
             "2.0", "--features", "--depth-bootstrap",
             "--trajectory-out", est])
        total = time.perf_counter() - t0
        ate, _ = chip_smoke._ate(est, tum["gt_pos"])
        emit({"ab": "features", "form": "cusolver", "first_run_s": total,
              "warm_ms_per_frame": 1e3 / fps if fps else None,
              "ate_m": ate})
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="chunk,pyramid,features")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev.require_gpu()
    card = dev.device_info()["nvidia_smi"]
    lines = []

    def emit(rec):
        rec = {"card": card, **rec}
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    only = args.only.split(",")
    if "pyramid" in only:
        ab_pyramid(emit, args.rounds)
    if "chunk" in only:
        ab_chunk(emit, args.rounds)
    if "features" in only:
        ab_features(emit)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
