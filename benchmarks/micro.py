"""Per-kernel microbenchmarks — achieved throughput vs the card's peaks.

SURVEY.md §7 item 10: each hot op of the tracking stack measured in
isolation on the GPU, with a roofline share (memory-bound ops against the
card's HBM bandwidth, contractions against its float32 peak — they run at
precision=HIGHEST) so regressions and headroom are visible per kernel, not
just end-to-end. Peaks come from benchmarks/device.py, keyed by the
device kind; an unknown kind is an error.

Each kernel is measured by DEVICE time: one warmed invocation under
jax.profiler.trace, reading the GPU's busy time from the timeline.

Usage: python benchmarks/micro.py [--out FILE]  ->  one JSON line per kernel.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from benchmarks import device as dev

B = 96          # frame batch
H, W = 480, 640
N_PTS = 2048


def device_time_s(jitted, args) -> float:
    """One warmed call under jax.profiler.trace; the GPU's busy time."""
    jax.block_until_ready(jitted(*args))
    tmp = tempfile.mkdtemp(prefix="uwslam_micro_")
    try:
        with jax.profiler.trace(tmp):
            jax.block_until_ready(jitted(*args))
        return dev.device_busy_us(tmp) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.image import build_pyramid
    from uwslam_tpu.image.pyramid import (
        bilinear_sample_dense,
        build_pyramid_batched,
        sample_stack,
        scharr_gradients,
    )
    from uwslam_tpu.lie import se3
    from uwslam_tpu.tracking import topk_gradient_points
    from uwslam_tpu.utils.precision import HIGHEST

    d = dev.require_gpu()
    pk = dev.peaks(d.device_kind)
    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                        width=W, height=H)
    k_img, k_u, k_v, k_J, k_H, k_tw = jax.random.split(
        jax.random.PRNGKey(0), 6
    )
    frames = jax.random.uniform(k_img, (B, H, W), jnp.float32) * 255.0
    uv = jnp.stack(
        [jax.random.uniform(k_u, (B, N_PTS)) * (W - 2),
         jax.random.uniform(k_v, (B, N_PTS)) * (H - 2)], axis=-1)
    stacked3 = jnp.stack([frames, frames, frames], axis=1)  # (B, 3, H, W)
    J = jax.random.normal(k_J, (B, N_PTS, 6))
    Hmat = jnp.eye(6) * 10.0 + 0.1 * jax.random.normal(k_H, (B, 6, 6))
    Hmat = Hmat @ jnp.swapaxes(Hmat, -1, -2)
    tw = jax.random.normal(k_tw, (65536, 6)) * 0.1

    px = B * H * W * 4

    # (name, jitted fn, args, work_bytes, work_flops, note)
    cases = [
        (
            "pyramid5+scharr(b96)",
            jax.jit(jax.vmap(lambda im: build_pyramid(im, levels=5))),
            (frames,),
            int(px * (1 + 4 * 1.33)), None,
            "5-level pyramid + Scharr x/y + |grad|, vmapped",
        ),
        (
            "scharr_l0(b96)",
            jax.jit(jax.vmap(scharr_gradients)),
            (frames,),
            px * 3, None, "",
        ),
        (
            "pyramid5_batched(b96)",
            jax.jit(lambda f: build_pyramid_batched(f, levels=5)),
            (frames,),
            int(px * (1 + 4 * 1.33)), None,
            "tracking's batched pyramid (the GPU's Scharr kernel)",
        ),
        (
            "sample_c3(b96,n2048)",
            jax.jit(jax.vmap(sample_stack)),
            (stacked3, uv),
            B * 3 * N_PTS * 4 * 4, None,
            "fc hot-loop op: the platform's point sampling, 3 channels",
        ),
        (
            "sample_dense_c3(b96,n2048)",
            jax.jit(jax.vmap(bilinear_sample_dense)),
            (stacked3, uv),
            None, 2 * B * 3 * N_PTS * H * W,
            "one-hot contraction form (photometric BA), HIGHEST",
        ),
        (
            "sample_dense_c1(b96,n2048)",
            jax.jit(jax.vmap(bilinear_sample_dense)),
            (frames[:, None], uv),
            None, 2 * B * N_PTS * H * W,
            "one-hot contraction form, intensity only, HIGHEST",
        ),
        (
            "normal_eq_6x6(b96,n2048)",
            jax.jit(lambda Jb: (
                jnp.einsum("bni,bnj->bij", Jb, Jb, precision=HIGHEST),
                jnp.einsum("bni,bn->bi", Jb, Jb[..., 0], precision=HIGHEST),
            )),
            (J,),
            B * N_PTS * 6 * 4 * 2, None,
            "HIGHEST precision; HBM-bound at N=2048",
        ),
        (
            "solve_6x6(b96)",
            jax.jit(lambda Hb: jnp.linalg.solve(
                Hb, Hb[..., :1]).squeeze(-1)),
            (Hmat,),
            None, None, "batched LU, latency-bound",
        ),
        (
            "topk_points(b96)",
            jax.jit(jax.vmap(
                lambda im: topk_gradient_points(
                    im, im, cam, num_points=N_PTS, mono_z=2.0, block=8
                ).uv)),
            (frames,),
            px * 2, None, "block argmax + top-K + unproject",
        ),
        (
            "se3_exp_compose_inv(65k)",
            jax.jit(lambda t: se3.compose(
                se3.exp(t), se3.inverse(se3.exp(t)))),
            (tw,),
            65536 * 6 * 4 * 2, None, "geometry backbone, batched",
        ),
    ]

    records = []
    for name, fn, args, wb, wf, note in cases:
        s = device_time_s(fn, args)
        rec = {"kernel": name, "us_per_op": round(s * 1e6, 1)}
        if wb:
            g = wb / s / 1e9
            rec["GB_s"] = round(g, 1)
            rec["pct_hbm_roofline"] = round(100 * g / pk["hbm_GBps"], 1)
        if wf:
            t = wf / s / 1e12
            rec["TFLOP_s"] = round(t, 2)
            rec["pct_fp32_roofline"] = round(100 * t / pk["fp32_TFLOPs"], 1)
        if note:
            rec["note"] = note
        print(json.dumps(rec))
        records.append(rec)

    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]
        payload = {
            "device": dev.device_info(),
            "jax": jax.__version__,
            "kernels": records,
        }
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
