#!/usr/bin/env python3
"""uwslam-tpu's main path on one GPU, end to end, at the TUM design point.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # four cards: distributed phases only

One process drives the card. Data is written from a seed into .smoke/ in
the checkout (removed at the end); nothing is downloaded. Phases:

1. device   — JAX must find a GPU; otherwise exit non-zero with no result.
2. parity   — each op on the GPU against a plain numpy float64 reference at
              real widths: the Scharr pyramid (one 640x480 frame and the
              96x480x640 chunk, whose gradients run the Pallas Triton
              kernel ops/scharr.py, also checked on its own), bilinear
              point sampling (2048 points on a 640x480 three-channel
              stack; warp + sample, whose one-channel form runs the Pallas
              Triton kernel ops/warp_sample.py), the feature path's small
              decompositions (cuSOLVER) and utils/linalg.py's helpers
              (degenerate inputs included), and EuRoC rectification
              (752x480 -> 736x480).
3. cli      — uwslam_tpu.cli.main.main on a seeded synthetic TUM directory
              (640x480, fx=fy=525, 64 frames) and a EuRoC one (752x480,
              radtan): (a) live direct tracking, (b) --features --ba,
              (c) --offline --track-mode ic --chunk 64, also compared with a
              CPU child run (JAX_PLATFORMS=cpu) of the first 16 frames,
              (d) --euroc. Each fails above its ATE bound; warm fps is
              printed for information only.

With --four-cards the script runs only the distributed BA over a 4-GPU
landmark mesh (a config-5-sized map and one with 10x the landmarks) against
single-device bundle_adjust, and track_sequence_sharded over 4 GPUs against
track_sequence_batched on one, checking that shards really sit on 4 devices.

Every result line carries the card's name and power limit. A failed phase
makes the script exit 1 after the others ran; on success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TUM_CAM = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
N_FRAMES = 64
N_POINTS = 2048

# ATE bounds (m, Sim(3)-aligned) are the ones the CPU tests hold for the
# same paths: tests/test_system.py + test_cli_offline.py (direct, offline
# IC: 0.01), tests/test_system_ba.py (features + window BA: 0.02),
# tests/test_euroc_rectify.py (rectified EuRoC: 0.02).
ATE_BOUND = {"a": 0.01, "b": 0.02, "c": 0.01, "d": 0.02}
# GPU vs CPU offline trajectory over the first 16 frames (m): both run the
# same gather sampling; they differ only by float reduction order.
CPU_GPU_POSE_TOL = 2e-3


class PhaseFailure(AssertionError):
    pass


def card_name_and_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            return lines[0].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "nvidia-smi unavailable"


class Report:
    """Prints every result beside the card's name and power limit."""

    def __init__(self, tag: str):
        self.tag = tag
        self.failed: list[str] = []

    def line(self, phase: str, ok: bool, text: str) -> None:
        print(f"[{self.tag}] {phase}: {'PASS' if ok else 'FAIL'} {text}",
              flush=True)
        if not ok:
            self.failed.append(phase)

    def check(self, phase: str, value: float, bound: float, text: str):
        ok = bool(np.isfinite(value) and value <= bound)
        self.line(phase, ok, f"{text} max_abs_err={value:.3e} tol={bound:.1e}")

    def run(self, phase: str, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kw)
        except Exception:
            traceback.print_exc()
            self.line(phase, False, "raised (traceback above)")
            return None
        finally:
            print(f"[{self.tag}] {phase}: {time.perf_counter() - t0:.1f}s "
                  "wall, compilation included", flush=True)


# ----------------------------------------------------------- numpy references

def np_pyramid(img: np.ndarray, levels: int):
    """float64 pyramid: 2x2 means, edge-padded Scharr / 32, 0.5(|gx|+|gy|)."""
    out, im = [], np.asarray(img, np.float64)
    for lvl in range(levels):
        if lvl:
            h, w = im.shape
            im = im.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        p = np.pad(im, 1, mode="edge")
        a, b, c = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
        d, f = p[1:-1, :-2], p[1:-1, 2:]
        g, h_, i = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
        gx = (3 * (c - a) + 10 * (f - d) + 3 * (i - g)) / 32.0
        gy = (3 * (g - a) + 10 * (h_ - b) + 3 * (i - c)) / 32.0
        out.append((im, gx, gy, 0.5 * np.abs(gx) + 0.5 * np.abs(gy)))
    return out


def np_bilinear(img: np.ndarray, uv: np.ndarray):
    """float64 4-tap bilinear with zero fill outside [0, W-1] x [0, H-1]."""
    H, W = img.shape
    u, v = uv[:, 0].astype(np.float64), uv[:, 1].astype(np.float64)
    u0, v0 = np.floor(u), np.floor(v)
    du, dv = u - u0, v - v0
    ui = np.clip(u0.astype(np.int64), 0, W - 2)
    vi = np.clip(v0.astype(np.int64), 0, H - 2)
    val = (img[vi, ui] * (1 - du) * (1 - dv) + img[vi, ui + 1] * du * (1 - dv)
           + img[vi + 1, ui] * (1 - du) * dv + img[vi + 1, ui + 1] * du * dv)
    ok = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return np.where(ok, val, 0.0), ok


def np_remap(img: np.ndarray, m: np.ndarray):
    """float64 remap with clamped taps, zero fill outside the source."""
    H, W = img.shape
    u, v = m[..., 0], m[..., 1]
    u0, v0 = np.floor(u), np.floor(v)
    du, dv = u - u0, v - v0
    ui, vi = u0.astype(np.int64), v0.astype(np.int64)

    def tap(vv, uu):
        return img[np.clip(vv, 0, H - 1), np.clip(uu, 0, W - 1)]

    val = (tap(vi, ui) * (1 - du) * (1 - dv) + tap(vi, ui + 1) * du * (1 - dv)
           + tap(vi + 1, ui) * (1 - du) * dv + tap(vi + 1, ui + 1) * du * dv)
    ok = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return np.where(ok, val, 0.0)


def smooth_image(H: int, W: int, seed: int) -> np.ndarray:
    """Band-limited test image in [0, 255] (sum of random sinusoids)."""
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    acc = np.zeros((H, W))
    for _ in range(8):
        fu, fv = rng.uniform(0.02, 0.15, 2)
        acc += rng.uniform(0.3, 1.0) * np.sin(fu * u + fv * v
                                              + rng.uniform(0, 6.28))
    return (127.5 + 120.0 * acc / np.abs(acc).max()).astype(np.float32)


# ----------------------------------------------------------------- phase 2

def phase_pyramid(rep: Report, dev, H: int = 480, W: int = 640,
                  batch: int = 96, levels: int = 5):
    import jax

    from uwslam_tpu.image.pyramid import build_pyramid, build_pyramid_batched
    from uwslam_tpu.ops.scharr import scharr_gradients_batched

    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, (batch, H, W)).astype(np.float32)
    single = jax.jit(lambda x: build_pyramid(x, levels=levels))(
        jax.device_put(frames[0], dev)
    )
    ref = np_pyramid(frames[0], levels)
    err = max(
        float(np.abs(np.asarray(getattr(single, f)[lvl]) - ref[lvl][k]).max())
        for lvl in range(levels)
        for k, f in enumerate(("images", "grad_x", "grad_y", "grad_mag"))
    )
    rep.check("pyramid_single", err, 1e-3,
              f"{H}x{W} {levels} levels f32 vs numpy f64")
    batched = jax.jit(lambda x: build_pyramid_batched(x, levels=levels))(
        jax.device_put(frames, dev)
    )
    err = 0.0
    for b in range(batch):
        ref = np_pyramid(frames[b], levels)
        for lvl in range(levels):
            for k, f in enumerate(("images", "grad_x", "grad_y", "grad_mag")):
                got = np.asarray(getattr(batched, f)[lvl][b])
                err = max(err, float(np.abs(got - ref[lvl][k]).max()))
    rep.check(f"pyramid_batched[{dev.platform} form]", err, 1e-3,
              f"{batch}x{H}x{W} {levels} levels f32 vs numpy f64")
    # The hand-written kernel itself, compiled for the card (interpreted on
    # the CPU, which has no Triton), level 0 of the whole batch.
    interpret = dev.platform == "cpu"
    gx, gy, gm = jax.jit(
        lambda x: scharr_gradients_batched(x, interpret=interpret)
    )(jax.device_put(frames, dev))
    err = 0.0
    for b in range(batch):
        ref = np_pyramid(frames[b], 1)[0]
        for k, got in enumerate((gx, gy, gm)):
            err = max(err, float(np.abs(np.asarray(got[b]) - ref[k + 1]).max()))
    rep.check(
        f"scharr kernel (Pallas Triton, "
        f"{'interpreted' if interpret else 'compiled'})", err, 1e-3,
        f"{batch}x{H}x{W} level 0 gx/gy/|g| f32 vs numpy f64",
    )


def phase_sampling(rep: Report, dev, H: int = 480, W: int = 640,
                   n: int = N_POINTS):
    import jax

    from uwslam_tpu.image.pyramid import bilinear_sample_dense, sample_stack

    rng = np.random.default_rng(1)
    stack = np.stack([smooth_image(H, W, s) for s in range(3)])
    uv = np.stack([rng.uniform(-3, W + 2, n), rng.uniform(-3, H + 2, n)],
                  axis=-1).astype(np.float32)
    ref = [np_bilinear(stack[c].astype(np.float64), uv) for c in range(3)]
    ref_vals = np.stack([r[0] for r in ref])
    s_d, uv_d = jax.device_put(stack, dev), jax.device_put(uv, dev)
    forms = {
        "gather (tracking)": sample_stack,
        "onehot precision=HIGHEST (photometric BA)": bilinear_sample_dense,
    }
    for name, fn in forms.items():
        vals, ok = jax.jit(fn)(s_d, uv_d)
        if not np.array_equal(np.asarray(ok), ref[0][1]):
            rep.line(f"sampling {name}", False, "validity mask differs")
            continue
        err = float(np.abs(np.asarray(vals) - ref_vals).max())
        rep.check(f"sampling {name}", err, 2e-3,
                  f"{n} pts on 3x{H}x{W} f32 vs numpy f64")
    phase_warp_sample(rep, dev, stack, rng, n)


def phase_warp_sample(rep: Report, dev, stack: np.ndarray, rng,
                      n: int = N_POINTS):
    """Warp + project + sample (tracking.photometric._warp_sample): the
    Pallas Triton kernel ops/warp_sample.py (compiled for the card,
    interpreted on the CPU) and XLA's form, 1 and 3 channels, against
    numpy float64. Target pixels stay 0.01 px off the image border and
    depths off the z > 1e-3 cut, so f32 rounding cannot flip validity."""
    import jax

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3
    from uwslam_tpu.ops.warp_sample import warp_sample
    from uwslam_tpu.tracking.photometric import _warp_sample_xla

    C, H, W = stack.shape
    cam = PinholeCamera(fx=525.0 * W / 640, fy=525.0 * W / 640,
                        cx=(W - 1) / 2, cy=(H - 1) / 2, width=W, height=H)
    T = np.asarray(se3.exp(np.asarray([0.05, -0.02, 0.03, 0.02, -0.01,
                                       0.015], np.float32)), np.float64)
    uv_t = np.stack([rng.uniform(-3, W + 2, n), rng.uniform(-3, H + 2, n)],
                    -1)
    for k, lim in ((0, W - 1), (1, H - 1)):      # keep off the border
        for edge in (0.0, lim):
            near = np.abs(uv_t[:, k] - edge) < 0.01
            uv_t[near, k] = edge + 0.02
    z_t = rng.uniform(0.5, 4.0, n)
    z_t[::37] = -0.3                              # some behind the camera
    p_t = np.stack([(uv_t[:, 0] - cam.cx) / cam.fx * z_t,
                    (uv_t[:, 1] - cam.cy) / cam.fy * z_t, z_t], -1)
    Ti = np.linalg.inv(T)
    p3d = (p_t @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    put = lambda x: jax.device_put(np.asarray(x, np.float32), dev)  # noqa
    interpret = dev.platform == "cpu"
    forms = {
        f"warp_sample kernel (Pallas Triton, "
        f"{'interpreted' if interpret else 'compiled'})":
            lambda s, p, T: warp_sample(s, p, T, cam, interpret=interpret),
        "warp_sample XLA form": lambda s, p, T: _warp_sample_xla(s, p, T,
                                                                 cam),
    }
    for c in (1, C):
        ref = [np_bilinear(stack[i].astype(np.float64), uv_t)
               for i in range(c)]
        ok_ref = ref[0][1] & (z_t > 1e-3)
        ref_vals = np.where(ok_ref, np.stack([r[0] for r in ref]), 0.0)
        for name, fn in forms.items():
            vals, ok = jax.jit(fn)(put(stack[:c]), put(p3d), put(T))
            if not np.array_equal(np.asarray(ok), ok_ref):
                rep.line(f"{name} C={c}", False, "validity mask differs")
                continue
            rep.check(f"{name} C={c}",
                      float(np.abs(np.asarray(vals) - ref_vals).max()), 5e-3,
                      f"{n} pts ({int(ok_ref.sum())} valid) on {c}x{H}x{W}, "
                      "f32 vs numpy f64, ADU")


def _sym3_cases(rng):
    A = rng.normal(size=(256, 3, 3))
    A = A + np.swapaxes(A, -1, -2)
    Q = np.linalg.qr(rng.normal(size=(6, 3, 3)))[0]
    spectra = np.array([[1, 1, 2], [0, 0, 1], [0, 0, 0], [3, 3, 3],
                        [1e-6, 2e-6, 1], [-1, 0, 1]], np.float64)
    degen = np.einsum("bij,bj,bkj->bik", Q, spectra, Q)
    return np.concatenate([A, degen, np.diag([2.0, 0.5, 1.0])[None]])


def _svd3_cases(rng):
    F = rng.normal(size=(256, 3, 3))
    U = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    V = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    s = np.array([[1, 1, 0], [2, 0, 0], [1, 1, 1], [3, 2, 1e-7], [0, 0, 0]],
                 np.float64)
    degen = np.einsum("bij,bj,bkj->bik", U, s, V)
    return np.concatenate([F, degen])


def _spd9_cases(rng):
    M = rng.normal(size=(128, 20, 9))
    A = np.einsum("bmi,bmj->bij", M, M)
    Mr = rng.normal(size=(16, 8, 9))          # rank 8: an exact null vector
    Ar = np.einsum("bmi,bmj->bij", Mr, Mr)
    Q = np.linalg.qr(rng.normal(size=(16, 9, 9)))[0]
    lam = np.concatenate([[1e-6, 2e-6], np.linspace(1, 5, 7)])
    Ac = np.einsum("bij,j,bkj->bik", Q, lam, Q)  # two tiny, close eigenvalues
    return np.concatenate([A, Ar, Ac])


def phase_linalg(rep: Report, dev):
    """The feature path's small decompositions (jnp.linalg: cuSOLVER on the
    GPU) and utils/linalg.py's helpers against numpy float64."""
    import jax
    import jax.numpy as jnp

    from uwslam_tpu.utils.linalg import (
        cholesky_solve_unrolled,
        smallest_eigvec_spd,
    )

    rng = np.random.default_rng(2)
    put = lambda x: jax.device_put(np.asarray(x, np.float32), dev)  # noqa

    S = _sym3_cases(rng)
    w, V = (np.asarray(x, np.float64)
            for x in jax.jit(jnp.linalg.eigh)(put(S)))
    scale = np.abs(np.linalg.eigvalsh(S)).max(axis=-1) + 1e-30
    e_w = np.abs(w - np.linalg.eigvalsh(S)).max(axis=-1) / scale
    recon = np.einsum("bij,bj,bkj->bik", V, w, V)
    e_r = np.abs(recon - S).max(axis=(1, 2)) / scale
    e_o = np.abs(np.einsum("bji,bjk->bik", V, V) - np.eye(3)).max()
    rep.check("linalg eigh 3x3", float(max(e_w.max(), e_r.max(), e_o)), 1e-4,
              f"{len(S)} matrices (repeated/zero/tiny eigenvalues incl.), "
              "relative to |lambda|max, f32 vs numpy f64")

    F = _svd3_cases(rng)
    U, s, Vt = (np.asarray(x, np.float64)
                for x in jax.jit(jnp.linalg.svd)(put(F)))
    s_ref = np.linalg.svd(F, compute_uv=False)
    scale = s_ref[:, 0] + 1e-30
    e_s = np.abs(s - s_ref).max(axis=-1) / scale
    e_r = np.abs(np.einsum("bij,bj,bjk->bik", U, s, Vt) - F).max(axis=(1, 2))
    e_r = e_r / scale
    nz = s_ref[:, 0] > 0
    e_o = max(
        np.abs(np.einsum("bji,bjk->bik", U, U) - np.eye(3))[nz].max(),
        np.abs(np.einsum("bij,bkj->bik", Vt, Vt) - np.eye(3))[nz].max(),
    )
    rep.check("linalg svd 3x3", float(max(e_s.max(), e_r.max(), e_o)), 1e-4,
              f"{len(F)} matrices (rank 0-2, repeated sigma incl.), relative "
              "to sigma_max, f32 vs numpy f64")

    A = _spd9_cases(rng)
    v = np.asarray(jax.jit(smallest_eigvec_spd)(put(A)), np.float64)
    lam = np.linalg.eigvalsh(A)
    rq = np.einsum("bi,bij,bj->b", v, A, v) / np.einsum("bi,bi->b", v, v)
    rep.check("linalg smallest_eigvec_spd",
              float((np.abs(rq - lam[:, 0]) / lam[:, -1]).max()), 1e-5,
              f"{len(A)} 9x9 PSD (Wishart, rank-8, double tiny eigenvalue), "
              "Rayleigh quotient vs numpy lambda_min, relative to "
              "lambda_max")

    M = rng.normal(size=(256, 12, 6))
    H = np.einsum("bmi,bmj->bij", M, M) + 1e-3 * np.eye(6)
    g = rng.normal(size=(256, 6))
    x = np.asarray(jax.jit(cholesky_solve_unrolled)(put(H), put(g)),
                   np.float64)
    x_ref = np.linalg.solve(H, g[..., None])[..., 0]
    rep.check("linalg cholesky_solve_unrolled",
              float((np.abs(x - x_ref).max(-1)
                     / np.abs(x_ref).max(-1)).max()), 1e-4,
              "256 6x6 SPD normal equations (12 rows), relative to |x|max, "
              "f32 vs numpy f64")


def _np_rect_map(raw, rect) -> np.ndarray:
    """float64 rectification map: output pixel -> distorted source pixel."""
    v, u = np.meshgrid(np.arange(rect.height, dtype=np.float64),
                       np.arange(rect.width, dtype=np.float64), indexing="ij")
    x, y = (u - rect.cx) / rect.fx, (v - rect.cy) / rect.fy
    r2 = x * x + y * y
    radial = 1 + r2 * (raw.k1 + r2 * raw.k2)
    xd = x * radial + 2 * raw.p1 * x * y + raw.p2 * (r2 + 2 * x * x)
    yd = y * radial + raw.p1 * (r2 + 2 * y * y) + 2 * raw.p2 * x * y
    return np.stack([xd * raw.fx + raw.cx, yd * raw.fy + raw.cy], axis=-1)


def phase_rectify(rep: Report, dev):
    import jax

    from uwslam_tpu import camera
    from uwslam_tpu.camera.model import optimal_new_camera
    from uwslam_tpu.system import SlamSystem

    calib = camera.load(os.path.join(REPO, "configs", "calibration_euroc.json"))
    raw = calib.raw
    with jax.default_device(dev):
        system = SlamSystem(calib)
    rect = optimal_new_camera(raw, calib.out_width, calib.out_height)
    img = smooth_image(raw.height, raw.width, 7)
    got = np.asarray(jax.jit(system._rectify)(jax.device_put(img, dev)))
    ref = np_remap(img.astype(np.float64), _np_rect_map(raw, rect))
    rep.check("rectify", float(np.abs(got - ref).max()), 0.05,
              f"EuRoC {raw.width}x{raw.height} -> {rect.width}x{rect.height} "
              "(configs/calibration_euroc.json) f32 vs numpy f64, ADU")


# ----------------------------------------------------------------- phase 3

def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    from uwslam_tpu.lie import so3

    return np.asarray(so3.to_quaternion(jnp.asarray(R, jnp.float32)))


def _poses(n: int, step: float):
    """Seeded-free smooth motion: T_cw(i) = exp(i * step * xi)."""
    import jax.numpy as jnp

    from uwslam_tpu.lie import se3

    xi = jnp.asarray([1.0, 0.4, 0.2, 0.05, -0.1, 0.15], jnp.float32) * step
    return [se3.exp(xi * i) for i in range(n)]


def _calib_xml(path, fx, fy, cx, cy, w, h, dist=(0, 0, 0, 1),
               out_w=None, out_h=None):
    def mat(tag, vals):
        return (f'<{tag} type_id="opencv-matrix"><rows>1</rows><cols>4</cols>'
                f"<dt>d</dt><data>{' '.join(repr(float(x)) for x in vals)}"
                f"</data></{tag}>")

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<opencv_storage>\n'
                f"<in_width>{w}</in_width><in_height>{h}</in_height>\n"
                f"<out_width>{out_w or w}</out_width>"
                f"<out_height>{out_h or h}</out_height>\n"
                + mat("calibration_values", (fx, fy, cx, cy)) + "\n"
                + mat("rectification", dist) + "\n</opencv_storage>\n")


def write_tum(root: str, cam_kw: dict = TUM_CAM, n: int = N_FRAMES,
              seed: int = 0, step: float = 0.01) -> dict:
    """TUM layout: rgb/<ts>.pgm at 30 Hz, groundtruth.txt, calibration XML.
    The scene is the textured plane z = 2 m (utils.synthetic)."""
    import jax

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.io import write_pgm
    from uwslam_tpu.lie import se3
    from uwslam_tpu.utils.synthetic import render_plane_view

    cam = PinholeCamera(**cam_kw)
    # Texture frequency per pixel as in the CPU tests (detail 2 at fx=120).
    detail = 2.0 * cam.fx / 120.0
    render = jax.jit(lambda T: render_plane_view(cam, T, 2.0, seed, detail))
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    rows, gt = [], []
    for i, T in enumerate(_poses(n, step)):
        ts = 1.0 + i / 30.0
        img = np.asarray(render(T)).clip(0, 255).round().astype(np.uint8)
        write_pgm(os.path.join(root, "rgb", f"{ts:.6f}.pgm"), img)
        Twc = np.asarray(se3.inverse(T), np.float64)
        q = _quat_wxyz(Twc[:3, :3])
        t = Twc[:3, 3]
        rows.append(f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")
        gt.append(t)
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth\n# synthetic plane\n"
                "# timestamp tx ty tz qx qy qz qw\n" + "".join(rows))
    _calib_xml(os.path.join(root, "calib.xml"), cam.fx, cam.fy, cam.cx,
               cam.cy, cam.width, cam.height)
    return {"rgb": os.path.join(root, "rgb"),
            "gt": os.path.join(root, "groundtruth.txt"),
            "calib": os.path.join(root, "calib.xml"), "gt_pos": np.stack(gt)}


def write_euroc(root: str, raw_kw: dict, out_wh, n: int = N_FRAMES,
                seed: int = 1, step: float = 0.01) -> dict:
    """EuRoC layout: mav0/cam0/data/<ns>.pgm at 20 Hz (radtan-distorted),
    the state ground-truth CSV, and the calibration XML."""
    import jax

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.io import write_pgm
    from uwslam_tpu.lie import se3
    from uwslam_tpu.utils.synthetic import render_plane_view_distorted

    raw = PinholeCamera(**raw_kw)
    detail = raw.fx / 140.0       # per-pixel texture of the CPU EuRoC test
    render = jax.jit(
        lambda T: render_plane_view_distorted(raw, T, 2.0, seed, detail)
    )
    data = os.path.join(root, "mav0", "cam0", "data")
    os.makedirs(data, exist_ok=True)
    rows, gt = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n"], []
    for i, T in enumerate(_poses(n, step)):
        ns = 1_000_000_000 + 50_000_000 * i
        img = np.asarray(render(T)).clip(0, 255).round().astype(np.uint8)
        write_pgm(os.path.join(data, f"{ns}.pgm"), img)
        Twc = np.asarray(se3.inverse(T), np.float64)
        q = _quat_wxyz(Twc[:3, :3])
        t = Twc[:3, 3]
        rows.append(f"{ns},{t[0]:.9f},{t[1]:.9f},{t[2]:.9f},"
                    f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f}\n")
        gt.append(t)
    gt_csv = os.path.join(root, "gt.csv")
    with open(gt_csv, "w") as f:
        f.write("".join(rows))
    _calib_xml(os.path.join(root, "calib.xml"), raw.fx, raw.fy, raw.cx,
               raw.cy, raw.width, raw.height,
               dist=(raw.k1, raw.k2, raw.p1, raw.p2),
               out_w=out_wh[0], out_h=out_wh[1])
    return {"root": os.path.join(root, "mav0"), "gt": gt_csv,
            "calib": os.path.join(root, "calib.xml"), "gt_pos": np.stack(gt)}


def run_cli(args: list[str]) -> tuple[str, float | None]:
    """uwslam_tpu.cli.main.main(args) in this process. Returns its output
    and the fps it reports: warm (live) or whole-run (offline)."""
    from uwslam_tpu.cli.main import main as cli_main

    err, out = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            rc = cli_main(args)
    except Exception:
        print((out.getvalue() + err.getvalue())[-2000:], file=sys.stderr)
        raise
    text = out.getvalue() + err.getvalue()
    if rc != 0:
        raise PhaseFailure(f"cli exited {rc}:\n{text[-2000:]}")
    m = re.search(r"\(([\d.]+) fps (warm|, offline)", text)
    return text, float(m.group(1)) if m else None


def _ate(est_path: str, gt_pos: np.ndarray) -> tuple[float, int]:
    from uwslam_tpu.io import ate_rmse, read_trajectory_tum

    _, poses = read_trajectory_tum(est_path)
    if len(poses) != len(gt_pos):
        raise PhaseFailure(f"{len(poses)} poses for {len(gt_pos)} frames")
    return float(ate_rmse(poses[:, :3, 3], gt_pos)), len(poses)


def phase_cli(rep: Report, work: str, cam_kw: dict = TUM_CAM,
              n: int = N_FRAMES, n_points: int = N_POINTS,
              levels: int = 5, euroc_raw: dict | None = None,
              euroc_out=(736, 480), cpu_frames: int = 16, only=None):
    """The four CLI configurations; `only` picks a subset of 'abcd'."""
    only = only or "abcd"
    tum = write_tum(os.path.join(work, "tum"), cam_kw, n)
    common = ["--levels", str(levels), "--num-points", str(n_points),
              "--mono-depth", "2.0"]
    tum_args = ["-d", tum["rgb"], "-c", tum["calib"], "--tum-gt", tum["gt"]]
    cases = {
        "a": ("live direct (process_frame_async)", []),
        "b": ("features + window BA", ["--features", "--ba"]),
        "c": ("offline IC", ["--offline", "--track-mode", "ic",
                             "--chunk", str(n)]),
    }
    for key in "abc":
        if key not in only:
            continue
        name, extra = cases[key]
        est = os.path.join(work, f"est_{key}.txt")

        def one(rep, extra=extra, est=est, key=key, name=name):
            _, fps = run_cli(tum_args + common + extra
                             + ["--trajectory-out", est])
            ate, k = _ate(est, tum["gt_pos"])
            fps_s = f"{fps:.1f}" if fps is not None else "n/a"
            rep.line(f"cli ({key}) {name}", ate <= ATE_BOUND[key],
                     f"{k} frames {cam_kw['width']}x{cam_kw['height']} "
                     f"ATE={ate:.5f} m bound={ATE_BOUND[key]} "
                     f"(warm fps {fps_s}, information only)")

        rep.run(f"cli ({key})", one)
        if key == "c" and cpu_frames:
            rep.run("cli (c) cpu parity", _cpu_parity, tum, common, est,
                    cpu_frames, work)
    if "d" in only:
        from uwslam_tpu import camera

        if euroc_raw is None:
            cal = camera.load(
                os.path.join(REPO, "configs", "calibration_euroc.json")
            )
            r = cal.raw
            euroc_raw = dict(fx=r.fx, fy=r.fy, cx=r.cx, cy=r.cy,
                             width=r.width, height=r.height, k1=r.k1,
                             k2=r.k2, p1=r.p1, p2=r.p2)
            euroc_out = (cal.out_width, cal.out_height)
        eu = write_euroc(os.path.join(work, "euroc"), euroc_raw, euroc_out, n)
        est = os.path.join(work, "est_d.txt")

        def one_d(rep):
            _, fps = run_cli(
                ["-d", eu["root"], "--euroc", "-c", eu["calib"],
                 "--euroc-gt", eu["gt"], "--trajectory-out", est] + common
            )
            ate, k = _ate(est, eu["gt_pos"])
            fps_s = f"{fps:.1f}" if fps is not None else "n/a"
            rep.line("cli (d) EuRoC rectified", ate <= ATE_BOUND["d"],
                     f"{k} frames {euroc_raw['width']}x{euroc_raw['height']}"
                     f" -> {euroc_out[0]}x{euroc_out[1]} ATE={ate:.5f} m "
                     f"bound={ATE_BOUND['d']} (warm fps {fps_s}, "
                     "information only)")

        rep.run("cli (d)", one_d)


def _cpu_parity(rep: Report, tum: dict, common: list, est_gpu: str,
                frames: int, work: str):
    """The same offline IC run of the first `frames` frames in a child on
    the CPU (JAX_PLATFORMS=cpu: it never opens the card)."""
    from uwslam_tpu.io import read_trajectory_tum

    est_cpu = os.path.join(work, "est_c_cpu.txt")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "uwslam_tpu", "-d", tum["rgb"],
         "-c", tum["calib"], "--offline", "--track-mode", "ic",
         "--chunk", str(frames), "--max-frames", str(frames),
         "--trajectory-out", est_cpu] + common,
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise PhaseFailure(f"cpu child exited {proc.returncode}:\n"
                           f"{proc.stderr[-2000:]}")
    _, p_cpu = read_trajectory_tum(est_cpu)
    _, p_gpu = read_trajectory_tum(est_gpu)
    err = float(np.abs(p_gpu[:frames, :3, 3] - p_cpu[:, :3, 3]).max())
    rep.check("cli (c) gpu vs cpu child", err, CPU_GPU_POSE_TOL,
              f"first {frames} offline IC positions (m)")


# ------------------------------------------------------------- four cards

def _ba_problem(num_kf: int, num_lm: int, obs_per_lm: int, seed: int):
    """Synthetic global-BA map: keyframes along a path, each landmark seen
    by `obs_per_lm` consecutive keyframes, 0.5 px noise, perturbed init
    (poses 0.005 in the twist except the two gauge poses, landmarks 2 cm).
    Returns the problem, the camera, the valid observation count and the
    true poses."""
    import jax.numpy as jnp

    from uwslam_tpu.ba import BAProblem
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3

    cam = PinholeCamera(**TUM_CAM)
    rng = np.random.default_rng(seed)
    T = np.stack([np.asarray(se3.exp(jnp.asarray(
        [0.03 * i, 0.005 * i, 0.0, 0.0, 0.004 * i, 0.0], jnp.float32)))
        for i in range(num_kf)])
    first = rng.integers(0, num_kf - obs_per_lm + 1, num_lm)
    kf = (first[:, None] + np.arange(obs_per_lm)[None]).reshape(-1)
    lm = np.repeat(np.arange(num_lm), obs_per_lm)
    # Landmarks in front of their first observer.
    Twc0 = np.linalg.inv(T[first])
    pc = np.stack([rng.uniform(-1.2, 1.2, num_lm), rng.uniform(-0.9, 0.9,
                   num_lm), rng.uniform(2.0, 5.0, num_lm)], -1)
    pts = np.einsum("bij,bj->bi", Twc0[:, :3, :3], pc) + Twc0[:, :3, 3]
    p_c = np.einsum("bij,bj->bi", T[kf][:, :3, :3], pts[lm]) + T[kf][:, :3, 3]
    uv = np.asarray(cam.project(jnp.asarray(p_c, jnp.float32)))
    uv = uv + rng.normal(0, 0.5, uv.shape)
    valid = ((uv[:, 0] >= 0) & (uv[:, 0] <= cam.width - 1) & (uv[:, 1] >= 0)
             & (uv[:, 1] <= cam.height - 1) & (p_c[:, 2] > 0.1))
    dT = rng.normal(0, 0.005, (num_kf, 6))
    dT[:2] = 0     # the two gauge poses the solvers hold fixed
    T0 = np.stack([np.asarray(se3.compose(se3.exp(jnp.asarray(d, jnp.float32)),
                                          jnp.asarray(t, jnp.float32)))
                   for d, t in zip(dT, T)])
    pts0 = pts + rng.normal(0, 0.02, pts.shape)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    prob = BAProblem(T_cw=f32(T0), points=f32(pts0),
                     obs_kf=jnp.asarray(kf, jnp.int32),
                     obs_lm=jnp.asarray(lm, jnp.int32), obs_uv=f32(uv),
                     obs_valid=jnp.asarray(valid))
    return prob, cam, int(valid.sum()), T


def _spread(x) -> tuple[int, int, bool]:
    """(distinct devices, distinct blocks, fully replicated) of an array."""
    shards = x.addressable_shards
    blocks = {tuple((s.start, s.stop) for s in sh.index) for sh in shards}
    return (len({sh.device for sh in shards}), len(blocks),
            x.sharding.is_fully_replicated)


def _split_over(x, n: int) -> bool:
    """True when x is split into n blocks that sit on n distinct devices."""
    devs, blocks, replicated = _spread(x)
    return devs == n and blocks == n and not replicated


def _centres(T_cw) -> np.ndarray:
    T = np.asarray(T_cw, np.float64)
    return -np.einsum("bji,bj->bi", T[:, :3, :3], T[:, :3, 3])


# LM iterations over which the two solvers must take the same steps from the
# same start. Past the first few, the iterates of this monocular chain drift
# apart along its weakly observed scale-drift direction at equal cost (on
# the CPU mesh too), so the full solve is compared by cost.
FIRST_STEPS = 2


def phase_dist_ba(rep: Report, devices, sizes=((120, 1300), (120, 13000)),
                  iters: int = 40):
    """Global BA as `SlamSystem` runs it for --dist-ba (two gauge poses,
    the configured global pose prior, 40 LM iterations) over a landmark
    mesh of `devices`, against single-device bundle_adjust on the same
    problem. Checks: the first FIRST_STEPS iterations agree (camera centres
    after Sim(3) alignment, cost); the full solve ends no more than 1e-3
    (relative) above the single-device cost, where the two sets of iterates
    have parted along the flat direction; the landmarks are split over every
    device.
    The distance of each solve to the true poses is printed."""
    import jax
    from jax.sharding import Mesh

    from uwslam_tpu.ba import bundle_adjust
    from uwslam_tpu.config import BAConfig
    from uwslam_tpu.io import ate_rmse
    from uwslam_tpu.parallel import (
        AXIS,
        distributed_bundle_adjust,
        shard_problem,
    )

    cfg = BAConfig()
    kw = dict(huber_delta=cfg.huber_delta_px, num_fixed_poses=2,
              pose_prior_weight=cfg.global_pose_prior_weight)
    n = len(devices)
    mesh = Mesh(np.array(devices), (AXIS,))
    for num_kf, num_lm in sizes:
        prob, cam, n_obs, T_true = _ba_problem(num_kf, num_lm, 3,
                                               seed=num_lm)
        sharded = shard_problem(prob, n)
        runs = {}
        for k in (FIRST_STEPS, iters):
            with jax.default_device(devices[0]):
                single = bundle_adjust(jax.device_put(prob, devices[0]), cam,
                                       max_iters=k, trim_px=None, **kw)
            t0 = time.perf_counter()
            dist = distributed_bundle_adjust(sharded, cam, mesh, max_iters=k,
                                             **kw)
            jax.block_until_ready(dist.T_cw)
            runs[k] = (single, dist, time.perf_counter() - t0)
        name = f"dist_ba {num_kf}kf/{num_lm}lm"
        head = (f"{n_obs} obs over {n} devices, 2 gauge poses, pose prior "
                f"{kw['pose_prior_weight']:g}:")

        single, dist, _ = runs[FIRST_STEPS]
        d = float(ate_rmse(_centres(dist.T_cw), _centres(single.T_cw)))
        c1, cn = float(single.cost), float(dist.cost)
        rel = abs(cn - c1) / max(abs(c1), 1e-12)
        rep.line(f"{name} first {FIRST_STEPS} LM steps",
                 d <= 1e-4 and rel <= 1e-4,
                 f"{head} camera-centre RMSE after Sim(3) alignment vs "
                 f"single-device {d:.2e} m (tol 1e-4), cost {cn:.6g} vs "
                 f"{c1:.6g} (rel {rel:.2e}, tol 1e-4)")

        single, dist, dt = runs[iters]
        c0 = float(single.initial_cost)
        c1, cn = float(single.cost), float(dist.cost)
        rel = (cn - c1) / max(abs(c1), 1e-12)
        split = _split_over(dist.points, n)
        c_true = _centres(T_true)
        c_1, c_n = _centres(single.T_cw), _centres(dist.T_cw)
        d = float(ate_rmse(c_n, c_1))
        e0 = float(ate_rmse(_centres(prob.T_cw), c_true))
        e1, en = float(ate_rmse(c_1, c_true)), float(ate_rmse(c_n, c_true))
        rep.line(
            f"{name} {iters} LM iters", rel <= 1e-3 and cn < c0 and split,
            f"{head} cost {c0:.6g} -> {cn:.6g} vs single-device {c1:.6g} "
            f"(rel {rel:+.2e}, at most +1e-3); "
            f"landmarks split over {n} devices: {split}; information only: "
            f"camera-centre RMSE after Sim(3) alignment vs single-device "
            f"{d:.2e} m, vs true poses dist {en:.2e} / single {e1:.2e} / "
            f"start {e0:.2e} m; call {dt:.2f}s incl. compile",
        )


def phase_sharded_tracking(rep: Report, devices, n: int = 33,
                           cam_kw: dict = TUM_CAM, n_points: int = N_POINTS,
                           levels: int = 5, track_levels=(3, 2, 1, 0)):
    """track_sequence_sharded over a `seq` mesh of `devices` against
    track_sequence_batched on one device; every output of the sharded call
    must be split into one block per device, on distinct devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.parallel.sequence import SEQ_AXIS, track_sequence_sharded
    from uwslam_tpu.tracking import track_sequence_batched
    from uwslam_tpu.utils.synthetic import render_plane_view

    cam = PinholeCamera(**cam_kw)
    render = jax.jit(lambda T: render_plane_view(cam, T, 2.0, 0,
                                                 2.0 * cam.fx / 120.0))
    with jax.default_device(devices[0]):
        frames = jnp.stack([render(T) for T in _poses(n, 0.01)])
    kw = dict(mono_z=2.0, levels=levels, track_levels=tuple(track_levels),
              num_points=n_points,
              max_iters=(12, 8, 5, 3)[-len(track_levels):], mode="ic")
    mesh = Mesh(np.array(devices), (SEQ_AXIS,))
    fr_sh = jax.device_put(frames, NamedSharding(mesh, P()))
    outs = jax.block_until_ready(
        track_sequence_sharded(fr_sh, cam, mesh, **kw)
    )
    T_1, _, _ = track_sequence_batched(jax.device_put(frames, devices[0]),
                                       cam, **kw)
    err = float(np.abs(np.asarray(outs[0]) - np.asarray(T_1)).max())
    spreads = [_spread(o) for o in outs]
    split = all(_split_over(o, len(devices)) for o in outs)
    rep.line("sharded_tracking", err <= 1e-3 and split,
             f"{n - 1} pairs {cam.width}x{cam.height} over {len(devices)} "
             f"devices vs one device: max |dT| {err:.2e} (tol 1e-3); outputs "
             f"(poses, inliers, errors) as (devices, blocks, replicated): "
             f"{spreads}, each must be ({len(devices)}, {len(devices)}, "
             "False)")


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phases, over 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    import uwslam_tpu  # noqa: F401  (fails here outside a checkout)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    devs = devs[:want]
    tag = card_name_and_power()
    rep = Report(tag)
    print(f"[{tag}] device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}", flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        rep.run("dist_ba", phase_dist_ba, devs)
        rep.run("sharded_tracking", phase_sharded_tracking, devs)
    else:
        dev = devs[0]
        rep.run("pyramid", phase_pyramid, dev)
        rep.run("sampling", phase_sampling, dev)
        rep.run("linalg", phase_linalg, dev)
        rep.run("rectify", phase_rectify, dev)
        work = os.path.join(REPO, ".smoke")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            rep.run("cli", phase_cli, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(f"[{tag}] total: {time.perf_counter() - t0:.1f}s "
          f"({len(rep.failed)} failed)", flush=True)
    if rep.failed:
        print(f"chip_smoke: FAILED {rep.failed}", file=sys.stderr)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
