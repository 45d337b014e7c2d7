"""Evaluation harness — BASELINE.json configs 1-5 end-to-end through the CLI.

Runs every staged config (direct tracking -> features/keyframes -> rectified
LM tracking -> sliding-window Schur BA -> multi-device distributed BA) and
writes the measured ATE RMSE / tracked fps / BA iters/s into
eval_out/RESULTS.md + eval_out/RESULTS_r<N>.json. One command reproduces
the whole table:

    python eval.py [--round 2] [--quick]

Dataset note (documented per VERDICT round-1 item 1): real TUM/EUROC
sequences are NOT fetchable on this rig (no network egress), so each config
runs on a synthetic stand-in that reproduces the dataset's format and
difficulty profile. On a machine WITH network access, fetch the real
sequences with scripts/fetch_tum_euroc.sh and run `python eval.py --real
ROOT` to produce the same table on them. Stand-in profile:
  - geometry: multi-plane occluding scenes (utils.synthetic.PlaneSpec ray
    cast) — real depth discontinuities, 1.4..5 m depth range, not the
    single fronto-parallel plane of round 1;
  - photometrics: Gaussian sensor noise + per-frame brightness drift
    (gain/bias), the underwater-attenuation model the affine tracker
    compensates;
  - formats: TUM directory + groundtruth.txt (3 header lines, space-sep,
    reference reader /root/reference/src/Visualizer.cpp:449-477) and EUROC
    mav0/cam0/data + state CSV (skip-1, comma-sep, ns timestamps,
    /root/reference/src/Visualizer.cpp:479-505), calibration XML in the
    reference's OpenCV schema (calibration/calibrationTUM.xml,
    calibrationEUROC.xml) including radtan distortion for the EUROC
    configs (rectification path exercised end-to-end).
Ground truth is exact (analytic ray-cast), so ATE numbers are clean
measurements of the pipeline, not of dataset association noise.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "eval_out")
DATA_ROOT = os.environ.get("UWSLAM_EVAL_DATA", os.path.join(OUT_DIR, "data"))


# --------------------------------------------------------------------- scenes

def _scene(kind: str):
    """Deep multi-plane occluding scenes (depth ratio ~3.5x) per dataset.

    octaves=4: broadband (1/f) texture — narrowband sinusoids alias at
    coarse pyramid levels and create periodic fine-level minima, a failure
    mode real scenes do not have (see synthetic.fractal_texture)."""
    from uwslam_tpu.utils.synthetic import make_plane

    if kind == "tum":
        return (
            make_plane((0.0, 0.0, 5.0), normal=(0.05, -0.02, -1.0), seed=3,
                       detail=0.9, octaves=4),
            make_plane((-0.9, 0.1, 2.4), normal=(0.35, 0.1, -1.0),
                       extent=(1.1, 1.4), seed=7, detail=1.2, octaves=4),
            make_plane((0.5, -0.2, 1.4), normal=(-0.1, 0.05, -1.0),
                       extent=(0.5, 0.55), seed=11, detail=1.5, octaves=4),
            make_plane((-0.15, 0.6, 1.8), normal=(0.0, -0.3, -1.0),
                       extent=(0.9, 0.3), seed=5, detail=1.3, octaves=4),
        )
    if kind == "euroc_mh":  # machine-hall-ish: deeper, wider structures
        return (
            make_plane((0.0, 0.2, 6.0), normal=(-0.03, -0.05, -1.0), seed=13,
                       detail=0.8, octaves=4),
            make_plane((1.0, -0.1, 3.2), normal=(-0.3, 0.05, -1.0),
                       extent=(1.3, 1.2), seed=17, detail=1.1, octaves=4),
            make_plane((-0.8, 0.3, 2.0), normal=(0.2, -0.1, -1.0),
                       extent=(0.6, 0.8), seed=19, detail=1.4, octaves=4),
            make_plane((0.1, -0.7, 2.6), normal=(0.0, 0.25, -1.0),
                       extent=(1.0, 0.35), seed=23, detail=1.2, octaves=4),
        )
    if kind == "euroc_v1":  # vicon-room-ish: closer walls
        return (
            make_plane((0.0, 0.0, 4.2), normal=(0.02, 0.04, -1.0), seed=29,
                       detail=1.0, octaves=4),
            make_plane((-0.7, -0.2, 2.2), normal=(0.3, -0.05, -1.0),
                       extent=(0.9, 1.0), seed=31, detail=1.3, octaves=4),
            make_plane((0.6, 0.25, 1.6), normal=(-0.15, -0.1, -1.0),
                       extent=(0.5, 0.5), seed=37, detail=1.5, octaves=4),
        )
    raise ValueError(kind)


def _trajectory(n: int, scale: float = 1.0, loop_period: int | None = None):
    """Smooth parallax-rich camera path (translation + rotation), bounded so
    the scene stays in view; adjacent-frame motion ~2-4 px at the TUM design
    point. Returns list of (4,4) T_cam_world.

    loop_period: if set, every sinusoid's frequency is an integer multiple
    of 2*pi/loop_period, so pose(i + loop_period) == pose(i) EXACTLY — the
    camera genuinely revisits earlier viewpoints (the loop-closure eval needs
    a true revisit, not the quasi-periodic near-miss of the default path)."""
    import math

    import jax.numpy as jnp

    from uwslam_tpu.lie import se3

    if loop_period is not None:
        w0 = 2.0 * math.pi / loop_period
        freqs = (w0, w0, w0, w0, 2 * w0, w0)
    else:
        freqs = (0.045, 0.032, 0.026, 0.040, 0.033, 0.050)
    amps = (0.30 * scale, 0.12 * scale, 0.10 * scale, 0.030, 0.045, 0.020)
    phases = (0.0, 0.7, 1.9, 0.3, 2.1, 1.1)
    poses = []
    for i in range(n):
        xi = jnp.asarray(
            [a * jnp.sin(f * i + p) - a * jnp.sin(p)
             for a, f, p in zip(amps, freqs, phases)],
            jnp.float32,
        )
        poses.append(se3.exp(xi))
    return poses


# ------------------------------------------------------------------- datasets

def _write_tum_calib(path, fx, fy, cx, cy, w, h, dist=(0, 0, 0, 0),
                     out_w=None, out_h=None):
    out_w = out_w or w
    out_h = out_h or h
    with open(path, "w") as f:
        f.write(f"""<?xml version="1.0"?><opencv_storage>
<in_width>{w}</in_width><in_height>{h}</in_height>
<out_width>{out_w}</out_width><out_height>{out_h}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{fx} {fy} {cx} {cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{dist[0]} {dist[1]} {dist[2]} {dist[3]}</data>
</rectification></opencv_storage>""")


def _save_gray(path, arr):
    """8-bit PGM: written and read in numpy, no image library needed."""
    import numpy as np

    from uwslam_tpu.io import write_pgm

    write_pgm(path, np.clip(np.asarray(arr), 0, 255).astype(np.uint8))


def make_tum_dataset(root: str, n_frames: int, seed: int = 0,
                     noise_sigma: float = 1.5,
                     loop_period: int | None = None) -> dict:
    """TUM-format: 640x480 fx=fy=525 (reference calibrationTUM.xml:7-21),
    rgb/<ts>.pgm at 30 Hz + groundtruth.txt + calib XML."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3, so3
    from uwslam_tpu.utils.synthetic import apply_photometric, render_scene_view

    if os.path.exists(os.path.join(root, "DONE")):
        return {"root": root, "gt": os.path.join(root, "groundtruth.txt"),
                "calib": os.path.join(root, "calib.xml"),
                "rgb": os.path.join(root, "rgb")}
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                        width=640, height=480)
    scene = _scene("tum")
    poses = _trajectory(n_frames, loop_period=loop_period)
    render = jax.jit(lambda T: render_scene_view(cam, T, scene))
    rows = []
    for i, T_cw in enumerate(poses):
        ts = i / 30.0
        img = render(T_cw)
        # brightness drift: slow gain/bias wander (exposure / attenuation)
        gain = 1.0 + 0.04 * np.sin(0.11 * i)
        bias = 3.0 * np.sin(0.07 * i + 1.0)
        img = apply_photometric(
            img, jax.random.PRNGKey(seed * 10007 + i),
            noise_sigma=noise_sigma, gain=gain, bias=bias,
        )
        _save_gray(os.path.join(root, "rgb", f"{ts:012.6f}.pgm"), img)
        T_wc = np.asarray(se3.inverse(T_cw))
        q = np.asarray(so3.to_quaternion(jnp.asarray(T_wc[:3, :3])))
        rows.append((ts, T_wc[:3, 3], q))
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n# synthetic multi-plane scene\n"
                "# ts tx ty tz qx qy qz qw\n")
        for ts, t, q in rows:
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")
    _write_tum_calib(os.path.join(root, "calib.xml"),
                     525.0, 525.0, 319.5, 239.5, 640, 480)
    open(os.path.join(root, "DONE"), "w").close()
    return {"root": root, "gt": os.path.join(root, "groundtruth.txt"),
            "calib": os.path.join(root, "calib.xml"),
            "rgb": os.path.join(root, "rgb")}


def real_datasets(root: str):
    """Real TUM/EUROC downloads in scripts/fetch_tum_euroc.sh's layout.

    Reference calibrations are written next to each sequence if absent
    (TUM: 640x480 fx=fy=525 no distortion, calibrationTUM.xml:7-21;
    EUROC: the real cam0 radtan coefficients, calibrationEUROC.xml:7-28)."""

    def tum(dirname):
        d = os.path.join(root, dirname)
        calib = os.path.join(d, "calib.xml")
        if os.path.isdir(d) and not os.path.exists(calib):
            _write_tum_calib(calib, 525.0, 525.0, 319.5, 239.5, 640, 480)
        return {"root": d, "gt": os.path.join(d, "groundtruth.txt"),
                "calib": calib, "rgb": os.path.join(d, "rgb")}

    def euroc(dirname):
        d = os.path.join(root, dirname)
        mav = os.path.join(d, "mav0")
        calib = os.path.join(d, "calib.xml")
        if os.path.isdir(d) and not os.path.exists(calib):
            _write_tum_calib(
                calib, 458.654, 457.296, 367.215, 248.375, 752, 480,
                dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
                out_w=736, out_h=480,
            )
        return {
            "root": mav,
            "gt": os.path.join(
                mav, "state_groundtruth_estimate0", "data.csv"
            ),
            "calib": calib,
        }

    sets = (tum("tum_seq01"), tum("tum_long"),
            euroc("euroc_mh01"), euroc("euroc_v101"))
    missing = [t["root"] for t in sets if not os.path.isdir(t["root"])]
    if missing:
        print("WARNING: missing real sequences (run "
              f"scripts/fetch_tum_euroc.sh): {missing}", file=sys.stderr)
    return sets


def make_euroc_dataset(root: str, n_frames: int, kind: str = "euroc_mh",
                       seed: int = 1, noise_sigma: float = 1.5) -> dict:
    """EUROC-format: 752x480 with radtan distortion (reference
    calibrationEUROC.xml:7-28 — real MAV0 cam0 coefficients), mav0 layout
    <root>/cam0/data/<ns>.pgm + state groundtruth CSV."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3, so3
    from uwslam_tpu.utils.synthetic import (
        apply_photometric,
        render_scene_view_distorted,
    )

    gt_path = os.path.join(root, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(os.path.join(root, "DONE")):
        return {"root": root, "gt": gt_path,
                "calib": os.path.join(root, "calib.xml")}
    os.makedirs(os.path.join(root, "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.dirname(gt_path), exist_ok=True)
    # EUROC cam0 intrinsics + radtan distortion (the real sequence values).
    cam = PinholeCamera(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        width=752, height=480,
        k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
    )
    scene = _scene(kind)
    poses = _trajectory(n_frames, scale=1.2)
    render = jax.jit(lambda T: render_scene_view_distorted(cam, T, scene))
    gt_rows = []
    for i, T_cw in enumerate(poses):
        ts_ns = int(round(i / 20.0 * 1e9))  # EUROC cam0 is 20 Hz
        img = render(T_cw)
        gain = 1.0 + 0.05 * np.sin(0.09 * i + 0.4)
        bias = 4.0 * np.sin(0.06 * i)
        img = apply_photometric(
            img, jax.random.PRNGKey(seed * 20011 + i),
            noise_sigma=noise_sigma, gain=gain, bias=bias,
        )
        _save_gray(
            os.path.join(root, "cam0", "data", f"{ts_ns:019d}.pgm"), img
        )
        T_wc = np.asarray(se3.inverse(T_cw))
        q = np.asarray(so3.to_quaternion(jnp.asarray(T_wc[:3, :3])))
        gt_rows.append((ts_ns, T_wc[:3, 3], q))
    with open(gt_path, "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for ts_ns, t, q in gt_rows:
            f.write(f"{ts_ns},{t[0]:.6f},{t[1]:.6f},{t[2]:.6f},"
                    f"{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},{q[3]:.6f}\n")
    _write_tum_calib(
        os.path.join(root, "calib.xml"),
        458.654, 457.296, 367.215, 248.375, 752, 480,
        dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
        out_w=736, out_h=480,  # reference out dims (calibrationEUROC.xml)
    )
    open(os.path.join(root, "DONE"), "w").close()
    return {"root": root, "gt": gt_path,
            "calib": os.path.join(root, "calib.xml")}


# ------------------------------------------------------------------ execution

ATE_RE = re.compile(r"ATE RMSE \(Sim3-aligned\): ([0-9.naife+-]+) m over (\d+)")
FPS_RE = re.compile(r"tracked (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps")
WARM_RE = re.compile(
    r"steady state: (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps warm"
)
WBA_RE = re.compile(
    r"window BA: (\d+) LM iters over (\d+) runs in ([0-9.]+)s "
    r"\(([0-9.]+) iters/s\)"
)
DBA_RE = re.compile(
    r"dist BA: (\d+) kfs, (\d+) landmarks, (\d+) obs over (\d+) devices: "
    r"(\d+) iters in ([0-9.]+)s \(([0-9.]+) iters/s\), cost "
    r"([0-9.eE+-]+) -> ([0-9.eE+-]+)( \(not applied\))?"
)
DBA_SKIP_RE = re.compile(r"dist BA: map too small, skipped")
LOOP_RE = re.compile(r"loop closure: (\d+) edges accepted")
DROP_RE = re.compile(r"ate_rmse dropping (\d+)/(\d+) non-finite")


def run_cli(cli_args: list[str], timeout: int = 3600) -> dict:
    """Run the CLI in a subprocess; parse fps / ATE / BA stats."""
    cmd = [sys.executable, "-m", "uwslam_tpu"] + cli_args
    print(f"  $ {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO,
    )
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    res: dict = {"rc": proc.returncode, "wall_s": round(wall, 1)}
    if proc.returncode != 0:
        res["error"] = out[-2000:]
        return res
    m = ATE_RE.search(out)
    if m:
        res["ate_rmse_m"] = float(m.group(1))
        res["ate_poses"] = int(m.group(2))
    m = DROP_RE.search(out)
    if m:
        # ATE was computed over a subset: non-finite pose pairs dropped
        # (ADVICE r4 — gated by a health check below).
        res["ate_dropped_pairs"] = int(m.group(1))
        res["ate_total_pairs"] = int(m.group(2))
    m = FPS_RE.search(out)
    if m:
        res["frames"] = int(m.group(1))
        res["fps"] = float(m.group(3))
    m = WARM_RE.search(out)
    if m:
        res["fps_warm"] = float(m.group(3))
        res["warm_frames"] = int(m.group(1))
    m = WBA_RE.search(out)
    if m:
        res["window_ba_iters"] = int(m.group(1))
        res["window_ba_iters_per_sec"] = float(m.group(4))
    m = LOOP_RE.search(out)
    if m:
        res["loop_edges"] = int(m.group(1))
    if DBA_SKIP_RE.search(out):
        res["dist_ba_skipped"] = True
    m = DBA_RE.search(out)
    if m:
        res["dist_ba_keyframes"] = int(m.group(1))
        res["dist_ba_landmarks"] = int(m.group(2))
        res["dist_ba_obs"] = int(m.group(3))
        res["dist_ba_devices"] = int(m.group(4))
        res["dist_ba_iters_per_sec"] = float(m.group(7))
        res["dist_ba_cost_initial"] = float(m.group(8))
        res["dist_ba_cost_final"] = float(m.group(9))
        res["dist_ba_applied"] = m.group(10) is None
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--round", type=int, default=4,
                    help="round number for the RESULTS_r<N>.json filename")
    ap.add_argument("--quick", action="store_true",
                    help="shorter sequences (smoke-test the harness)")
    ap.add_argument("--configs", default="0,1,2,3,4,5,6,7,8,9,10",
                    help="comma-separated subset to run")
    ap.add_argument("--real", default=None, metavar="ROOT",
                    help="run the table on REAL TUM/EUROC downloads under "
                         "ROOT (layout of scripts/fetch_tum_euroc.sh) "
                         "instead of the synthetic stand-ins")
    ap.add_argument("--ba-value", action="store_true",
                    help="run ONLY the window-BA value study: the config-4/"
                         "10 pair over 3 dataset seeds (VERDICT r4 next #9), "
                         "writing BA_VALUE_r<N>.json + a RESULTS.md section")
    args = ap.parse_args()
    # The parent renders datasets with JAX; the CLI children it starts open
    # the accelerator. Keep the parent on the CPU so it reserves no device
    # memory the children need (one process per card).
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT_DIR, exist_ok=True)
    if args.ba_value:
        return run_ba_value_study(args)
    which = {int(c) for c in args.configs.split(",")}

    n_tum = 60 if args.quick else 150
    n_euroc = 50 if args.quick else 120
    # Round 4 (VERDICT r3 missing #3): the long sequence is now
    # distribution-worthy — 640 frames, denser keyframing (--kf-max-gap),
    # so the global BA sees >=50 keyframes / thousands of landmarks /
    # >=10^4 observations instead of a toy 13-kf problem.
    n_long = 80 if args.quick else 640
    # The long sequence retraces its first loop_period frames exactly
    # (frames loop_period..n revisit 0..n-loop_period) — a true revisit for
    # the loop-closure stage.
    loop_period = 56 if args.quick else 160

    if args.real:
        print(f"using real datasets under {args.real}", flush=True)
        tum, tum_long, mh01, v101 = real_datasets(args.real)
    else:
        print("generating datasets...", flush=True)
        # Dataset roots carry the frame count: a cached quick (60-frame)
        # dataset must never masquerade as the full one (VERDICT r2 missing
        # #2 — the r2 table silently reported the quick smoke run).
        tum = make_tum_dataset(
            os.path.join(DATA_ROOT, f"tum_seq01_{n_tum}"), n_tum
        )
        tum_long = make_tum_dataset(
            os.path.join(DATA_ROOT, f"tum_long_{n_long}"), n_long, seed=4,
            loop_period=loop_period,
        )
        mh01 = make_euroc_dataset(
            os.path.join(DATA_ROOT, f"euroc_mh01_{n_euroc}"), n_euroc,
            kind="euroc_mh",
        )
        v101 = make_euroc_dataset(
            os.path.join(DATA_ROOT, f"euroc_v101_{n_euroc}"), n_euroc,
            kind="euroc_v1", seed=2,
        )

    long_args = ["-d", tum_long["rgb"], "-c", tum_long["calib"],
                 "--tum-gt", tum_long["gt"], "--levels", "4",
                 "--mono-depth", "2.5", "--features", "--ba",
                 "--depth-bootstrap", "--kf-max-gap", "6",
                 # 768 kp/level: at 512 the global track graph peaked at
                 # 2544 landmarks — under the >=3000 distribution-worthy
                 # floor (VERDICT r4 next #1; the r4 keypoint-density knob
                 # exists exactly for this).
                 "--kp-per-level", "768",
                 "--platform", "cpu", "--host-devices", "8"]

    configs = {
        0: {
            "name": "REFERENCE-SEMANTICS baseline (parity anchor)",
            "baseline": "reference active pipeline re-measured: <=200 "
                        "matched keypoints x patches, identity weights, "
                        "level-0 GN, 10 iters, z=1, no BA "
                        "(/root/reference/src/System.cpp:193-223)",
            "dataset": "tum_seq01 (same frames as config 1)",
            "args": ["-d", tum["rgb"], "-c", tum["calib"],
                     "--tum-gt", tum["gt"], "--reference-mode"],
        },
        1: {
            "name": "TUM mono direct tracking (3-level pyramid, no BA)",
            "baseline": "TUM mono seq01 direct tracking, 3-level pyramid, "
                        "GN on SE(3), no BA",
            "dataset": "tum_seq01 (synthetic multi-plane stand-in)",
            "args": ["-d", tum["rgb"], "-c", tum["calib"],
                     "--tum-gt", tum["gt"], "--levels", "3",
                     "--mono-depth", "2.5"],
        },
        2: {
            "name": "TUM mono + features/keyframes + depth bootstrap",
            "baseline": "TUM mono with feature detection + patch matching "
                        "and keyframe selection",
            "dataset": "tum_seq01 (same frames as config 1)",
            # Round-4 recipe (see TrackerConfig.weight_kind
            # rationale): 3 levels (the 5-level coarse schedule measured
            # 0.118 vs 0.089 — coarse levels pull toward aliased minima
            # under constant-depth model error), Huber weights (default),
            # affine brightness (0.089 -> 0.065 on the drifting-exposure
            # stand-in).
            # --bootstrap-shrink 0.25 (round 5): on 150-frame runs the
            # prior grid's structured depth error destabilizes LM; mostly-
            # median depth beat both the raw grid and constant depth
            # (0.0479 vs 0.0875 / 0.0535 across-seed spot checks).
            "args": ["-d", tum["rgb"], "-c", tum["calib"],
                     "--tum-gt", tum["gt"], "--levels", "3",
                     "--mono-depth", "2.5", "--features",
                     "--depth-bootstrap", "--affine",
                     "--bootstrap-shrink", "0.25"],
        },
        3: {
            "name": "EUROC MH01 rectified LM tracking (5-level, affine)",
            "baseline": "EUROC MAV MH_01 with distortion rectification + LM "
                        "photometric tracking, 5-level pyramid",
            "dataset": "euroc_mh01 (radtan-distorted synthetic stand-in)",
            "args": ["-d", mh01["root"], "--euroc", "-c", mh01["calib"],
                     "--euroc-gt", mh01["gt"], "--levels", "5",
                     "--mono-depth", "3.0", "--affine",
                     "--depth-bootstrap"],
        },
        4: {
            "name": "EUROC V101 sliding-window Schur BA",
            "baseline": "Keyframe sliding-window bundle adjustment (Schur "
                        "complement) on EUROC V1_01",
            "dataset": "euroc_v101 (radtan-distorted synthetic stand-in)",
            "args": ["-d", v101["root"], "--euroc", "-c", v101["calib"],
                     "--euroc-gt", v101["gt"], "--levels", "5",
                     "--mono-depth", "2.5", "--features", "--ba",
                     "--depth-bootstrap"],
        },
        5: {
            "name": "Long TUM + loop closure + global distributed BA "
                    "(8-device mesh)",
            "baseline": "Full multi-host run: partitioned keyframe map + "
                        "distributed pose-graph BA on long TUM sequence",
            "dataset": f"tum_long ({n_long} frames, exact revisit at frame "
                        f"{loop_period}; 8 virtual devices, landmark-sharded "
                        "Schur BA with psum pose reduction)",
            "args": long_args + ["--loop-closure", "--dist-ba"],
        },
        6: {
            "name": "ABLATION of 5: no distributed BA (odometry+loop only)",
            "baseline": "config 5 minus --dist-ba — the dist-BA ATE delta",
            "dataset": "tum_long (same frames as config 5)",
            "args": long_args + ["--loop-closure"],
        },
        7: {
            "name": "ABLATION of 5: no loop closure (odometry+dist-BA only)",
            "baseline": "config 5 minus --loop-closure — the loop ATE delta",
            "dataset": "tum_long (same frames as config 5)",
            "args": long_args + ["--dist-ba"],
        },
        8: {
            "name": "EUROC MH01 REFERENCE-SEMANTICS anchor",
            "baseline": "reference active pipeline on the EUROC scene "
                        "(rectification + level-0 GN, identity weights, "
                        "z=1) — the parity bar for config 3",
            "dataset": "euroc_mh01 (same frames as config 3)",
            "args": ["-d", mh01["root"], "--euroc", "-c", mh01["calib"],
                     "--euroc-gt", mh01["gt"], "--reference-mode"],
        },
        9: {
            "name": "EUROC V101 REFERENCE-SEMANTICS anchor",
            "baseline": "reference active pipeline on the EUROC V101 scene "
                        "— the parity bar for config 4",
            "dataset": "euroc_v101 (same frames as config 4)",
            "args": ["-d", v101["root"], "--euroc", "-c", v101["calib"],
                     "--euroc-gt", v101["gt"], "--reference-mode"],
        },
        10: {
            "name": "ABLATION of 4: no window BA",
            "baseline": "config 4 minus --ba — the window-BA ATE delta "
                        "(VERDICT r3 missing #4)",
            "dataset": "euroc_v101 (same frames as config 4)",
            "args": ["-d", v101["root"], "--euroc", "-c", v101["calib"],
                     "--euroc-gt", v101["gt"], "--levels", "5",
                     "--mono-depth", "2.5", "--features",
                     "--depth-bootstrap"],
        },
    }

    # Provenance stamp (ADVICE r4): every config entry records the commit
    # and time it was measured at, so partial-run merges cannot silently mix
    # results from different code versions.
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True,
        ).stdout.strip() or "unknown"
    except Exception:
        commit = "unknown"
    measured_at = time.strftime("%Y-%m-%dT%H:%M:%S")

    results = {}
    health = []
    for idx in sorted(which):
        cfg = configs[idx]
        print(f"config {idx}: {cfg['name']}", flush=True)
        res = run_cli(cfg["args"])
        res.update(
            {"name": cfg["name"], "baseline_config": cfg["baseline"],
             "dataset": cfg["dataset"], "commit": commit,
             "measured_at": measured_at}
        )
        results[str(idx)] = res
        print(f"  -> {json.dumps({k: v for k, v in res.items() if k not in ('name', 'baseline_config', 'dataset', 'error')})}",
              flush=True)
        if "error" in res:
            print(res["error"], flush=True)

    # Eval-level health assertions (VERDICT r2 missing #1: nothing guarded
    # that the global BA solved a REAL problem).
    def _check(cond, msg):
        if not cond:
            health.append(msg)
            print(f"HEALTH CHECK FAILED: {msg}", flush=True)

    for idx in ("5", "7"):
        r = results.get(idx)
        if r is None or r.get("rc") != 0:
            continue
        _check(not r.get("dist_ba_skipped"),
               f"config {idx}: distributed BA skipped (map too small)")
        _check(r.get("dist_ba_obs", 0) >= 100,
               f"config {idx}: dist BA ran on {r.get('dist_ba_obs', 0)} "
               f"observations (needs a real problem)")
        _check(r.get("dist_ba_applied", False),
               f"config {idx}: dist BA result was not applied")
    if "5" in results and "6" in results:
        a5 = results["5"].get("ate_rmse_m")
        a6 = results["6"].get("ate_rmse_m")
        if a5 is not None and a6 is not None:
            _check(a5 < a6,
                   f"config 5 ATE ({a5}) not better than no-dist-BA "
                   f"ablation ({a6})")
    if "5" in results:
        _check(results["5"].get("loop_edges", 0) > 0,
               "config 5: no loop-closure edges accepted on the revisit "
               "trajectory")
    r5 = results.get("5")
    if r5 is not None and r5.get("rc") == 0 and not args.quick:
        _check(r5.get("dist_ba_keyframes", 0) >= 50,
               f"config 5: only {r5.get('dist_ba_keyframes', 0)} keyframes "
               "in the global BA (needs >= 50: distribution-worthy scale)")
        _check(r5.get("dist_ba_landmarks", 0) >= 3000,
               f"config 5: only {r5.get('dist_ba_landmarks', 0)} landmarks "
               "(needs >= 3000)")
        _check(r5.get("dist_ba_obs", 0) >= 10000,
               f"config 5: only {r5.get('dist_ba_obs', 0)} observations "
               "(needs >= 10^4)")
    a4 = results.get("4", {}).get("ate_rmse_m")
    a10 = results.get("10", {}).get("ate_rmse_m")
    if a4 is not None and a10 is not None:
        _check(a4 < a10,
               f"config 4 ATE ({a4}) not better than its no-window-BA "
               f"ablation ({a10}) — window BA does not earn its cost")
    for cfg_i, anchor_i in (("3", "8"), ("4", "9")):
        ai = results.get(cfg_i, {}).get("ate_rmse_m")
        aa = results.get(anchor_i, {}).get("ate_rmse_m")
        if ai is not None and aa is not None:
            _check(ai < aa,
                   f"config {cfg_i} ATE ({ai}) does not beat its EUROC "
                   f"reference anchor (config {anchor_i}: {aa})")
    # Parity bar (VERDICT r3 missing #1): the framework's own default
    # configs must BEAT the measured reference-semantics anchor on the
    # same frames, or "matching-or-beating the reference" is unmet.
    a0 = results.get("0", {}).get("ate_rmse_m")
    a12 = [
        results[k]["ate_rmse_m"]
        for k in ("1", "2")
        if k in results and "ate_rmse_m" in results[k]
    ]
    if a0 is not None and a12:
        _check(min(a12) < a0,
               f"configs 1-2 (best ATE {min(a12)}) do not beat the "
               f"reference-semantics anchor (config 0 ATE {a0})")
    # The feature stack must EARN its ATE (VERDICT r4 weak #5: config 2
    # losing to plain direct tracking went unflagged for a round).
    a1 = results.get("1", {}).get("ate_rmse_m")
    a2 = results.get("2", {}).get("ate_rmse_m")
    if a1 is not None and a2 is not None:
        _check(a2 <= a1 * 1.1,
               f"config 2 ATE ({a2}) loses to plain direct tracking "
               f"(config 1: {a1}) — the feature/bootstrap stack subtracts "
               "accuracy")
    # Non-finite pose pairs dropped from ATE (ADVICE r4): a largely-NaN
    # trajectory must not report a competitive ATE unflagged.
    for idx, r in results.items():
        if idx.startswith("_") or not isinstance(r, dict):
            continue
        drop = r.get("ate_dropped_pairs", 0)
        total = r.get("ate_total_pairs", 0)
        if total:
            _check(drop <= 0.02 * total,
                   f"config {idx}: ATE dropped {drop}/{total} non-finite "
                   "pose pairs (> 2%)")
    if health:
        results["_health"] = {"failed": health}

    out_json = os.path.join(OUT_DIR, f"RESULTS_r{args.round:02d}.json")
    # Partial runs (--configs subset) merge into an existing table rather
    # than clobbering configs they did not run.
    if os.path.exists(out_json):
        try:
            with open(out_json) as f:
                prev = json.load(f)
            for k, v in prev.items():
                if not k.startswith("_") and k not in results:
                    if isinstance(v, dict) and v.get("commit") != commit:
                        print(
                            f"WARNING: merged config {k} was measured at "
                            f"commit {v.get('commit', 'unknown')} (this run: "
                            f"{commit}) — the table mixes code versions",
                            file=sys.stderr,
                        )
                    results[k] = v
        except Exception:
            pass
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    write_results_md(results, os.path.join(OUT_DIR, "RESULTS.md"))
    print(f"wrote {out_json} and {OUT_DIR}/RESULTS.md")
    return 0


def run_ba_value_study(args) -> int:
    """Window-BA value over dataset seeds (VERDICT r4 weak #4: a single-seed
    3.3% margin proves nothing). Runs the config-4 arg set with and without
    --ba on 3 differently-seeded EUROC V101 stand-ins; reports per-seed ATEs
    and the mean improvement."""
    n_euroc = 50 if args.quick else 120
    seeds = (2, 12, 22)
    rows = []
    for seed in seeds:
        ds = make_euroc_dataset(
            os.path.join(DATA_ROOT, f"euroc_v101_{n_euroc}_s{seed}"),
            n_euroc, kind="euroc_v1", seed=seed,
        )
        base = ["-d", ds["root"], "--euroc", "-c", ds["calib"],
                "--euroc-gt", ds["gt"], "--levels", "5",
                "--mono-depth", "2.5", "--features", "--depth-bootstrap"]
        print(f"seed {seed}: with BA", flush=True)
        with_ba = run_cli(base + ["--ba"])
        # Prior-stiffness arm (VERDICT r4 next #9 asked WHY the window solve
        # adds so little; hypothesis: pose_prior_weight=1e5 pins the window
        # to odometry so tightly the reprojection term can barely move it).
        print(f"seed {seed}: with BA, soft prior", flush=True)
        with_soft = run_cli(base + ["--ba", "--ba-prior-weight", "1e3"])
        print(f"seed {seed}: without BA", flush=True)
        without = run_cli(base)
        rows.append({
            "seed": seed,
            "ate_with_ba": with_ba.get("ate_rmse_m"),
            "ate_with_ba_soft_prior": with_soft.get("ate_rmse_m"),
            "ate_without_ba": without.get("ate_rmse_m"),
            "fps_warm_with_ba": with_ba.get("fps_warm"),
            "fps_warm_without_ba": without.get("fps_warm"),
            "ba_iters": with_ba.get("window_ba_iters"),
        })
        print(f"  -> {json.dumps(rows[-1])}", flush=True)
    ok = [r for r in rows
          if r["ate_with_ba"] is not None and r["ate_without_ba"] is not None]
    imp = [1.0 - r["ate_with_ba"] / r["ate_without_ba"] for r in ok]
    imp_soft = [
        1.0 - r["ate_with_ba_soft_prior"] / r["ate_without_ba"]
        for r in rows
        if r.get("ate_with_ba_soft_prior") is not None
        and r["ate_without_ba"] is not None
    ]
    out = {
        "note": "config-4 arg set +/- --ba over 3 dataset seeds "
                "(EUROC V101 stand-in geometry, different texture/noise/"
                "photometric draws). improvement = 1 - ate_with/ate_without. "
                "soft_prior arm: --ba-prior-weight 1e3 (default 1e5) — the "
                "prior-stiffness probe.",
        "rows": rows,
        "improvement_mean": round(float(sum(imp) / max(len(imp), 1)), 4),
        "improvement_min": round(min(imp), 4) if imp else None,
        "improvement_max": round(max(imp), 4) if imp else None,
        "improvement_soft_prior_mean": round(
            float(sum(imp_soft) / max(len(imp_soft), 1)), 4
        ) if imp_soft else None,
    }
    path = os.path.join(OUT_DIR, f"BA_VALUE_r{args.round:02d}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}: mean improvement "
          f"{100 * out['improvement_mean']:.1f}% over {len(ok)} seeds")
    return 0


def write_results_md(results: dict, path: str) -> None:
    lines = [
        "# RESULTS — BASELINE.json staged configs, measured end-to-end",
        "",
        "Produced by `python eval.py` (one command reproduces this table).",
        "Hardware: the default JAX device for configs 0-4 and 8-10; "
        "configs 5-7 run on an 8-virtual-device CPU mesh "
        "(`--platform cpu --host-devices 8`).",
        "",
        "fps columns: `fps` times the WHOLE run including XLA compilation "
        "(cold); `warm fps` excludes the first 15 frames, i.e. the steady "
        "state the live loop sustains. Config 0 is the measured "
        "reference-semantics baseline (the parity anchor BASELINE.md "
        "requires); configs 6/7 are ablations of config 5 isolating the "
        "distributed-BA and loop-closure ATE contributions.",
        "",
        "**Dataset caveat (per VERDICT r1 item 1):** real TUM/EUROC are not "
        "fetchable here (no network egress). Each config runs a synthetic "
        "stand-in: multi-plane occluding scenes (depth ratio ~3.5x, real "
        "occlusion boundaries), Gaussian sensor noise, per-frame brightness "
        "drift, exact analytic ground truth, and the dataset's real on-disk "
        "format (TUM dir + groundtruth.txt; EUROC mav0 layout + state CSV + "
        "radtan distortion with the real MH01 cam0 coefficients, "
        "rectification exercised end-to-end).",
        "",
        "| # | Config (BASELINE.json) | ATE RMSE (m) | fps | warm fps | "
        "BA iters/s | notes |",
        "|---|---|---|---|---|---|---|",
    ]
    for idx in sorted((k for k in results if not k.startswith("_")), key=int):
        r = results[idx]
        ate = f"{r['ate_rmse_m']:.4f}" if "ate_rmse_m" in r else "—"
        fps = f"{r['fps']:.1f}" if "fps" in r else "—"
        warm = f"{r['fps_warm']:.1f}" if "fps_warm" in r else "—"
        ba = (
            f"{r['dist_ba_iters_per_sec']:.1f} (dist, "
            f"{r.get('dist_ba_devices', '?')} dev)"
            if "dist_ba_iters_per_sec" in r
            else f"{r['window_ba_iters_per_sec']:.1f} (window)"
            if "window_ba_iters_per_sec" in r
            else "—"
        )
        notes = []
        if "frames" in r:
            notes.append(f"{r['frames']} frames")
        if "dist_ba_landmarks" in r:
            notes.append(
                f"{r['dist_ba_landmarks']} landmarks/"
                f"{r['dist_ba_obs']} obs global BA"
                + ("" if r.get("dist_ba_applied") else " NOT APPLIED")
            )
        if r.get("dist_ba_skipped"):
            notes.append("dist BA SKIPPED")
        if "loop_edges" in r:
            notes.append(f"{r['loop_edges']} loop edges")
        if r.get("rc") != 0:
            notes.append("FAILED")
        lines.append(
            f"| {idx} | {r['baseline_config']} | {ate} | {fps} | {warm} | "
            f"{ba} | {'; '.join(notes)} |"
        )
    lines += [
        "",
        "ATE context: the camera path spans ~0.6 m excursion over 1.4-6 m "
        "deep scenes; monocular scale is resolved only up to gauge, so ATE "
        "is Sim(3)-aligned (the standard monocular protocol).",
        "",
    ]
    if "_health" in results:
        lines += ["## HEALTH CHECK FAILURES", ""]
        lines += [f"- {m}" for m in results["_health"]["failed"]]
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    raise SystemExit(main())
