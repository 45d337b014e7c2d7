"""Distributed-BA scaling curve — fixed-budget iters/s at 1/2/4/8 devices,
with a compute-vs-collective breakdown (VERDICT r3 missing #5).

The curve is measured on an 8-virtual-device CPU mesh
(--xla_force_host_platform_device_count). Virtual devices SHARE the host's
physical cores, so the measured efficiency column reflects the substrate,
not the algorithm; the breakdown columns separate the two:

- `shard_compute_s`: the SAME per-shard program (L/n landmarks, full
  iteration budget) run on a single device — the pure sharded-compute time
  one independent chip would spend, no collectives.
- `work_division_pct` = T_shard(1) / (n * T_shard(n)): how perfectly the
  landmark-sharded Schur LM divides its work (100% = each shard does exactly
  1/n of the single-device work). This is the quantity that carries to real
  independent chips.
- `comm_bytes_per_iter`: the analytic psum payload (S_red M^2*36 + U M*36 +
  rhs/g M*6*2 + cost scalars, f32) — independent of landmark count. Over
  NVLink this is microseconds/iteration, so projected independent-device
  efficiency ~= work_division_pct.

All runs use full_budget=True (exactly max_iters LM iterations) so the
device counts compare like-for-like (round-3 curve compared runs with 25/23/
29/27 iterations).

Usage: python benchmarks/scaling.py [--out FILE]
"""
from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# If jax was imported before this file, the env var above is too late —
# set the platform through config too.
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

MAX_ITERS = 30


def make_problem(M: int, L: int, obs_per_lm: int = 6, seed: int = 0):
    """Synthetic global-BA problem: cameras on an arc looking inward,
    landmarks in the volume, observations perturbed by 0.5 px noise and the
    poses by odometry-like drift (so LM has real work to do)."""
    from uwslam_tpu.ba.schur import BAProblem
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3

    rng = np.random.default_rng(seed)
    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                        width=640, height=480)
    T_cw_gt = []
    for i in range(M):
        a = 2 * np.pi * i / M * 0.25  # quarter arc: neighbors co-visible
        C = np.array([4 * np.sin(a), 0.2 * np.sin(3 * a), -4 * np.cos(a)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_wc = np.stack([x, y, z], axis=1)
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ C
        T_cw_gt.append(T)
    T_cw_gt = np.stack(T_cw_gt)

    pts = rng.uniform([-1.5, -1.0, -1.5], [1.5, 1.0, 1.5], (L, 3))

    obs_kf, obs_lm, obs_uv = [], [], []
    for l in range(L):
        base = rng.integers(0, M)
        for k in range(obs_per_lm):
            m = (base + k) % M
            pc = T_cw_gt[m][:3, :3] @ pts[l] + T_cw_gt[m][:3, 3]
            if pc[2] < 0.5:
                continue
            u = 525.0 * pc[0] / pc[2] + 319.5 + rng.normal(0, 0.5)
            v = 525.0 * pc[1] / pc[2] + 239.5 + rng.normal(0, 0.5)
            if 0 <= u < 640 and 0 <= v < 480:
                obs_kf.append(m)
                obs_lm.append(l)
                obs_uv.append((u, v))
    O = len(obs_kf)

    T_cw0 = []
    for i, T in enumerate(T_cw_gt):
        drift = 0.02 * i / M
        xi = np.concatenate([
            rng.normal(0, drift, 3), rng.normal(0, drift * 0.3, 3)
        ]).astype(np.float32)
        T_cw0.append(np.asarray(
            se3.compose(se3.exp(jnp.asarray(xi)), jnp.asarray(T, jnp.float32))
        ))
    pts0 = pts + rng.normal(0, 0.05, pts.shape)

    problem = BAProblem(
        T_cw=jnp.asarray(np.stack(T_cw0), jnp.float32),
        points=jnp.asarray(pts0, jnp.float32),
        obs_kf=jnp.asarray(np.array(obs_kf), jnp.int32),
        obs_lm=jnp.asarray(np.array(obs_lm), jnp.int32),
        obs_uv=jnp.asarray(np.array(obs_uv), jnp.float32),
        obs_valid=jnp.ones(O, bool),
    )
    return problem, cam, O


def _shard_slice(sharded, n_dev: int):
    """Shard 0 of an n_dev-sharded problem, as a standalone 1-device problem
    (same M, L/n landmarks, O/n observations) — the per-shard compute anchor."""
    from uwslam_tpu.ba.schur import BAProblem

    L = sharded.points.shape[0] // n_dev
    O = sharded.obs_kf.shape[0] // n_dev
    return BAProblem(
        T_cw=sharded.T_cw,
        points=sharded.points[:L],
        obs_kf=sharded.obs_kf[:O],
        obs_lm=sharded.obs_lm[:O],
        obs_uv=sharded.obs_uv[:O],
        obs_valid=sharded.obs_valid[:O],
    )


def run_curve(problem, cam, O, M, L, label, solver="auto"):
    from jax.sharding import Mesh

    from uwslam_tpu.parallel import AXIS, distributed_bundle_adjust, shard_problem

    print(f"[{label}] {M} poses, {L} landmarks, {O} observations",
          file=sys.stderr)
    use_pcg = solver == "pcg"
    if use_pcg:
        # PCG (round 5): per LM iteration psum{U M*36, g M*6, precond diag
        # M*36, rhs_red M*6, cost 2} + one (M, 6) psum per CG step (<=64,
        # early-exited) — O(M) per step instead of O(M^2) per iteration.
        comm_bytes = 4 * (M * 36 + M * 6 + M * 36 + M * 6 + 4)
        comm_note = "per LM iter, + M*24 B per CG step (<=64 steps)"
    else:
        comm_bytes = 4 * (M * M * 36 + M * 36 + 2 * M * 6 + 4)
        comm_note = "per LM iter (S_red dominates, O(M^2))"

    def timed(prob, mesh, reps: int = 3):
        def run():
            t0 = time.perf_counter()
            out = distributed_bundle_adjust(
                prob, cam, mesh, max_iters=MAX_ITERS,
                huber_delta=2.0, num_fixed_poses=2, full_budget=True,
                solver=solver,
            )
            it = int(out.iterations)  # device sync
            return out, it, time.perf_counter() - t0
        run()                        # compile
        # Median of `reps` steady-state runs: single-shot timings on the
        # shared-core virtual substrate scattered work_division_pct by
        # +/-30% (round-4 curve) whenever anything else touched the host.
        results = [run() for _ in range(reps)]
        results.sort(key=lambda r: r[2])
        return results[len(results) // 2]

    rows = []
    t1 = None
    tshard1 = None
    for n_dev in (1, 2, 4, 8):
        devs = np.array(jax.devices()[:n_dev])
        mesh = Mesh(devs, (AXIS,))
        sharded = shard_problem(problem, n_dev)
        out, iters, dt = timed(sharded, mesh)
        # Per-shard compute anchor: shard 0 alone on a 1-device mesh.
        anchor = _shard_slice(sharded, n_dev)
        mesh1 = Mesh(np.array(jax.devices()[:1]), (AXIS,))
        _, _, dt_shard = timed(shard_problem(anchor, 1), mesh1)
        ips = iters / max(dt, 1e-9)
        if t1 is None:
            t1 = ips
            tshard1 = dt_shard
        rows.append({
            "devices": n_dev,
            "iterations": iters,
            "seconds": round(dt, 3),
            "iters_per_sec": round(ips, 2),
            "speedup_vs_1dev": round(ips / t1, 2),
            "efficiency_pct_virtual_substrate": round(
                ips / (t1 * n_dev) * 100.0, 1
            ),
            "shard_compute_s": round(dt_shard, 3),
            "work_division_pct": round(
                tshard1 / (n_dev * dt_shard) * 100.0, 1
            ),
            "solver": "pcg" if use_pcg else "direct",
            "comm_bytes_per_iter": comm_bytes,
            "comm_note": comm_note,
            "cost_initial": float(out.initial_cost),
            "cost_final": float(out.cost),
        })
        print(json.dumps(rows[-1]))
    return rows


def main() -> None:
    out = {
        "note": (
            "8-virtual-device CPU mesh; virtual devices SHARE 2 physical "
            "host cores, so efficiency_pct_virtual_substrate measures the "
            "substrate, not the algorithm (total FLOPs are constant across "
            "the curve and the host can only run ~2 shards concurrently). "
            "The algorithm's scaling potential is work_division_pct — the "
            "measured fraction of single-device compute each shard actually "
            "carries — plus a comm term that is O(M^2) bytes/iteration "
            "independent of landmark count (microseconds over NVLink). All rows "
            "use an identical fixed budget of "
            f"{MAX_ITERS} LM iterations."
        ),
        "curves": {},
    }
    solver = "auto"
    if "--solver" in sys.argv:
        solver = sys.argv[sys.argv.index("--solver") + 1]
    for (M, L, label) in ((16, 16384, "wide"), (64, 8192, "session-map")):
        problem, cam, O = make_problem(M, L)
        out["curves"][label] = {
            "problem": {"poses": M, "landmarks": L, "observations": O,
                        "max_iters": MAX_ITERS},
            "scaling": run_curve(problem, cam, O, M, L, label,
                                 solver=solver),
        }
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
