"""Worker process for the two-process jax.distributed test.

Each of the two processes exposes 4 virtual CPU devices (8 global), joins
the coordinator, builds the landmark mesh over ALL global devices, and runs
one distributed_bundle_adjust whose psums cross the process boundary — the
multi-process control path that single-process 8-device tests cannot exercise.

Usage: python _dist_worker.py <process_id> <coordinator_port> <out_json>
"""
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    out_path = sys.argv[3]

    from uwslam_tpu.parallel import runtime

    runtime.init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4, len(jax.local_devices())

    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from uwslam_tpu.ba import BAProblem
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3
    from uwslam_tpu.parallel import (
        AXIS,
        distributed_bundle_adjust,
        shard_problem,
    )

    cam = PinholeCamera(
        fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240
    )
    # Both processes build the identical problem (same PRNG).
    key = jax.random.PRNGKey(11)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    num_kf, num_lm = 4, 96
    pts_gt = jnp.stack(
        [
            jax.random.uniform(k1, (num_lm,), minval=-1.5, maxval=1.5),
            jax.random.uniform(k2, (num_lm,), minval=-1.0, maxval=1.0),
            jax.random.uniform(k3, (num_lm,), minval=3.0, maxval=6.0),
        ],
        axis=-1,
    )
    T_gt = jnp.stack(
        [
            se3.exp(
                jnp.asarray([0.08 * i, 0.01 * i, 0.0, 0.0, 0.005 * i, 0.0])
            )
            for i in range(num_kf)
        ]
    )
    kf_idx = jnp.repeat(jnp.arange(num_kf), num_lm).astype(jnp.int32)
    lm_idx = jnp.tile(jnp.arange(num_lm), num_kf).astype(jnp.int32)
    uv = cam.project(se3.apply(T_gt[kf_idx], pts_gt[lm_idx]))
    dT = 0.02 * jax.random.normal(k4, (num_kf, 6))
    dT = dT.at[0].set(0.0)
    T_init = jax.vmap(lambda T, d: se3.compose(se3.exp(d), T))(T_gt, dT)
    pts_init = pts_gt + 0.05 * jax.random.normal(k5, pts_gt.shape)
    problem = BAProblem(
        T_cw=T_init, points=pts_init,
        obs_kf=kf_idx, obs_lm=lm_idx, obs_uv=uv,
        obs_valid=jnp.ones_like(kf_idx, dtype=bool),
    )
    sharded = shard_problem(problem, 8)

    mesh = runtime.landmark_mesh()
    assert mesh.shape[AXIS] == 8

    def to_global(x, spec):
        """Host-replicated full array -> global jax.Array on the 2-process
        mesh. For sharded specs each process hands over its own contiguous
        chunk (jax.devices() orders process 0's devices first, matching the
        mesh layout)."""
        x = np.asarray(x)
        if spec == P(AXIS):
            chunk = x.shape[0] // jax.process_count()
            x = x[pid * chunk:(pid + 1) * chunk]
        return multihost_utils.host_local_array_to_global_array(
            x, mesh, spec
        )

    g = BAProblem(
        T_cw=to_global(sharded.T_cw, P()),
        points=to_global(sharded.points, P(AXIS)),
        obs_kf=to_global(sharded.obs_kf, P(AXIS)),
        obs_lm=to_global(sharded.obs_lm, P(AXIS)),
        obs_uv=to_global(sharded.obs_uv, P(AXIS)),
        obs_valid=to_global(sharded.obs_valid, P(AXIS)),
    )
    out = distributed_bundle_adjust(g, cam, mesh, max_iters=15)
    cost = float(out.cost)
    c0 = float(out.initial_cost)
    # Poses come back replicated (P()), so every process can read them.
    T_out = np.asarray(jax.device_get(out.T_cw))
    pose_err = 0.0
    for i in range(num_kf):
        e = se3.log(
            se3.compose(se3.inverse(T_gt[i]), jnp.asarray(T_out[i]))
        )
        pose_err = max(pose_err, float(jnp.linalg.norm(e)))

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(
                {
                    "processes": jax.process_count(),
                    "global_devices": len(jax.devices()),
                    "initial_cost": c0,
                    "final_cost": cost,
                    "max_pose_err": pose_err,
                },
                f,
            )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
