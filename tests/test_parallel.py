"""Distributed BA tests on the virtual 8-device CPU mesh.

Validates the multi-chip sharding path without several GPUs
(xla_force_host_platform_device_count=8 from conftest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from uwslam_tpu.ba import BAProblem, bundle_adjust
from uwslam_tpu.camera import PinholeCamera
from uwslam_tpu.lie import se3
from uwslam_tpu.parallel import AXIS, distributed_bundle_adjust, shard_problem

CAM = PinholeCamera(fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240)


def make_problem(key, num_kf=4, num_lm=96, pose_noise=0.02, point_noise=0.05):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
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
            se3.exp(jnp.asarray([0.08 * i, 0.01 * i, 0.0, 0.0, 0.005 * i, 0.0]))
            for i in range(num_kf)
        ]
    )
    kf_idx = jnp.repeat(jnp.arange(num_kf), num_lm).astype(jnp.int32)
    lm_idx = jnp.tile(jnp.arange(num_lm), num_kf).astype(jnp.int32)
    p_c = se3.apply(T_gt[kf_idx], pts_gt[lm_idx])
    uv = CAM.project(p_c)
    dT = pose_noise * jax.random.normal(k4, (num_kf, 6))
    dT = dT.at[0].set(0.0)
    T_init = jax.vmap(lambda T, d: se3.compose(se3.exp(d), T))(T_gt, dT)
    pts_init = pts_gt + point_noise * jax.random.normal(k5, pts_gt.shape)
    return (
        BAProblem(
            T_cw=T_init, points=pts_init,
            obs_kf=kf_idx, obs_lm=lm_idx, obs_uv=uv,
            obs_valid=jnp.ones_like(kf_idx, dtype=bool),
        ),
        T_gt,
        pts_gt,
    )


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, (AXIS,))


class TestShardProblem:
    def test_preserves_geometry(self):
        problem, T_gt, pts_gt = make_problem(jax.random.PRNGKey(0))
        sharded = shard_problem(problem, 8)
        assert sharded.points.shape[0] % 8 == 0
        assert sharded.obs_kf.shape[0] % 8 == 0
        # Every valid observation must reference the same (uv, point) pair.
        va = np.asarray(sharded.obs_valid)
        pts = np.asarray(sharded.points)[np.asarray(sharded.obs_lm)[va]]
        T = np.asarray(sharded.T_cw)[np.asarray(sharded.obs_kf)[va]]
        # Project and compare with stored uv (init state, so inexact — just
        # verify the mapping is consistent with the unsharded problem).
        p_c = np.einsum("oij,oj->oi", T[:, :3, :3], pts) + T[:, :3, 3]
        uv = np.stack(
            [
                CAM.fx * p_c[:, 0] / p_c[:, 2] + CAM.cx,
                CAM.fy * p_c[:, 1] / p_c[:, 2] + CAM.cy,
            ],
            axis=-1,
        )
        # Original problem's consistency level:
        va0 = np.asarray(problem.obs_valid)
        pts0 = np.asarray(problem.points)[np.asarray(problem.obs_lm)[va0]]
        T0 = np.asarray(problem.T_cw)[np.asarray(problem.obs_kf)[va0]]
        p0 = np.einsum("oij,oj->oi", T0[:, :3, :3], pts0) + T0[:, :3, 3]
        uv0 = np.stack(
            [
                CAM.fx * p0[:, 0] / p0[:, 2] + CAM.cx,
                CAM.fy * p0[:, 1] / p0[:, 2] + CAM.cy,
            ],
            axis=-1,
        )
        r_sharded = np.linalg.norm(uv - np.asarray(sharded.obs_uv)[va], axis=1)
        r_orig = np.linalg.norm(uv0 - np.asarray(problem.obs_uv)[va0], axis=1)
        assert abs(np.sort(r_sharded).sum() - np.sort(r_orig).sum()) < 1e-2


class TestDistributedBA:
    def test_matches_single_device_result(self, mesh):
        problem, T_gt, pts_gt = make_problem(jax.random.PRNGKey(1))
        single = bundle_adjust(problem, CAM, max_iters=15)
        sharded = shard_problem(problem, 8)
        dist = distributed_bundle_adjust(sharded, CAM, mesh, max_iters=15)
        # Both must converge to the ground-truth poses.
        for i in range(T_gt.shape[0]):
            e_s = se3.log(se3.compose(se3.inverse(T_gt[i]), single.T_cw[i]))
            e_d = se3.log(se3.compose(se3.inverse(T_gt[i]), dist.T_cw[i]))
            assert float(jnp.linalg.norm(e_s)) < 5e-3
            assert float(jnp.linalg.norm(e_d)) < 5e-3
        assert float(dist.cost) < float(dist.initial_cost) * 1e-2

    def test_runs_on_subset_mesh(self):
        devs = np.array(jax.devices()[:2])
        mesh2 = Mesh(devs, (AXIS,))
        problem, T_gt, _ = make_problem(jax.random.PRNGKey(2), num_lm=64)
        sharded = shard_problem(problem, 2)
        out = distributed_bundle_adjust(sharded, CAM, mesh2, max_iters=10)
        assert np.isfinite(float(out.cost))
        e = se3.log(se3.compose(se3.inverse(T_gt[1]), out.T_cw[1]))
        assert float(jnp.linalg.norm(e)) < 1e-2


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys
        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as ge

        fn, args = ge.entry()
        T = jax.jit(fn)(*args)
        assert np.all(np.isfinite(np.asarray(T)))

    def test_dryrun_multichip(self):
        import sys
        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])


class TestSequenceParallel:
    def test_sharded_matches_single_device(self):
        """Chunked multi-device tracking must recover the same trajectory as
        the sequential single-device path (same ATE bound)."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from jax.sharding import Mesh

        from uwslam_tpu.camera import PinholeCamera
        from uwslam_tpu.io import ate_rmse
        from uwslam_tpu.lie import se3
        from uwslam_tpu.parallel import SEQ_AXIS, track_sequence_sharded
        from uwslam_tpu.tracking import compose_trajectory
        from uwslam_tpu.utils.synthetic import render_plane_view

        cam = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5,
                            width=160, height=120)
        n = 9
        poses = [
            se3.exp(jnp.asarray(
                [0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i,
                 0.003 * i], jnp.float32))
            for i in range(n)
        ]
        frames = jnp.stack([render_plane_view(cam, T, 2.0) for T in poses])
        mesh = Mesh(np.array(jax.devices()[:4]), (SEQ_AXIS,))
        gt_wc = np.stack([np.asarray(se3.inverse(T)) for T in poses])
        # Both per-chunk flavors: data-parallel pairs (vmap inside
        # shard_map — the two parallelism levels compose) and the
        # sequential scan with its constant-velocity prior.
        for batched in (True, False):
            T_rel, inliers, errors = track_sequence_sharded(
                frames, cam, mesh, mono_z=2.0, levels=4,
                track_levels=(2, 1, 0), num_points=512, max_iters=12,
                batched=batched,
            )
            assert T_rel.shape == (n - 1, 4, 4)
            T_wc = np.asarray(compose_trajectory(T_rel))
            rmse = ate_rmse(T_wc[:, :3, 3], gt_wc[:, :3, 3])
            assert rmse < 0.01, f"ATE {rmse} batched={batched}"
            assert int(inliers.min()) > 200
