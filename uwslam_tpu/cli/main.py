"""CLI entry point — reference flag parity + computed evaluation.

Mirrors the reference's flags (appended to its vendored parser at
/root/reference/include/args.hxx:3659-3668; consumed at
src/main_uw_slam.cpp:74-122):
  -d/--directory   images directory          -> --directory
  -s/--start       start index               -> --start
  -c/--calibration calibration XML           -> --calibration
  -p/--depth       TUM depth directory       -> --depth
  --TUM / --EUROC  ground-truth path + mode  -> --tum-gt / --euroc-gt

Plus what the reference lacks: --trajectory-out (TUM-format export; replaces
the hardcoded CSV at src/Visualizer.cpp:291) and computed ATE RMSE against
ground truth (replaces eyeball-Rviz validation).
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="uwslam-tpu",
        description="Monocular SLAM in JAX (uw-slam capability surface)",
    )
    p.add_argument("-d", "--directory", required=True,
                   help="directory of input images")
    p.add_argument("-s", "--start", type=int, default=0,
                   help="start index in the dataset")
    p.add_argument("-c", "--calibration", required=True,
                   help="calibration XML (OpenCV FileStorage) or JSON")
    p.add_argument("-p", "--depth", default=None,
                   help="TUM depth image directory (optional)")
    # --TUM / --EUROC are the reference's exact flag spellings
    # (include/args.hxx:3660-3661) and alias the descriptive names.
    p.add_argument("--tum-gt", "--TUM", default=None,
                   help="TUM ground-truth file for ATE evaluation")
    p.add_argument("--euroc-gt", "--EUROC", default=None,
                   help="EUROC ground-truth CSV for ATE evaluation")
    p.add_argument("--trajectory-out", default=None,
                   help="write estimated trajectory (TUM format)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--levels", type=int, default=5, help="pyramid levels")
    p.add_argument("--euroc", action="store_true",
                   help="treat -d as an EUROC mav0 dir (cam0/data/*.png)")
    p.add_argument("--features", action="store_true",
                   help="feature front-end: detection + patch matching "
                        "(BASELINE config 2)")
    p.add_argument("--ba", action="store_true",
                   help="sliding-window bundle adjustment (BASELINE config 4)")
    p.add_argument("--ba-prior-weight", type=float, default=None,
                   help="window-BA pose-prior information weight anchoring "
                        "window poses to tracked odometry (default "
                        "BAConfig.pose_prior_weight; lower = BA trusts its "
                        "reprojection residuals more)")
    p.add_argument("--photo-ba", action="store_true",
                   help="direct photometric window BA over keyframe pyramids "
                        "(the cost the reference's Ceres scaffolding "
                        "intended) instead of feature reprojection BA")
    p.add_argument("--loop-closure", action="store_true",
                   help="loop detection + pose-graph correction")
    p.add_argument("--dist-ba", action="store_true",
                   help="end-of-run GLOBAL distributed bundle adjustment: "
                        "landmarks partitioned over every available device "
                        "(jax.sharding.Mesh), Schur pose blocks psum-reduced "
                        "across devices (BASELINE config 5); implies "
                        "--features")
    p.add_argument("--mono-depth", type=float, default=1.0,
                   help="assumed scene depth for pure-mono tracking")
    p.add_argument("--reference-mode", action="store_true",
                   help="reference-semantics preset for the parity baseline "
                        "(BASELINE.md): identity weights, <=200 matched "
                        "keypoints x patch points, level-0-only GN, 10 "
                        "iters, constant z (--mono-depth, reference z=1), "
                        "no BA / bootstrap / failure detection — the active "
                        "pipeline of /root/reference/src/System.cpp:193-223")
    p.add_argument("--loop-se3", action="store_true",
                   help="with --loop-closure: optimize the pose graph over "
                        "SE(3) instead of Sim(3) (A/B the scale-drift "
                        "absorption)")
    p.add_argument("--depth-bootstrap", action="store_true",
                   help="monocular depth bootstrapping: triangulate feature "
                        "matches against the tracked pose and feed the "
                        "coarse inverse-depth prior to point selection "
                        "(replaces the constant mono-depth assumption; "
                        "implies --features)")
    p.add_argument("--num-points", type=int, default=2048,
                   help="tracked point budget per frame")
    p.add_argument("--bootstrap-edge-ratio", type=float, default=None,
                   help="with --depth-bootstrap: drop selected points whose "
                        "prior read straddles a depth discontinuity (the 4 "
                        "interpolation cells disagree by more than this "
                        "ratio); 0 disables (default: TrackerConfig)")
    p.add_argument("--bootstrap-block", type=int, default=None,
                   help="with --depth-bootstrap: inverse-depth prior grid "
                        "cell size in pixels (default: TrackerConfig)")
    p.add_argument("--bootstrap-shrink", type=float, default=None,
                   help="with --depth-bootstrap: blend prior depth reads "
                        "toward the grid median (1.0 = raw structure; "
                        "~0.25 stabilizes long runs — see TrackerConfig)")
    p.add_argument("--kf-min-gap", type=int, default=3,
                   help="minimum frames between keyframes")
    p.add_argument("--kf-max-gap", type=int, default=30,
                   help="maximum frames between keyframes (lower = denser "
                        "keyframe map, e.g. for global distributed BA at "
                        "scale)")
    p.add_argument("--kp-per-level", type=int, default=256,
                   help="feature keypoint capacity per pyramid level "
                        "(raise for denser global-BA track graphs)")
    p.add_argument("--viz-port", type=int, default=None,
                   help="serve a live trajectory view on this HTTP port "
                        "(the reference's Rviz stream, without ROS)")
    p.add_argument("--map-out", default=None,
                   help="write the keyframe map as a PLY point cloud")
    p.add_argument("--checkpoint", default=None,
                   help="save the session state here when done")
    p.add_argument("--resume", default=None,
                   help="resume a previously saved session checkpoint")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage timing breakdown")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace into DIR "
                        "(view with TensorBoard/XProf)")
    p.add_argument("--weights", choices=("tukey", "huber", "none"),
                   default="huber",
                   help="robust IRLS kernel for photometric tracking "
                        "(measured: huber 0.053 / none 0.052 / tukey 0.148 "
                        "ATE on the TUM stand-in — see TrackerConfig; "
                        "reference ships Tukey but runs identity, "
                        "src/Tracker.cpp:769)")
    p.add_argument("--track-levels", default=None,
                   help="comma-separated coarse-to-fine level schedule "
                        "override, e.g. '2,1,0' (default: levels-2 .. 0)")
    p.add_argument("--gn-iters", type=int, default=10,
                   help="max LM/GN iterations per pyramid level")
    p.add_argument("--track-mode", choices=("fc", "ic"), default="fc",
                   help="photometric LM flavor: forward-compositional or "
                        "inverse-compositional (constant reference Jacobian; "
                        "samples one channel per iteration instead of three)")
    p.add_argument("--affine", action="store_true",
                   help="jointly estimate affine brightness (a, b) per frame "
                        "pair — for scenes violating brightness constancy "
                        "(underwater attenuation, exposure changes)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="disable the frames-in-flight live loop (one fused "
                        "device program per frame + async diagnostics "
                        "readback retired in batches a few frames late) and "
                        "process every "
                        "frame synchronously")
    p.add_argument("--offline", action="store_true",
                   help="throughput mode: batch the whole dataset through the "
                        "data-parallel tracker (vmapped over frame pairs) "
                        "instead of the live per-frame pipeline; odometry "
                        "only (no keyframes/BA/loop closure)")
    p.add_argument("--chunk", type=int, default=64,
                   help="frames per device batch in --offline mode")
    p.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                   help="force the jax platform (before backend init)")
    p.add_argument("--host-devices", type=int, default=None,
                   help="with --platform cpu: number of virtual host "
                        "devices (XLA_FLAGS --xla_force_host_platform_"
                        "device_count) — the multi-device simulation target "
                        "for --dist-ba without several GPUs")
    return p


def run_offline(args, system, config, seq) -> int:
    """Offline odometry: the dataset as chunks of one big device program.

    The data-parallel answer to the reference's strictly sequential frame loop
    (src/main_uw_slam.cpp:139-151): ingest is vmapped over frames and the
    coarse-to-fine LM runs vmapped over all adjacent pairs
    (tracking.track_sequence_batched). Chunks overlap by one frame so
    relative poses chain exactly across chunk boundaries.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..io import (
        FramePrefetcher,
        associate,
        ate_rmse,
        read_groundtruth_euroc,
        read_groundtruth_tum,
    )
    from ..tracking import compose_trajectory, track_sequence_batched

    tcfg = config.tracker

    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    if n < 2:
        print("offline mode needs >= 2 frames", file=sys.stderr)
        return 1

    def ingest_frame(img, depth):
        dev = system._ingest(img)
        ddev = None
        if depth is not None:
            d = jnp.asarray(depth, jnp.float32)
            x0, y0, w, h = system._roi
            ddev = jax.lax.dynamic_slice(d, (y0, x0), (h, w))
        return dev, ddev

    # Ingest PER CHUNK (only one chunk of frames is ever device-resident —
    # a full TUM sequence would not fit HBM — and decode overlaps tracking
    # through the prefetcher). The timed region covers decode + ingest +
    # tracking, same as the live path's frames/s.
    chunk = max(2, args.chunk)
    T_rel_all = []
    missing_depth = 0
    imgs, depths = [], []   # current chunk (carries 1-frame overlap)
    t0 = time.perf_counter()
    prefetcher = FramePrefetcher(seq)

    def track_chunk(imgs, depths):
        fr = jnp.stack(imgs)
        use_depth = all(d is not None for d in depths)
        dfr = jnp.stack(depths) if use_depth else None
        # Pad the stack to the full chunk length by repeating the last
        # frame: one static shape -> one XLA compile for every chunk (the
        # padded tail pairs produce identity poses, dropped below).
        pad = chunk - fr.shape[0]
        if pad > 0:
            fr = jnp.concatenate([fr, jnp.repeat(fr[-1:], pad, axis=0)])
            if dfr is not None:
                dfr = jnp.concatenate(
                    [dfr, jnp.repeat(dfr[-1:], pad, axis=0)]
                )
        T_rel, _, _ = track_sequence_batched(
            fr, system.cam, depth_frames=dfr,
            mono_z=tcfg.mono_depth, levels=tcfg.pyramid_levels,
            track_levels=tcfg.track_levels, num_points=tcfg.num_points,
            max_iters=tcfg.max_iterations, mode=tcfg.track_mode,
            affine=tcfg.affine_brightness,
        )
        return T_rel[: len(imgs) - 1]

    for i, (img, depth) in prefetcher:
        if i >= n:
            break
        if args.depth and depth is None:
            missing_depth += 1
        dev, ddev = ingest_frame(img, depth)
        imgs.append(dev)
        depths.append(ddev)
        if len(imgs) == chunk:
            T_rel_all.append(track_chunk(imgs, depths))
            # keep the last frame: one-frame overlap chains the chunks
            imgs, depths = imgs[-1:], depths[-1:]
    prefetcher.close()
    if len(imgs) >= 2:
        T_rel_all.append(track_chunk(imgs, depths))
    if missing_depth:
        print(
            f"WARNING: {missing_depth} frames lack depth; chunks containing "
            f"them fall back to mono_z={tcfg.mono_depth}",
            file=sys.stderr,
        )
    T_rel = jnp.concatenate(T_rel_all)
    n = T_rel.shape[0] + 1
    poses = np.asarray(compose_trajectory(T_rel))
    dt = time.perf_counter() - t0
    print(
        f"tracked {n} frames in {dt:.2f}s ({n / dt:.1f} fps, offline)",
        file=sys.stderr,
    )

    ts = (
        np.asarray(seq.timestamps[:n])  # readers already applied --start
        if seq.timestamps is not None
        else np.arange(n, dtype=np.float64)
    )
    if args.trajectory_out:
        from ..io import write_trajectory_tum

        write_trajectory_tum(args.trajectory_out, ts, poses)

    gt_rows = None
    if args.tum_gt:
        gt_rows = read_groundtruth_tum(args.tum_gt)
    elif args.euroc_gt:
        gt_rows = read_groundtruth_euroc(args.euroc_gt)
    if gt_rows is not None and len(gt_rows):
        ia, ib = associate(np.asarray(ts), gt_rows[:, 0], max_dt=0.05)
        if len(ia) >= 3:
            rmse = ate_rmse(poses[ia][:, :3, 3], gt_rows[ib][:, 1:4])
            print(f"ATE RMSE (Sim3-aligned): {rmse:.4f} m over {len(ia)} poses")
        else:
            print("WARNING: too few associated gt poses for ATE", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # Platform override must land before the first jax op initializes the
    # backend (XLA_FLAGS is read at backend init, not module import).
    if args.host_devices:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.host_devices}"
        ).strip()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    from .. import camera
    from ..config import (
        FeatureConfig,
        KeyframeConfig,
        SlamConfig,
        TrackerConfig,
    )
    from ..io import (
        FramePrefetcher,
        associate,
        ate_rmse,
        open_directory,
        open_euroc,
        open_tum,
        read_groundtruth_euroc,
        read_groundtruth_tum,
    )
    from ..system import SlamSystem

    from ..tracking.robust import WeightKind

    calib = camera.load(args.calibration)
    track_levels = (
        tuple(int(s) for s in args.track_levels.split(","))
        if args.track_levels
        else tuple(range(args.levels - 2, -1, -1))
    )
    config = SlamConfig(
        tracker=TrackerConfig(
            pyramid_levels=args.levels,
            track_levels=track_levels,
            max_iterations=args.gn_iters,
            weight_kind=WeightKind(args.weights),
            mono_depth=args.mono_depth,
            num_points=args.num_points,
            track_mode=args.track_mode,
            affine_brightness=args.affine,
            depth_bootstrap=args.depth_bootstrap,
            **(
                {"bootstrap_edge_ratio": args.bootstrap_edge_ratio}
                if args.bootstrap_edge_ratio is not None else {}
            ),
            **(
                {"bootstrap_block": args.bootstrap_block}
                if args.bootstrap_block is not None else {}
            ),
            **(
                {"bootstrap_shrink": args.bootstrap_shrink}
                if args.bootstrap_shrink is not None else {}
            ),
        ),
        features=FeatureConfig(per_level=args.kp_per_level),
        keyframes=KeyframeConfig(
            min_gap=args.kf_min_gap, max_gap=args.kf_max_gap
        ),
        use_features=args.features or args.depth_bootstrap or args.dist_ba,
        use_ba=args.ba or args.photo_ba,
        use_loop_closure=args.loop_closure,
        global_ba=args.dist_ba,
        profile=args.profile,
        trajectory_csv=args.trajectory_out,
    )
    from dataclasses import replace

    if args.photo_ba:
        config = replace(config, ba=replace(config.ba, photometric=True))
    if args.ba_prior_weight is not None:
        config = replace(
            config,
            ba=replace(config.ba, pose_prior_weight=args.ba_prior_weight),
        )
    if args.loop_se3:
        config = replace(config, loop=replace(config.loop, use_sim3=False))
    if args.reference_mode:
        # Reference active-pipeline semantics (src/System.cpp:193-223 +
        # src/Tracker.cpp:632-872): features -> <=200 matched keypoints ->
        # patch points, 10 GN iterations at pyramid level 0 ONLY, identity
        # robust weights (Tukey exists but is off, src/Tracker.cpp:769),
        # constant mono depth (z=1, src/Tracker.cpp:1228), no BA, no failure
        # detection (a diverged GN writes a bad pose, SURVEY.md §5).
        from ..tracking.robust import WeightKind

        config = replace(
            config,
            tracker=replace(
                config.tracker,
                track_levels=(0,),
                max_iterations=10,
                weight_kind=WeightKind.NONE,
                affine_brightness=False,
                depth_bootstrap=False,
            ),
            use_features=True,
            use_ba=False,
            use_loop_closure=False,
            use_reloc=False,
            global_ba=False,
        )
    system = SlamSystem(calib, config)
    if args.resume:
        start_at = system.resume_from(args.resume)
        print(f"resumed at frame {start_at}", file=sys.stderr)
        if args.start == 0:
            args.start = start_at  # continue at the next dataset index

    if args.euroc:
        seq = open_euroc(args.directory, start=args.start)
    elif args.depth:
        seq = open_tum(args.directory, args.depth, start=args.start)
    else:
        seq = open_directory(args.directory, start=args.start)

    if args.offline:
        if args.trace:
            from ..utils.profiling import trace

            with trace(args.trace):
                return run_offline(args, system, config, seq)
        return run_offline(args, system, config, seq)

    gt_rows_live = None
    viz = None
    if args.viz_port is not None:
        from ..viz import VizServer

        viz = VizServer(port=args.viz_port)
        print(f"live view: http://127.0.0.1:{viz.port}", file=sys.stderr)
        if args.tum_gt:
            gt_rows_live = read_groundtruth_tum(args.tum_gt)
        elif args.euroc_gt:
            gt_rows_live = read_groundtruth_euroc(args.euroc_gt)

    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    import contextlib

    t0 = time.perf_counter()
    stack = contextlib.ExitStack()
    if args.trace:
        from ..utils.profiling import trace

        stack.enter_context(trace(args.trace))
    # Steady-state timer: XLA compiles land in the first few frames (pyramid,
    # track, select, plus keyframe/BA shapes); frames after `warmup` measure
    # what the live loop actually sustains (VERDICT r2 missing #3).
    warmup = min(15, max(0, n - 10))
    t_warm = None
    # Pipelined by default: frames in flight with async diag readback
    # (results retired in batches ~5-9 frames late; see
    # SlamSystem.process_frame_async). --no-pipeline / --profile force the
    # synchronous path (per-stage timers need fenced stages). The pipelined
    # loop also uploads each frame to the device one frame ahead
    # (DeviceFramePrefetcher) so the H2D transfer overlaps the previous
    # frame's fused step.
    pipelined = not (args.no_pipeline or args.profile)
    step = system.process_frame_async if pipelined else system.process_frame
    if pipelined:
        from ..io import DeviceFramePrefetcher

        prefetcher = DeviceFramePrefetcher(seq)
    else:
        prefetcher = FramePrefetcher(seq)
    for i, (img, depth) in prefetcher:
        if i >= n:
            break
        if i == warmup:
            t_warm = time.perf_counter()
        state = step(
            img, depth,
            timestamp=seq.timestamps[i] if seq.timestamps is not None else None,
        )
        if i % 50 == 0 and state is not None:
            print(
                f"frame {i}: inliers={state.tracked_inliers} "
                f"err={state.track_error:.3f} kf={state.is_keyframe}",
                file=sys.stderr,
            )
        if viz is not None and i % 5 == 0 and i > 0:
            est = np.stack([s.T_wc[:3, 3] for s in system.trajectory])
            gt_pos = (
                gt_rows_live[: len(est), 1:4]
                if gt_rows_live is not None and len(gt_rows_live)
                else None
            )
            viz.update(est, gt_pos)
    if pipelined:
        system.flush()   # retire the last in-flight frame
    prefetcher.close()
    stack.close()  # flushes the profiler trace if one was started
    dt = time.perf_counter() - t0
    print(f"tracked {n} frames in {dt:.2f}s ({n / dt:.1f} fps)", file=sys.stderr)
    if t_warm is not None and n - warmup >= 5:
        dtw = time.perf_counter() - t_warm
        nw = n - warmup
        print(
            f"steady state: {nw} frames in {dtw:.2f}s "
            f"({nw / dtw:.1f} fps warm, first {warmup} frames excluded)",
            file=sys.stderr,
        )
    if system.ba_stats["runs"]:
        bs = system.ba_stats
        print(
            f"window BA: {bs['iters']} LM iters over {bs['runs']} runs in "
            f"{bs['time']:.2f}s ({bs['iters'] / max(bs['time'], 1e-9):.1f} "
            f"iters/s)",
            file=sys.stderr,
        )
    if args.loop_closure and system._loops is not None:
        print(
            f"loop closure: {len(system._loops.loop_edges)} edges accepted",
            file=sys.stderr,
        )
    if args.dist_ba:
        stats = system.run_global_distributed_ba()
        if stats is None:
            print("dist BA: map too small, skipped", file=sys.stderr)
        else:
            print(
                f"dist BA: {stats['keyframes']} kfs, "
                f"{stats['landmarks']} landmarks, "
                f"{stats['observations']} obs over {stats['devices']} "
                f"devices: {stats['iterations']} iters in "
                f"{stats['seconds']:.3f}s "
                f"({stats['ba_iters_per_sec']:.1f} iters/s), cost "
                f"{stats['initial_cost']:.3f} -> {stats['final_cost']:.3f}"
                + ("" if stats["applied"] else " (not applied)"),
                file=sys.stderr,
            )
    if args.profile:
        print(system.timers.report(), file=sys.stderr)
    if args.map_out:
        n_pts = system.export_map_ply(args.map_out)
        print(f"map: {n_pts} points -> {args.map_out}", file=sys.stderr)
    if args.checkpoint:
        system.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)

    ts, poses = system.export_trajectory(args.trajectory_out)

    gt_rows = None
    if args.tum_gt:
        gt_rows = read_groundtruth_tum(args.tum_gt)
    elif args.euroc_gt:
        gt_rows = read_groundtruth_euroc(args.euroc_gt)
    if gt_rows is not None and len(gt_rows):
        ia, ib = associate(np.asarray(ts), gt_rows[:, 0], max_dt=0.05)
        if len(ia) >= 3:
            est_pos = poses[ia][:, :3, 3]
            gt_pos = gt_rows[ib][:, 1:4]
            rmse = ate_rmse(est_pos, gt_pos)
            print(f"ATE RMSE (Sim3-aligned): {rmse:.4f} m over {len(ia)} poses")
        else:
            print("WARNING: too few associated gt poses for ATE", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
