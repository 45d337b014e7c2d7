"""Feature-based essential-matrix visual odometry.

Capability parity with the reference's standalone feature_detector binary
(/root/reference/src/feature_detector.cpp:16-309: GPU SURF/ORB + kNN ->
findEssentialMat (five-point RANSAC) -> recoverPose -> integrate translation ->
triangulatePoints), re-built as batched arrays: Harris detection + patch descriptors +
matmul matching + vmapped 8-point essential RANSAC + cheirality pose recovery,
one jitted program per frame pair.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.model import PinholeCamera
from ..features import (
    describe,
    detect_multiscale,
    essential_ransac,
    match_descriptors,
    recover_pose,
)
from ..image.pyramid import build_pyramid
from ..lie import se3


@dataclass
class FeatureVOState:
    T_wc: np.ndarray          # integrated pose (world <- camera)
    num_matches: int
    num_inliers: int
    points: np.ndarray | None  # triangulated points (camera-a frame)


@dataclass
class FeatureVO:
    """Frame-to-frame essential-matrix odometry with unit-scale translation
    (monocular scale is fixed by `translation_scale`, like the reference's
    raw integration at src/feature_detector.cpp:272-273)."""

    cam: PinholeCamera
    per_level: int = 256
    detect_levels: int = 2
    ratio: float = 0.65
    translation_scale: float = 1.0
    _prev: tuple | None = None
    _T_wc: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    _frame_id: int = 0
    trajectory: list = field(default_factory=list)

    def _extract(self, image):
        pyr = build_pyramid(jnp.asarray(image, jnp.float32), levels=3)
        kps = detect_multiscale(
            pyr.grad_x, pyr.grad_y,
            per_level=self.per_level, levels=self.detect_levels,
        )
        desc = describe(pyr.images, kps.uv, kps.level, kps.valid)
        return kps, desc

    def process_frame(self, image: np.ndarray) -> FeatureVOState:
        cur = self._extract(image)
        state = FeatureVOState(
            T_wc=self._T_wc.copy(), num_matches=0, num_inliers=0, points=None
        )
        if self._prev is not None:
            (kp_a, da), (kp_b, db) = self._prev, cur
            m = match_descriptors(da, db, kp_a.valid, kp_b.valid, self.ratio)
            f = jnp.asarray([self.cam.fx, self.cam.fy])
            c = jnp.asarray([self.cam.cx, self.cam.cy])
            xa = (kp_a.uv[m.idx_a] - c) / f
            xb = (kp_b.uv[m.idx_b] - c) / f
            # 1 px threshold: keypoints are subpixel-refined, and the tight
            # truncation makes MSAC separate the planar-ambiguity basins.
            res = essential_ransac(
                xa, xb, m.valid, jax.random.PRNGKey(self._frame_id),
                threshold_norm=1.0 / float(self.cam.fx),
            )
            state.num_matches = int(m.valid.sum())
            state.num_inliers = int(res.num_inliers)
            if bool(res.ok):
                rec = recover_pose(res.F, xa, xb, res.inliers)
                T_rel = np.array(rec.T)  # b <- a, |t| = 1 (writable copy)
                T_rel[:3, 3] *= self.translation_scale
                # Integrate: T_wc_b = T_wc_a * inv(T_rel).
                self._T_wc = np.asarray(
                    se3.normalize(
                        jnp.asarray(self._T_wc)
                        @ se3.inverse(jnp.asarray(T_rel))
                    )
                )
                state.T_wc = self._T_wc.copy()
                state.points = np.asarray(rec.points)
        self._prev = cur
        self._frame_id += 1
        self.trajectory.append(state)
        return state
