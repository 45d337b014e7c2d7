"""Keyframe store and map points — real versions of the reference's stubs.

The reference declares keyframe machinery that never runs
(/root/reference/src/System.cpp:264-278 AddKeyFrame is never called;
include/System.h:99-102 isKeyFrame_; src/Map.cpp:33-45 stores a cloud it never
uses). This module makes them functional (SURVEY.md §7 layer 6):

- Keyframe: device-resident pyramid + tracked points + pose + features.
- KeyframeStore: host-side ring buffer of the sliding window (the reference
  keeps a 10-frame retention window, src/main_uw_slam.cpp:146-148) with a
  real selection policy (motion- and inlier-ratio-based), feeding windowed BA.
- MapPoints: fixed-capacity landmark table for the BA problem.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..image.pyramid import FramePyramid
from ..lie import se3
from ..tracking.points import TrackPoints


class Keyframe(NamedTuple):
    frame_id: int
    timestamp: float
    T_wc: jax.Array                 # (4, 4) world <- camera
    pyramid: FramePyramid
    points: TrackPoints             # tracked point selection (level 0)
    kp_uv: jax.Array | None = None  # (K, 2) feature keypoints (level-0 coords)
    kp_desc: jax.Array | None = None
    kp_valid: jax.Array | None = None
    kp_p3d: jax.Array | None = None  # (K, 3) keypoints unprojected into the
                                     # keyframe CAMERA frame (for PnP reloc)


@dataclass
class KeyframeDecision:
    """Thresholds for promoting a frame to keyframe."""

    min_inlier_ratio: float = 0.55   # below this, the view changed too much
    max_translation: float = 0.12    # meters (scaled units for mono)
    max_rotation: float = 0.10       # radians
    min_gap: int = 3                 # frames
    max_gap: int = 30


@dataclass
class KeyframeStore:
    """Sliding window of keyframes (host-coordinated, device-resident data)."""

    capacity: int = 10  # reference retains 10 frames (src/main_uw_slam.cpp:146)
    decision: KeyframeDecision = field(default_factory=KeyframeDecision)
    keyframes: list[Keyframe] = field(default_factory=list)
    _last_kf_frame_id: int = -10**9

    def __len__(self):
        return len(self.keyframes)

    @property
    def latest(self) -> Keyframe | None:
        return self.keyframes[-1] if self.keyframes else None

    def should_insert(
        self,
        frame_id: int,
        T_wc: jax.Array,
        inlier_ratio: float,
        rel_log: np.ndarray | None = None,
    ) -> bool:
        """rel_log: host copy of log(latest.T_wc^-1 @ T_wc), if the caller
        already transferred it (SlamSystem folds it into the single per-frame
        diagnostics pull — computing it here costs one extra device->host
        round trip per frame)."""
        if not self.keyframes:
            return True
        gap = frame_id - self._last_kf_frame_id
        if gap < self.decision.min_gap:
            return False
        if gap >= self.decision.max_gap:
            return True
        if inlier_ratio < self.decision.min_inlier_ratio:
            return True
        if rel_log is None:
            rel_log = np.asarray(
                se3.log(se3.compose(se3.inverse(self.latest.T_wc), T_wc))
            )
        t = float(np.linalg.norm(rel_log[:3]))
        r = float(np.linalg.norm(rel_log[3:]))
        return t > self.decision.max_translation or r > self.decision.max_rotation

    def insert(self, kf: Keyframe) -> Keyframe | None:
        """Insert; returns the evicted (marginalized) keyframe, if any."""
        self.keyframes.append(kf)
        self._last_kf_frame_id = kf.frame_id
        if len(self.keyframes) > self.capacity:
            return self.keyframes.pop(0)
        return None

    def window_poses(self) -> jax.Array:
        return jnp.stack([kf.T_wc for kf in self.keyframes])


@dataclass
class MapPoints:
    """Fixed-capacity landmark table (host-managed allocation, device data).

    Replaces the reference Map's unused point-cloud stub (src/Map.cpp:33-45)
    with an actual BA-ready structure."""

    capacity: int = 4096
    positions: np.ndarray = None    # (capacity, 3) world
    valid: np.ndarray = None
    _next: int = 0

    def __post_init__(self):
        if self.positions is None:
            self.positions = np.zeros((self.capacity, 3), np.float32)
        if self.valid is None:
            self.valid = np.zeros((self.capacity,), bool)

    def allocate(self, pts_world: np.ndarray) -> np.ndarray:
        """Add new landmarks; returns their indices (wraps around when full,
        recycling the oldest slots)."""
        n = len(pts_world)
        idx = (self._next + np.arange(n)) % self.capacity
        self.positions[idx] = pts_world
        self.valid[idx] = True
        self._next = int((self._next + n) % self.capacity)
        return idx

    def prune(self, idx: np.ndarray):
        self.valid[idx] = False
