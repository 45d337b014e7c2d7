"""Pinhole camera model with radial-tangential distortion, pure JAX.

Capability parity with the reference CameraModel
(/root/reference/src/CameraModel.cpp:30-108): loads OpenCV-FileStorage XML
calibration, rescales normalized intrinsics, computes undistortion maps and a
valid-pixel ROI — but the rectify map is computed once on device as
a dense (H, W, 2) coordinate grid, applied by bilinear gather inside jit, with
no OpenCV dependency.

Distortion model: OpenCV radtan [k1, k2, p1, p2] as used by the EUROC
calibration (/root/reference/calibration/calibrationEUROC.xml:22-28).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class PinholeCamera:
    """Static pinhole intrinsics. fx/fy/cx/cy are python floats so cameras can
    be closed over by jitted functions without retracing on pose updates."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    # radtan distortion of the RAW image; (0,0,0,0) (or last=1, the reference's
    # "no rectification" sentinel at src/CameraModel.cpp:70-76) means none.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def tree_flatten(self):
        return (), (
            self.fx, self.fy, self.cx, self.cy, self.width, self.height,
            self.k1, self.k2, self.p1, self.p2,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(*aux)

    @property
    def has_distortion(self) -> bool:
        # The reference treats rectification == [0,0,0,1] or [0,0,0,0] as
        # "no distortion" (src/CameraModel.cpp:70-76).
        return any(abs(k) > 1e-12 for k in (self.k1, self.k2)) or any(
            abs(p) > 1e-12 for p in (self.p1, self.p2)
        )

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]],
            dtype=np.float32,
        )

    def scaled(self, level: int) -> "PinholeCamera":
        """Per-pyramid-level intrinsics following the reference's schedule
        (src/Tracker.cpp:313-326): fx,fy halve per level; cx uses the
        half-pixel-centered rule c_l = (c_0 + 0.5) / 2^l - 0.5."""
        f = 1 << level
        return PinholeCamera(
            fx=self.fx / f,
            fy=self.fy / f,
            cx=(self.cx + 0.5) / f - 0.5,
            cy=(self.cy + 0.5) / f - 0.5,
            width=self.width >> level,
            height=self.height >> level,
            k1=self.k1, k2=self.k2, p1=self.p1, p2=self.p2,
        )

    # ---- geometry (all jittable, batched over leading dims) ----

    def project(self, pts: jax.Array) -> jax.Array:
        """Camera-frame 3D points (..., 3) -> pixel coords (..., 2) [u, v]."""
        z = pts[..., 2]
        safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = self.fx * pts[..., 0] / safe_z + self.cx
        v = self.fy * pts[..., 1] / safe_z + self.cy
        return jnp.stack([u, v], axis=-1)

    def unproject(self, uv: jax.Array, depth: jax.Array) -> jax.Array:
        """Pixels (..., 2) + depth (...,) -> camera-frame 3D points (..., 3).

        Mirrors the reference's unprojection (src/Tracker.cpp:1439-1444)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return jnp.stack([x, y, depth], axis=-1)

    def distort_normalized(self, xy: jax.Array) -> jax.Array:
        """Apply radtan distortion to normalized coords (..., 2)."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * self.k2)
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return jnp.stack([xd, yd], axis=-1)

    def undistort_normalized(self, xy_d: jax.Array, iters: int = 8) -> jax.Array:
        """Invert radtan by fixed-point iteration (static trip count for XLA)."""
        xy = xy_d

        def body(_, xy):
            x, y = xy[..., 0], xy[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + r2 * self.k2)
            dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            return jnp.stack(
                [(xy_d[..., 0] - dx) / radial, (xy_d[..., 1] - dy) / radial],
                axis=-1,
            )

        return jax.lax.fori_loop(0, iters, body, xy)

    def project_jacobian(self, pts: jax.Array) -> jax.Array:
        """d(u,v)/d(x,y,z): (..., 3) -> (..., 2, 3) pinhole projection Jacobian.

        The 2x3 left factor of the reference's per-point 2x6 Jw
        (src/Tracker.cpp:455-467)."""
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        zi = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        zi2 = zi * zi
        zero = jnp.zeros_like(x)
        row_u = jnp.stack([self.fx * zi, zero, -self.fx * x * zi2], axis=-1)
        row_v = jnp.stack([zero, self.fy * zi, -self.fy * y * zi2], axis=-1)
        return jnp.stack([row_u, row_v], axis=-2)


def optimal_new_camera(
    cam: PinholeCamera, out_width: int, out_height: int, alpha: float = 0.0
) -> PinholeCamera:
    """Compute rectified intrinsics covering the undistorted image, in the
    spirit of cv::getOptimalNewCameraMatrix (reference src/CameraModel.cpp:89).

    alpha=0: all output pixels valid (crop to inner rectangle);
    alpha=1: keep all source pixels (outer rectangle).
    """
    # Sample the border of the raw image, undistort, and fit inner/outer boxes.
    n = 64
    xs = np.linspace(0, cam.width - 1, n, dtype=np.float32)
    ys = np.linspace(0, cam.height - 1, n, dtype=np.float32)
    border = np.concatenate(
        [
            np.stack([xs, np.zeros(n, np.float32)], -1),
            np.stack([xs, np.full(n, cam.height - 1, np.float32)], -1),
            np.stack([np.zeros(n, np.float32), ys], -1),
            np.stack([np.full(n, cam.width - 1, np.float32), ys], -1),
        ]
    )
    xy_d = (border - np.array([cam.cx, cam.cy])) / np.array([cam.fx, cam.fy])
    xy_u = np.asarray(cam.undistort_normalized(jnp.asarray(xy_d)))

    # Outer box: bounding box of all undistorted border points.
    outer_min, outer_max = xy_u.min(0), xy_u.max(0)
    # Inner box: the largest axis-aligned box inside the undistorted border —
    # approximated (as OpenCV does) from per-edge extrema.
    top = xy_u[:n]; bottom = xy_u[n:2 * n]; left = xy_u[2 * n:3 * n]; right = xy_u[3 * n:]
    inner_min = np.array([left[:, 0].max(), top[:, 1].max()])
    inner_max = np.array([right[:, 0].min(), bottom[:, 1].min()])

    lo = alpha * outer_min + (1 - alpha) * inner_min
    hi = alpha * outer_max + (1 - alpha) * inner_max
    span = np.maximum(hi - lo, 1e-6)
    fx = (out_width - 1) / span[0]
    fy = (out_height - 1) / span[1]
    cx = -lo[0] * fx
    cy = -lo[1] * fy
    return PinholeCamera(
        fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
        width=out_width, height=out_height,
    )


def undistort_map(
    raw: PinholeCamera, rect: PinholeCamera
) -> jax.Array:
    """Dense rectification map (H_out, W_out, 2) of RAW-image pixel coords to
    sample for each rectified output pixel (cv::initUndistortRectifyMap
    equivalent, reference src/CameraModel.cpp:90). Computed once, on device."""
    v, u = jnp.meshgrid(
        jnp.arange(rect.height, dtype=jnp.float32),
        jnp.arange(rect.width, dtype=jnp.float32),
        indexing="ij",
    )
    x = (u - rect.cx) / rect.fx
    y = (v - rect.cy) / rect.fy
    xy_d = raw.distort_normalized(jnp.stack([x, y], axis=-1))
    src_u = xy_d[..., 0] * raw.fx + raw.cx
    src_v = xy_d[..., 1] * raw.fy + raw.cy
    return jnp.stack([src_u, src_v], axis=-1)


@partial(jax.jit, static_argnames=("fill",))
def remap_bilinear(image: jax.Array, src_coords: jax.Array, fill: float = 0.0):
    """Bilinear remap: image (H, W), src_coords (..., 2) [u, v] -> (...,).

    Out-of-bounds samples return `fill` (cv::remap BORDER_CONSTANT)."""
    H, W = image.shape
    u = src_coords[..., 0]
    v = src_coords[..., 1]
    u0 = jnp.floor(u); v0 = jnp.floor(v)
    du = u - u0; dv = v - v0
    u0i = u0.astype(jnp.int32); v0i = v0.astype(jnp.int32)

    def gather(vi, ui):
        vi_c = jnp.clip(vi, 0, H - 1)
        ui_c = jnp.clip(ui, 0, W - 1)
        return image[vi_c, ui_c]

    i00 = gather(v0i, u0i)
    i01 = gather(v0i, u0i + 1)
    i10 = gather(v0i + 1, u0i)
    i11 = gather(v0i + 1, u0i + 1)
    out = (
        i00 * (1 - du) * (1 - dv)
        + i01 * du * (1 - dv)
        + i10 * (1 - du) * dv
        + i11 * du * dv
    )
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return jnp.where(valid, out, fill)


def compute_roi(valid_mask: np.ndarray, margin: int = 5) -> tuple[int, int, int, int]:
    """Largest row/col band of fully-valid pixels with a +-margin, mirroring the
    reference's black-border scan (src/System.cpp:148-191).

    Returns (x0, y0, w, h)."""
    rows = valid_mask.all(axis=1)
    cols = valid_mask.all(axis=0)

    def band(flags):
        idx = np.flatnonzero(flags)
        if len(idx) == 0:
            return 0, len(flags)
        return int(idx[0]), int(idx[-1] - idx[0] + 1)

    y0, h = band(rows)
    x0, w = band(cols)
    x0 += margin; y0 += margin
    w = max(w - 2 * margin, 0); h = max(h - 2 * margin, 0)
    # Even dimensions so 5-level pyramids divide cleanly (the reference insists
    # on even input dims at src/System.cpp:81-89; we go further and round to a
    # multiple of 16 = 2^(levels-1)).
    w -= w % 16
    h -= h % 16
    return x0, y0, w, h
