"""Camera model, calibration parsing, pyramid, and sampling tests."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from uwslam_tpu.camera import (
    PinholeCamera,
    load_opencv_xml,
    optimal_new_camera,
    remap_bilinear,
    undistort_map,
)
from uwslam_tpu.image import (
    bilinear_sample,
    build_depth_pyramid,
    build_pyramid,
    downsample2x,
    scharr_gradients,
)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def reference_xml(directory, name: str) -> str:
    """Write configs/calibration_<name>.json as the reference's OpenCV
    FileStorage XML (calibrationTUM.xml / calibrationEUROC.xml schema) and
    return its path. No distortion is written as the reference's
    [0 0 0 1] sentinel."""
    with open(os.path.join(CONFIGS, f"calibration_{name}.json")) as f:
        d = json.load(f)
    dist = [d.get(k, 0.0) for k in ("k1", "k2", "p1", "p2")]
    if not any(dist):
        dist = [0, 0, 0, 1]

    def matrix(tag, vals):
        return (
            f'<{tag} type_id="opencv-matrix">\n  <rows>1</rows>\n'
            f"  <cols>4</cols>\n  <dt>d</dt>\n"
            f"  <data>\n    {' '.join(repr(float(v)) for v in vals)}</data></{tag}>"
        )

    xml = "\n".join([
        '<?xml version="1.0"?>',
        "<opencv_storage>",
        f"<in_width>{d['width']}</in_width>",
        f"<in_height>{d['height']}</in_height>",
        f"<out_width>{d.get('out_width', d['width'])}</out_width>",
        f"<out_height>{d.get('out_height', d['height'])}</out_height>",
        matrix("calibration_values", [d["fx"], d["fy"], d["cx"], d["cy"]]),
        matrix("rectification", dist),
        "</opencv_storage>",
    ])
    path = os.path.join(str(directory), f"calibration{name.upper()}.xml")
    with open(path, "w") as f:
        f.write(xml + "\n")
    return path


def tum_cam():
    return PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


class TestCameraModel:
    def test_project_unproject_roundtrip(self):
        cam = tum_cam()
        uv = jnp.array([[100.0, 200.0], [319.5, 239.5], [600.0, 50.0]])
        depth = jnp.array([1.0, 2.5, 0.7])
        p = cam.unproject(uv, depth)
        uv2 = cam.project(p)
        np.testing.assert_allclose(uv, uv2, atol=1e-4)
        np.testing.assert_allclose(p[..., 2], depth, atol=1e-6)

    def test_project_jacobian_finite_diff(self):
        cam = tum_cam()
        p = jnp.array([0.3, -0.2, 2.0])
        J = cam.project_jacobian(p)
        eps = 1e-3
        for k in range(3):
            dp = jnp.zeros(3).at[k].set(eps)
            fd = (cam.project(p + dp) - cam.project(p - dp)) / (2 * eps)
            np.testing.assert_allclose(J[:, k], fd, rtol=1e-3, atol=1e-2)

    def test_distort_undistort_roundtrip(self):
        cam = PinholeCamera(
            fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480,
            k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
        )
        xy = jnp.array([[0.1, 0.2], [-0.3, 0.15], [0.0, 0.0], [0.4, -0.4]])
        xy_d = cam.distort_normalized(xy)
        xy_u = cam.undistort_normalized(xy_d)
        np.testing.assert_allclose(xy, xy_u, atol=1e-5)

    def test_scaled_intrinsics_schedule(self):
        # Matches the reference rule (src/Tracker.cpp:313-326).
        cam = tum_cam()
        c1 = cam.scaled(1)
        assert c1.fx == pytest.approx(262.5)
        assert c1.cx == pytest.approx((319.5 + 0.5) / 2 - 0.5)
        assert c1.width == 320 and c1.height == 240
        c0 = cam.scaled(0)
        assert c0.fx == cam.fx and c0.cx == cam.cx


class TestCalibrationXML:
    def test_tum_xml(self, tmp_path):
        cal = load_opencv_xml(reference_xml(tmp_path, "tum"))
        assert cal.raw.fx == 525 and cal.raw.fy == 525
        assert cal.raw.cx == 319.5 and cal.raw.cy == 239.5
        assert cal.raw.width == 640 and cal.out_width == 640
        assert not cal.needs_rectification  # rectification = [0 0 0 1]

    def test_euroc_xml(self, tmp_path):
        cal = load_opencv_xml(reference_xml(tmp_path, "euroc"))
        assert cal.raw.fx == pytest.approx(458.654)
        assert cal.raw.width == 752 and cal.out_width == 736
        assert cal.needs_rectification
        assert cal.raw.k1 == pytest.approx(-0.28340811)


class TestRectification:
    def test_undistort_map_identity_when_no_distortion(self):
        cam = tum_cam()
        m = undistort_map(cam, cam)
        v, u = np.meshgrid(np.arange(480), np.arange(640), indexing="ij")
        np.testing.assert_allclose(m[..., 0], u, atol=1e-3)
        np.testing.assert_allclose(m[..., 1], v, atol=1e-3)

    def test_remap_identity(self):
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.uniform(0, 255, (48, 64)).astype(np.float32))
        cam = PinholeCamera(fx=50, fy=50, cx=31.5, cy=23.5, width=64, height=48)
        m = undistort_map(cam, cam)
        out = remap_bilinear(img, m)
        np.testing.assert_allclose(out, img, atol=1e-2)

    def test_optimal_new_camera_euroc(self, tmp_path):
        cal = load_opencv_xml(reference_xml(tmp_path, "euroc"))
        rect = optimal_new_camera(cal.raw, cal.out_width, cal.out_height)
        assert rect.width == 736
        # Rectified principal point lands inside the image.
        assert 0 < rect.cx < 736 and 0 < rect.cy < 480
        # The map must reference source pixels inside the raw image for the
        # central region.
        m = np.asarray(undistort_map(cal.raw, rect))
        c = m[240, 368]
        assert 0 <= c[0] < 752 and 0 <= c[1] < 480


class TestPyramid:
    def test_downsample_mean(self):
        img = jnp.arange(16, dtype=jnp.float32).reshape(4, 4)
        d = downsample2x(img)
        np.testing.assert_allclose(d[0, 0], (0 + 1 + 4 + 5) / 4)

    def test_pyramid_shapes(self):
        img = jnp.zeros((480, 640), jnp.float32)
        pyr = build_pyramid(img, levels=5)
        assert [im.shape for im in pyr.images] == [
            (480, 640), (240, 320), (120, 160), (60, 80), (30, 40)
        ]
        assert len(pyr.grad_x) == 5 and len(pyr.grad_mag) == 5

    def test_scharr_on_ramp(self):
        # A linear x-ramp has constant gradient = slope in x, 0 in y.
        x = jnp.tile(jnp.arange(32, dtype=jnp.float32) * 3.0, (16, 1))
        gx, gy = scharr_gradients(x)
        np.testing.assert_allclose(gx[4:-4, 4:-4], 3.0, atol=1e-4)
        np.testing.assert_allclose(gy[4:-4, 4:-4], 0.0, atol=1e-4)

    def test_depth_pyramid_ignores_invalid(self):
        d = jnp.array([[2.0, 0.0], [2.0, 2.0]], jnp.float32)
        dp = build_depth_pyramid(d, levels=2)
        np.testing.assert_allclose(dp[1][0, 0], 2.0)  # not diluted by the zero

    def test_bilinear_sample(self):
        img = jnp.array([[0.0, 10.0], [20.0, 30.0]], jnp.float32)
        val, ok = bilinear_sample(img, jnp.array([[0.5, 0.5]]))
        np.testing.assert_allclose(val, [15.0])
        assert bool(ok[0])
        val2, ok2 = bilinear_sample(img, jnp.array([[-1.0, 0.0]]))
        assert not bool(ok2[0]) and val2[0] == 0.0


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])
