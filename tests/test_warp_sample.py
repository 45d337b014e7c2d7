"""uwslam_tpu/ops/warp_sample.py (interpreted on the CPU) against the
tracking code's XLA form, the choice of form by platform, and the A/B
driver's form switch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import bringup_ab
from uwslam_tpu import platform
from uwslam_tpu.camera import PinholeCamera
from uwslam_tpu.lie import se3
from uwslam_tpu.ops.warp_sample import warp_sample
from uwslam_tpu.tracking import photometric

CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160,
                    height=120)


def _case(channels: int, n: int = 300):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(channels), 3)
    img = jax.random.uniform(k1, (channels, 120, 160), maxval=255.0)
    uv = jnp.stack([jax.random.uniform(k2, (n,), minval=-5, maxval=165),
                    jax.random.uniform(k3, (n,), minval=-5, maxval=125)], 1)
    z = jnp.linspace(0.5, 4.0, n).at[::37].set(-0.3)   # some behind
    T = se3.exp(jnp.asarray([0.05, -0.02, 0.03, 0.02, -0.01, 0.015]))
    return img, CAM.unproject(uv, z), T


@pytest.mark.parametrize("channels", [1, 3])
def test_warp_sample_kernel_matches_xla_form(channels):
    img, p3d, T = _case(channels)
    ref, ok_ref = photometric._warp_sample_xla(img, p3d, T, CAM)
    out, ok = warp_sample(img, p3d, T, CAM, interpret=True)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))
    assert 0 < int(ok.sum()) < ok.size      # both valid and invalid lanes
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=5e-3)


def test_warp_sample_kernel_under_vmap():
    img, p3d, T = _case(3, n=200)
    imgs = jnp.stack([img, img + 1.0])
    out, ok = jax.vmap(
        lambda im: warp_sample(im, p3d, T, CAM, interpret=True)
    )(imgs)
    ref, ok_ref = photometric._warp_sample_xla(img, p3d, T, CAM)
    assert out.shape == (2,) + ref.shape
    np.testing.assert_allclose(np.asarray(out[1]),
                               np.asarray(ref + jnp.where(ok_ref, 1.0, 0.0)),
                               atol=5e-3)


@pytest.mark.parametrize("channels", [1, 3])
def test_gpu_takes_the_kernel_for_one_channel_only(channels):
    img, p3d, T = _case(channels)
    traced = jax.jit(
        lambda im, p, T: photometric._warp_sample(im, p, T, CAM)
    ).trace(img, p3d, T)
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "warp_sample" not in cpu
    assert ("warp_sample" in cuda) == (channels == 1)
    out, ok = jax.jit(photometric._warp_sample, static_argnums=3)(
        img, p3d, T, CAM)
    ref, ok_ref = photometric._warp_sample_xla(img, p3d, T, CAM)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))


def test_form_switch_restores_the_tracking_code():
    saved = (photometric._warp_sample, photometric.sample_stack,
             platform.choose)
    with bringup_ab.form("onehot", "xla"):
        assert photometric.sample_stack is not saved[1]
        assert platform.choose is not saved[2]
    with bringup_ab.form("triton", "triton"):
        assert photometric._warp_sample is not saved[0]
    assert (photometric._warp_sample, photometric.sample_stack,
            platform.choose) == saved
