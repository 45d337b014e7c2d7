"""The Pallas Triton Scharr kernel (ops/scharr.py) in interpret mode against
XLA's form, its tiling, and which form each platform lowers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uwslam_tpu.image.pyramid import _scharr_batched, build_pyramid_batched
from uwslam_tpu.ops.scharr import _tile, scharr_gradients_batched


@pytest.mark.parametrize(
    "shape", [(2, 48, 64), (1, 30, 40), (3, 15, 20), (1, 7, 9)]
)
def test_interpret_matches_xla(shape):
    x = jax.random.uniform(jax.random.PRNGKey(sum(shape)), shape) * 255.0
    got = scharr_gradients_batched(x, interpret=True)
    want = _scharr_batched(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4)


def test_tiles_divide_each_pyramid_level():
    for n, cap, t in [(480, 16, 16), (60, 16, 4), (30, 16, 2), (15, 16, 1),
                      (640, 64, 64), (40, 64, 8), (20, 64, 4)]:
        assert _tile(n, cap) == t


def test_batched_pyramid_lowers_the_kernel_only_for_cuda():
    traced = jax.jit(lambda v: build_pyramid_batched(v, levels=3)).trace(
        jnp.zeros((2, 32, 48))
    )
    assert "triton" not in traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in traced.lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    x = jax.device_put(
        jax.random.uniform(jax.random.PRNGKey(0), (4, 480, 640)) * 255.0, gpu
    )
    got = jax.jit(scharr_gradients_batched)(x)
    want = jax.jit(_scharr_batched)(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-3)
