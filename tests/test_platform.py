"""uwslam_tpu.platform: one module picks each op's form by the platform the
computation is lowered for, and the compile-cache location."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import uwslam_tpu
from uwslam_tpu import platform


@pytest.fixture
def toy_op():
    """A fake op whose CPU and GPU forms differ: +1 on the CPU, +2 on the
    GPU."""

    def f(x):
        return platform.choose(lambda x: x + 1.0, lambda x: x + 2.0, x)

    return f


def test_cpu_lowering_takes_cpu_form(toy_op):
    assert float(jax.jit(toy_op)(jnp.float32(1.0))) == 2.0


def test_gpu_lowering_takes_gpu_form(toy_op):
    text = (
        jax.jit(toy_op).trace(jnp.float32(1.0))
        .lower(lowering_platforms=("cuda",)).as_text()
    )
    assert "2.000000e+00" in text and "1.000000e+00" not in text


def test_explicit_cpu_placement_ignores_default_backend(toy_op, monkeypatch):
    """The misfire a default-backend check had: data committed to the CPU
    on a machine whose default backend is the GPU must run the CPU form."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    x = jax.device_put(jnp.float32(1.0), jax.devices("cpu")[0])
    assert float(jax.jit(toy_op)(x)) == 2.0


def _lowered(fn, *args):
    traced = jax.jit(fn).trace(*args)
    return (traced.lower(lowering_platforms=("cpu",)).as_text(),
            traced.lower(lowering_platforms=("cuda",)).as_text())


def test_batched_pyramid_takes_the_triton_kernel_on_the_gpu_only():
    from uwslam_tpu.image.pyramid import build_pyramid_batched

    cpu, cuda = _lowered(lambda x: build_pyramid_batched(x, levels=2),
                         jnp.zeros((2, 16, 32), jnp.float32))
    assert "scharr_gradients" in cuda and "triton" in cuda
    assert "scharr_gradients" not in cpu and "triton" not in cpu


@pytest.mark.parametrize("fn_name", ["eigh", "svd", "smallest_eigvec_spd"])
def test_decompositions_call_the_solver_library(fn_name):
    """The feature path's small decompositions lower to LAPACK for the CPU
    and to cuSOLVER for CUDA (no GPU needed to lower)."""
    from uwslam_tpu.utils.linalg import smallest_eigvec_spd

    fn = {"eigh": jnp.linalg.eigh, "svd": jnp.linalg.svd,
          "smallest_eigvec_spd": smallest_eigvec_spd}[fn_name]
    n = 9 if fn_name == "smallest_eigvec_spd" else 3
    cpu, cuda = _lowered(fn, jnp.eye(n)[None].repeat(4, 0))
    assert "lapack" in cpu
    assert "cusolver" in cuda


def test_smallest_eigvec_on_degenerate_spectra():
    """Null vectors of rank-deficient and clustered 9x9 PSD matrices (the
    DLT shapes) against numpy float64."""
    from uwslam_tpu.utils.linalg import smallest_eigvec_spd

    rng = np.random.default_rng(0)
    Q = np.linalg.qr(rng.normal(size=(3, 9, 9)))[0]
    lam = np.array([[0.0, 1, 2, 3, 4, 5, 6, 7, 8],
                    [1e-6, 2e-6, 1, 1, 1, 2, 2, 3, 3],
                    [1.0, 1.2, 1.3, 1.4, 1.5, 1.6, 1.7, 1.8, 1.9]])
    A = np.einsum("bij,bj,bkj->bik", Q, lam, Q)
    v = np.asarray(smallest_eigvec_spd(jnp.asarray(A, jnp.float32)),
                   np.float64)
    rq = np.einsum("bi,bij,bj->b", v, A, v) / np.einsum("bi,bi->b", v, v)
    np.testing.assert_allclose(rq, lam[:, 0], atol=1e-5 * lam.max())


class TestCompileCache:
    def test_env_var_is_left_to_jax(self, monkeypatch):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        try:
            uwslam_tpu._setup_compile_cache()
            assert jax.config.jax_compilation_cache_dir == "sentinel"
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_is_fixed_path_in_checkout(self, monkeypatch):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            uwslam_tpu._setup_compile_cache()
            path = jax.config.jax_compilation_cache_dir
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache") == uwslam_tpu.CACHE_DIR


@pytest.mark.gpu
def test_gpu_runs_its_forms_and_matches_cpu(gpu):
    """On the card: sampling and decompositions in the GPU's forms agree with
    the same calls committed to the CPU."""
    from uwslam_tpu.image.pyramid import sample_stack

    svd3 = jnp.linalg.svd

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (3, 48, 64)).astype(np.float32)
    uv = rng.uniform(0, 62, (256, 2)).astype(np.float32)
    F = rng.normal(size=(64, 3, 3)).astype(np.float32)
    cpu = jax.devices("cpu")[0]
    for fn, args in ((sample_stack, (img, uv)), (svd3, (F,))):
        g = jax.jit(fn)(*(jax.device_put(a, gpu) for a in args))
        c = jax.jit(fn)(*(jax.device_put(a, cpu) for a in args))
        if fn is svd3:   # singular values: the sign conventions may differ
            g, c = g[1], c[1]
        else:
            g, c = g[0], c[0]
        np.testing.assert_allclose(np.asarray(g), np.asarray(c), atol=2e-3)
