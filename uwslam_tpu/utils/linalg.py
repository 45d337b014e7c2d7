"""Small-matrix linear algebra for the per-frame feature path.

- cholesky_solve_unrolled: statically-unrolled SPD solve (any small n),
  pure elementwise math that stays inside the surrounding XLA fusion
- smallest_eigvec_spd: null vector of a small symmetric PSD matrix

The decompositions (eigh, SVD) are jnp.linalg's on every platform: LAPACK
on the CPU, cuSOLVER on the GPU. On an H100 the feature path's first run
took 61 s with cuSOLVER against 272 s with the unrolled Jacobi / inverse-
iteration forms this module used to hold (compilation), for 2.4 ms/frame
warm, and those forms were inexact on clustered spectra (PERF.md).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_solve_unrolled(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve the small SPD system A x = b via a statically-unrolled
    Cholesky (n = A.shape[-1]); broadcasts over leading batch dims.

    Unlike jnp.linalg.solve (an LU library call), this unrolled form is
    pure elementwise math that XLA folds into the surrounding fusion. A
    must be (numerically) SPD — add a ridge before calling if unsure."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def smallest_eigvec_spd(A: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue of a small symmetric PSD
    matrix (..., n, n): the null vector of a DLT system."""
    return jnp.linalg.eigh(A)[1][..., :, 0]
