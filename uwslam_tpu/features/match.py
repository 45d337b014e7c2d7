"""Descriptor matching: brute-force kNN as a matmul + ratio/symmetry tests.

Mirrors the reference RobustMatcher's pipeline
(/root/reference/src/Tracker.cpp:171-247):
- BF kNN(k=2) in both directions (:199-200,221-222)  -> one (K,D)x(D,K) matmul
  + two top-2 reductions (one matmul replaces the CUDA BFMatcher)
- ratio test 0.65 in each direction (:52-71, threshold include/Tracker.h:80)
- symmetry (mutual-consistency) test (:74-101)
RANSAC geometric verification lives in ransac.py.

All outputs are fixed-capacity with validity masks.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

RATIO = 0.65  # reference include/Tracker.h:80


class Matches(NamedTuple):
    idx_a: jax.Array   # (K,) int32 index into keypoint set A
    idx_b: jax.Array   # (K,) int32 index into keypoint set B
    score: jax.Array   # (K,) similarity of the accepted pair
    valid: jax.Array   # (K,) bool


@partial(jax.jit, static_argnames=())
def _ratio_test_dir(sim: jax.Array, valid_a, valid_b, ratio: float):
    """Per-row best/second-best with L2-ratio test on cosine similarities.

    Descriptors are L2-normalized, so d2 = 2 - 2*sim; the SURF-style ratio
    d_best/d_second < r becomes (1-s1) < r^2 (1-s2)."""
    masked = jnp.where(valid_b[None, :], sim, -jnp.inf)
    top2, idx2 = jax.lax.top_k(masked, 2)
    s1, s2 = top2[:, 0], top2[:, 1]
    best = idx2[:, 0]
    pass_ratio = (1.0 - s1) < (ratio * ratio) * (1.0 - s2)
    ok = valid_a & jnp.isfinite(s1) & jnp.isfinite(s2) & pass_ratio
    return best, s1, ok


@partial(jax.jit, static_argnames=())
def match_descriptors(
    desc_a: jax.Array,
    desc_b: jax.Array,
    valid_a: jax.Array,
    valid_b: jax.Array,
    ratio: float = RATIO,
) -> Matches:
    """Bidirectional ratio-tested mutual matching. Capacity = len(A)."""
    # bf16 inputs are plenty for descriptor similarity; accumulate in f32.
    sim = jnp.dot(
        desc_a.astype(jnp.bfloat16),
        desc_b.astype(jnp.bfloat16).T,
        preferred_element_type=jnp.float32,
    )
    best_ab, s_ab, ok_ab = _ratio_test_dir(sim, valid_a, valid_b, ratio)
    best_ba, s_ba, ok_ba = _ratio_test_dir(sim.T, valid_b, valid_a, ratio)

    # Symmetry: a -> b and b -> a must agree (reference symmetryTest :74-101).
    mutual = best_ba[best_ab] == jnp.arange(desc_a.shape[0])
    ok = ok_ab & mutual & ok_ba[best_ab]
    return Matches(
        idx_a=jnp.arange(desc_a.shape[0], dtype=jnp.int32),
        idx_b=best_ab.astype(jnp.int32),
        score=s_ab,
        valid=ok,
    )
