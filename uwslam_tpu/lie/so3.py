"""SO(3) Lie group operations in pure JAX.

Capability parity with the vendored Sophus SO3 used by the reference
(/root/reference/thirdparty/sophus/so3.hpp: exp/log/inverse/matrix/Adj), but
re-designed for batched arrays: rotations are stored as 3x3 matrices
(compose = matmul), exp/log use Taylor-guarded closed forms so they are batchable,
differentiable, and NaN-free under jit at theta -> 0 and theta -> pi.

All functions broadcast over arbitrary leading batch dimensions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.precision import einsum as _einsum, mm as _mm

# Small-angle threshold below which Taylor expansions are used. f32-safe.
_EPS = 1e-6


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _safe_theta(theta2: jax.Array) -> jax.Array:
    """sqrt clamped away from 0 so reverse-mode gradients never see 1/0.

    The Taylor branches below are selected for theta2 < _EPS^2, where this
    clamped value is never used — the double-where pattern keeps both the
    primal and the gradient NaN-free."""
    return jnp.sqrt(jnp.where(theta2 < _EPS * _EPS, 1.0, theta2))


def _sinc2(theta2: jax.Array) -> jax.Array:
    """sin(t)/t as a function of t^2, Taylor-guarded at 0."""
    t = _safe_theta(theta2)
    return jnp.where(
        theta2 < _EPS * _EPS, 1.0 - theta2 / 6.0, jnp.sin(t) / t
    )


def _cosc2(theta2: jax.Array) -> jax.Array:
    """(1 - cos(t)) / t^2 as a function of t^2, Taylor-guarded at 0."""
    t = _safe_theta(theta2)
    return jnp.where(
        theta2 < _EPS * _EPS,
        0.5 - theta2 / 24.0,
        (1.0 - jnp.cos(t)) / jnp.where(theta2 < _EPS * _EPS, 1.0, theta2),
    )


def exp(w: jax.Array) -> jax.Array:
    """Exponential map: rotation vector (..., 3) -> rotation matrix (..., 3, 3).

    Rodrigues: R = I + sinc(t) * W + cosc(t) * W^2, t = |w|.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = _mm(W, W)
    a = _sinc2(theta2)[..., None, None]
    b = _cosc2(theta2)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def log(R: jax.Array) -> jax.Array:
    """Logarithm map: rotation matrix (..., 3, 3) -> rotation vector (..., 3).

    Robust across the full angle range including near pi, where the
    antisymmetric part vanishes; there we fall back to the symmetric-part
    (axis from diagonal) formula.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # theta via atan2(sin, cos): much better f32 conditioning than arccos,
    # whose derivative blows up as 1/sin(theta) near 0 and pi.
    # Differentiation-safety: smallness is tested on the POLYNOMIAL
    # n2 = |R - R^T|^2/... = (2 sin theta)^2, never on a norm/sqrt whose
    # tangent at 0 is NaN — the sqrt below is only evaluated (and only
    # differentiated) where n2 is bounded away from 0.
    antisym = vee(R - jnp.swapaxes(R, -1, -2))
    n2 = jnp.sum(antisym * antisym, axis=-1)     # (2 sin theta)^2
    small_sin = n2 < _EPS * _EPS                  # identity OR near pi
    sin_theta = 0.5 * jnp.sqrt(jnp.where(small_sin, 1.0, n2))
    theta_g = jnp.arctan2(sin_theta, cos_theta)
    near_pi = cos_theta < -0.99999
    # Identity region: theta/(2 sin theta) = 0.5 + theta^2/12 + ... with
    # theta^2 ~= n2/4 — a polynomial in n2, tangent-safe.
    generic_scale = jnp.where(
        small_sin,
        0.5 + n2 / 48.0,
        theta_g / jnp.where(small_sin, 1.0, 2.0 * sin_theta),
    )
    w_generic = antisym * generic_scale[..., None]
    # Near pi, recover theta from sin via arcsin (finite tangent at 0).
    theta = jnp.where(
        near_pi,
        jnp.pi - jnp.arcsin(jnp.clip(0.5 * jnp.sqrt(n2 + 1e-24), 0.0, 1.0)),
        theta_g,
    )

    # Near-pi branch: axis_i = sqrt((R_ii - cos) / (1 - cos)); signs recovered
    # from off-diagonal sums R_ij + R_ji = 2 axis_i axis_j (1 - cos).
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    denom = jnp.where(jnp.abs(1.0 - cos_theta) < 1e-12, 1.0, 1.0 - cos_theta)
    axis_sq = jnp.clip((diag - cos_theta[..., None]) / denom[..., None], 0.0, None)
    # +1e-12 keeps the tangent finite where a component is exactly 0 (log is
    # genuinely non-smooth at pi; this bounds rather than removes the kink).
    axis = jnp.sqrt(axis_sq + 1e-12)
    # Resolve signs: use off-diagonal sums R_ij + R_ji = 2 axis_i axis_j (1-cos).
    # Pick the largest axis component as positive, derive others' signs from it.
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    imax = jnp.argmax(axis_sq, axis=-1)
    sx = jnp.where(
        imax == 0,
        1.0,
        jnp.where(imax == 1, jnp.sign(s01), jnp.sign(s02)),
    )
    sy = jnp.where(
        imax == 0,
        jnp.sign(s01),
        jnp.where(imax == 1, 1.0, jnp.sign(s12)),
    )
    sz = jnp.where(
        imax == 0,
        jnp.sign(s02),
        jnp.where(imax == 1, jnp.sign(s12), 1.0),
    )
    signs = jnp.stack([sx, sy, sz], axis=-1)
    signs = jnp.where(signs == 0.0, 1.0, signs)
    w_pi = axis * signs * theta[..., None]

    return jnp.where(near_pi[..., None], w_pi, w_generic)


def inverse(R: jax.Array) -> jax.Array:
    """Inverse rotation = transpose."""
    return jnp.swapaxes(R, -1, -2)


def compose(Ra: jax.Array, Rb: jax.Array) -> jax.Array:
    """Composition Ra * Rb (matmul)."""
    return _mm(Ra, Rb)


def apply(R: jax.Array, p: jax.Array) -> jax.Array:
    """Rotate points: (..., 3, 3) x (..., 3) -> (..., 3)."""
    return _einsum("...ij,...j->...i", R, p)


def adjoint(R: jax.Array) -> jax.Array:
    """Adjoint of SO(3) is the rotation matrix itself."""
    return R


def normalize(R: jax.Array) -> jax.Array:
    """Re-orthonormalize a drifting rotation matrix via symmetric orthogonalization.

    Uses the quaternion-free Cayley/SVD-lite iteration: two Newton steps of
    R <- R (3I - R^T R)/2, adequate for f32 drift from compounding matmuls.

    The Newton iteration DIVERGES (cubically!) when any singular value
    exceeds sqrt(3) — e.g. when a residual Sim(3) scale sneaks into an
    SE(3) slot — so the input is first de-scaled by its Frobenius-based
    scale estimate (||sR||_F = s*sqrt(3) for a scaled rotation): exact for
    scaled rotations, a no-op for unit ones, and it turns the divergence
    mode into a correct re-normalization."""
    fro = jnp.sqrt(
        jnp.sum(R * R, axis=(-2, -1), keepdims=True) / 3.0
    )
    R = R / jnp.maximum(fro, 1e-12)
    for _ in range(2):
        RtR = _mm(jnp.swapaxes(R, -1, -2), R)
        eye3 = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), RtR.shape)
        R = _mm(R, 1.5 * eye3 - 0.5 * RtR)
    return R


def from_quaternion(q: jax.Array) -> jax.Array:
    """Unit quaternion [w, x, y, z] (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                axis=-1,
            ),
        ],
        axis=-2,
    )


def to_quaternion(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> unit quaternion [w, x, y, z] (..., 4).

    Branch-free Shepperd-style construction safe under jit: computes all four
    candidate quaternions and selects the one seeded from the largest pivot.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c, d):
        # Shepperd candidate with pivot value t: the pivot slot's numerator is t
        # itself, each component = numerator * 0.5 / sqrt(t).
        s = jnp.sqrt(jnp.clip(t, 1e-12, None))
        inv = 0.5 / s
        return jnp.stack([a * inv, b * inv, c * inv, d * inv], axis=-1)

    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    qw = cand(tw, tw, m21 - m12, m02 - m20, m10 - m01)
    qx = cand(tx, m21 - m12, tx, m01 + m10, m02 + m20)
    qy = cand(ty, m02 - m20, m01 + m10, ty, m12 + m21)
    qz = cand(tz, m10 - m01, m02 + m20, m12 + m21, tz)

    t_all = jnp.stack([tw, tx, ty, tz], axis=-1)
    pivot = jnp.argmax(t_all, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(
        cands, pivot[..., None, None].repeat(4, axis=-1), axis=-2
    )[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def left_jacobian(w: jax.Array) -> jax.Array:
    """Left Jacobian J_l of SO(3): integrates exp along the geodesic.

    J_l = I + cosc(t) W + (1 - sinc(t))/t^2 W^2. Used by SE(3) exp's V matrix.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = _mm(W, W)
    b = _cosc2(theta2)
    safe2 = jnp.where(theta2 < _EPS * _EPS, 1.0, theta2)
    c = jnp.where(
        theta2 < _EPS * _EPS,
        1.0 / 6.0 - theta2 / 120.0,
        (1.0 - _sinc2(theta2)) / safe2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian_inverse(w: jax.Array) -> jax.Array:
    """Inverse of the SO(3) left Jacobian, with Taylor-guarded coefficient."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = _safe_theta(theta2)
    W = hat(w)
    W2 = _mm(W, W)
    # Coefficient (1 - t/2 cot(t/2)) / t^2, written via half-angle to stay
    # finite up to t < 2 pi (sin(t/2) != 0 there); Taylor 1/12 + t^2/720 at 0.
    small = theta2 < _EPS * _EPS
    half = 0.5 * theta
    sin_half = jnp.sin(half)
    cot_num = 1.0 - half * jnp.cos(half) / jnp.where(small, 1.0, sin_half)
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        cot_num / jnp.where(small, 1.0, theta2),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * W2


def interpolate(Ra: jax.Array, Rb: jax.Array, t) -> jax.Array:
    """Geodesic interpolation R(t) = Ra * exp(t * log(Ra^-1 Rb)).

    Mirrors sophus/interpolate.hpp capability.
    """
    rel = log(compose(inverse(Ra), Rb))
    return compose(Ra, exp(rel * jnp.asarray(t)[..., None]))
