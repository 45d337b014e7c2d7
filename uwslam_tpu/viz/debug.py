"""Debug visualizers — file-based equivalents of the reference's interactive
imshow panels (SURVEY.md §4 de-facto validation mechanisms):

- DebugShowCandidatePoints (/root/reference/src/Tracker.cpp:1657)
- DebugShowResidual (:1673)
- DebugShowWarpedPerspective 4-pane GN result (:1694)
- DebugShowJacobians 6-pane (:1541)

Interactive cv::imshow windows make no sense on a headless accelerator host; these
write PNG panels instead, computed from the same quantities the tracker uses.
"""
from __future__ import annotations

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = np.percentile(img, [1, 99])
    img = (img - lo) / max(hi - lo, 1e-6)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _save(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def save_candidate_points(path: str, image, pts_uv, valid) -> None:
    """Candidate-point overlay (DebugShowCandidatePoints)."""
    img = np.stack([_to_u8(image)] * 3, axis=-1)
    uv = np.asarray(pts_uv)[np.asarray(valid)]
    H, W = img.shape[:2]
    u = np.clip(uv[:, 0].astype(int), 0, W - 1)
    v = np.clip(uv[:, 1].astype(int), 0, H - 1)
    img[v, u] = (255, 32, 32)
    _save(path, img)


def save_residual_map(path: str, image, pts_uv, residuals, valid) -> None:
    """Residuals scattered at their pixel locations, signed red/blue
    (DebugShowResidual)."""
    base = _to_u8(image)
    img = np.stack([base] * 3, axis=-1)
    uv = np.asarray(pts_uv)
    r = np.asarray(residuals)
    m = np.asarray(valid)
    H, W = img.shape[:2]
    u = np.clip(uv[m, 0].astype(int), 0, W - 1)
    v = np.clip(uv[m, 1].astype(int), 0, H - 1)
    rr = r[m]
    scale = max(float(np.percentile(np.abs(rr), 95)), 1e-6)
    pos = np.clip(rr / scale, 0, 1)
    neg = np.clip(-rr / scale, 0, 1)
    img[v, u, 0] = (255 * pos).astype(np.uint8)
    img[v, u, 2] = (255 * neg).astype(np.uint8)
    img[v, u, 1] = 0
    _save(path, img)


def save_warped_panels(path_prefix: str, ref_img, tgt_img, pts, T, cam) -> None:
    """4-pane GN result (DebugShowWarpedPerspective): reference, target,
    warped-point overlay on target, residual map."""
    import jax.numpy as jnp

    from ..image.pyramid import bilinear_sample
    from ..lie import se3

    p_t = se3.apply(jnp.asarray(T), pts.p3d)
    uv_t = np.asarray(cam.project(p_t))
    i_t, inb = bilinear_sample(jnp.asarray(tgt_img, jnp.float32),
                               jnp.asarray(uv_t))
    r = np.asarray(i_t) - np.asarray(pts.intensity)
    valid = np.asarray(pts.valid) & np.asarray(inb)
    _save(path_prefix + "_ref.png", _to_u8(ref_img))
    _save(path_prefix + "_tgt.png", _to_u8(tgt_img))
    save_candidate_points(path_prefix + "_warped.png", tgt_img, uv_t, valid)
    save_residual_map(path_prefix + "_residual.png", tgt_img, uv_t, r, valid)


def save_jacobian_panels(path_prefix: str, ref_pyr_level, pts, T, cam) -> None:
    """6-pane per-twist-column |J| overlays (DebugShowJacobians)."""
    import jax.numpy as jnp

    from ..tracking.photometric import residuals_and_jacobian

    image, grad_x, grad_y = ref_pyr_level
    _, J, valid = residuals_and_jacobian(
        jnp.asarray(T), pts, pts.intensity,
        jnp.asarray(image, jnp.float32), jnp.asarray(grad_x, jnp.float32),
        jnp.asarray(grad_y, jnp.float32), cam,
    )
    J = np.asarray(J)
    for col, name in enumerate(("vx", "vy", "vz", "wx", "wy", "wz")):
        save_residual_map(
            f"{path_prefix}_J_{name}.png", image, np.asarray(pts.uv),
            J[:, col], np.asarray(valid),
        )
