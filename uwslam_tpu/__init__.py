"""uwslam_tpu — a monocular SLAM framework in JAX.

Brand-new JAX/XLA implementation covering the full capability surface of
MecatronicaUSB/uw-slam (see SURVEY.md): image pyramids + gradients, feature
detection/robust matching, direct photometric Gauss-Newton/LM tracking over
SE(3), camera calibration/undistortion, keyframe map management, sliding-window
bundle adjustment, and multi-device scaling via jax.sharding meshes.
"""
import os as _os

# Fixed in-checkout compile cache: the directory is part of the cache key, so
# a path that moves never hits.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _setup_compile_cache() -> None:
    """Persistent XLA compilation cache for the large jitted tracking / BA
    programs, so every process after the first warm-starts.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing is set
    here; otherwise the cache lives in CACHE_DIR."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_setup_compile_cache()

from . import lie  # noqa: E402

__version__ = "0.2.0"

__all__ = ["lie"]
