"""Camera models, calibration, and rectification (the reference's CameraModel in JAX)."""
from .calibration import Calibration, load, load_json, load_opencv_xml
from .model import (
    PinholeCamera,
    compute_roi,
    optimal_new_camera,
    remap_bilinear,
    undistort_map,
)

__all__ = [
    "PinholeCamera",
    "Calibration",
    "load",
    "load_json",
    "load_opencv_xml",
    "optimal_new_camera",
    "undistort_map",
    "remap_bilinear",
    "compute_roi",
]
