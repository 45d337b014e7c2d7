"""Pure-JAX Lie groups: SO(3), SE(3), Sim(3).

JAX replacement for the reference's vendored Sophus
(/root/reference/thirdparty/sophus/, typedef'd at include/Options.h:128-130).
"""
from . import se3, sim3, so3

__all__ = ["so3", "se3", "sim3"]
