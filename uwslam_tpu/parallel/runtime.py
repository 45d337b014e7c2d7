"""Multi-host runtime: jax.distributed bring-up + mesh construction.

The reference's only 'distributed' machinery is ROS pub/sub for visualization
(SURVEY.md §5). This module is the control plane for scaling past one host: initialize the
jax.distributed service, build named meshes over all devices, and funnel
host-side I/O
through process 0.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).

    No-op for single-process runs (the common 1-host case)."""
    num = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num,
        process_id=(
            process_id
            if process_id is not None
            else int(os.environ.get("JAX_PROCESS_ID", "0"))
        ),
    )


def landmark_mesh(max_devices: int | None = None) -> Mesh:
    """1-D mesh over all devices for landmark-sharded BA (axis 'lm').

    Device order follows jax.devices(). The GPUs of one host are joined all
    to all (NVLink), so the order does not matter there."""
    devs = jax.devices()
    if max_devices is not None:
        devs = devs[:max_devices]
    from .dist_ba import AXIS

    return Mesh(np.array(devs), (AXIS,))


def grid_mesh(rows: int, cols: int, axes=("kf", "lm")) -> Mesh:
    """2-D mesh: keyframe-parallel x landmark-parallel (for very large
    windows where the reduced camera system itself is sharded)."""
    devs = np.array(jax.devices()[: rows * cols]).reshape(rows, cols)
    return Mesh(devs, axes)


def is_primary() -> bool:
    """True on the process that owns host-side I/O (trajectory export,
    logging) — the reference's single-process stdout/CSV equivalent."""
    return jax.process_index() == 0


@contextmanager
def primary_only_io():
    """Context that makes non-primary processes skip host I/O blocks."""
    if is_primary():
        yield True
    else:
        yield False
