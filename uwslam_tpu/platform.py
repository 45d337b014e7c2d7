"""The one place where the CPU and the GPU take different forms of an op.

`choose` stages both forms with `jax.lax.platform_dependent`, so the branch
is picked for the platform the computation is LOWERED for, not for JAX's
default backend: a function jitted with CPU-committed arguments on a GPU
machine runs the CPU form. Only the CPU and the GPU (CUDA or ROCm) have
forms; each call site says why its GPU form won on an H100 (PERF.md).
"""
from __future__ import annotations

from typing import Callable

import jax


def choose(cpu_form: Callable, gpu_form: Callable, *args):
    """`cpu_form(*args)` where lowered for the CPU, `gpu_form(*args)` where
    lowered for a GPU."""
    return jax.lax.platform_dependent(
        *args, cpu=cpu_form, cuda=gpu_form, rocm=gpu_form
    )
