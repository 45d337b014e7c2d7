"""What the benchmarks know about the device they run on.

- `require_gpu()`: every measurement here is a device number, so a run that
  finds no GPU fails instead of timing the CPU.
- `PEAKS`: published peaks keyed by `jax.devices()[0].device_kind`. A kind
  that is not in the table is an error, not a default.
- `device_busy_us()`: the union of the intervals in which the GPU ran an
  operation, read from a `jax.profiler` trace.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import subprocess

import jax

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_GBps": 3350.0,
        "bf16_TFLOPs": 989.0,
        "tf32_TFLOPs": 495.0,
        "fp32_TFLOPs": 67.0,
        "source": "NVIDIA H100 SXM data sheet, dense, 700 W",
    },
}


def require_gpu() -> jax.Device:
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"this benchmark measures a GPU; JAX found {d.platform!r}"
        )
    return d


def device_info() -> dict:
    """platform, device_kind and count as JAX reports them, plus the card's
    name and power limit from nvidia-smi (the card may be capped below its
    maximum, which slows it under load)."""
    d = jax.devices()[0]
    info = {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "count": len(jax.devices()),
    }
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info["nvidia_smi"] = "unavailable"
    return info


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to "
            "benchmarks/device.py PEAKS with its source"
        )
    return PEAKS[kind]


def is_device_line(process_name: str) -> bool:
    """True for the trace processes that hold GPU device activity."""
    return "/device:GPU" in process_name


def load_trace(trace_dir: str) -> list[dict]:
    paths = sorted(glob.glob(
        os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz")
    ))
    if not paths:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        return json.load(f)["traceEvents"]


def device_events(events: list[dict]) -> list[dict]:
    pids = {
        e["pid"]: e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and "args" in e
    }
    out = [
        e for e in events
        if e.get("ph") == "X" and is_device_line(pids.get(e.get("pid"), ""))
    ]
    if not out:
        raise RuntimeError("no GPU device events in the trace")
    return out


def busy_us(events: list[dict]) -> float:
    """Union of [ts, ts + dur) over the given events, in microseconds."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_busy_us(trace_dir: str) -> float:
    return busy_us(device_events(load_trace(trace_dir)))
