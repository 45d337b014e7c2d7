"""Op-level device-time attribution for the offline chunk (VERDICT r4 #4).

Runs the bench.py chunk program under the JAX profiler, maps every device
op back to its source line via the compiled HLO's metadata, and prints a
per-source-line budget table — the evidence trail for where each
millisecond of 1/fps goes. Writes JSON with --out.

Run on the GPU: python benchmarks/attribute_trace.py [--out FILE]
"""
from __future__ import annotations

import collections
import json
import math
import os
import re
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks import device as dev


def main() -> None:
    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3
    from uwslam_tpu.tracking.sequence import track_sequence_batched
    from uwslam_tpu.utils.synthetic import render_plane_view

    dev.require_gpu()
    cam = PinholeCamera(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480
    )
    poses = [
        se3.exp(
            jnp.asarray([0.06, 0.024, 0.008, 0.004, -0.006, 0.008])
            * math.sin(2 * math.pi * i / 24.0)
        )
        for i in range(96)
    ]
    frames = jnp.stack(
        [render_plane_view(cam, T, 2.0) for T in poses]
    ).block_until_ready()

    def run_chunk(fr):
        T_rel, _, _ = track_sequence_batched(
            fr, cam, mono_z=2.0, levels=5, track_levels=(3, 2, 1, 0),
            num_points=2048, max_iters=(12, 8, 5, 3), mode="ic",
        )
        return T_rel

    run = jax.jit(run_chunk)
    lowered = run.lower(frames)
    hlo = lowered.compile().as_text()

    src = {}
    pat = re.compile(
        r"%([\w.\-]+) = .*?metadata=\{op_name=\"([^\"]*)\""
        r" source_file=\"([^\"]*)\" source_line=(\d+)"
    )
    for line in hlo.splitlines():
        m = pat.search(line)
        if m:
            name, opn, f, ln = m.groups()
            src[name] = (f.split("/")[-1] + ":" + ln, opn.split("/")[-1])

    np.asarray(run(frames))  # warm
    tdir = tempfile.mkdtemp(prefix="uwslam_trace_")
    reps = 3
    jax.profiler.start_trace(tdir)
    for i in range(reps):
        np.asarray(run(frames + 0.1 * i))
    jax.profiler.stop_trace()

    events = dev.device_events(dev.load_trace(tdir))
    agg = collections.defaultdict(float)
    span = dev.busy_us(events) / 1e3 / reps
    for e in events:
        name = e.get("name", "")
        dur = e.get("dur", 0) / 1e3 / reps
        key = src.get(name, ("<unattributed>", name.split(".")[0]))
        agg[(key[0], key[1])] += dur
    shutil.rmtree(tdir, ignore_errors=True)

    rows = [
        {"source": s, "op": o, "ms_per_chunk": round(v, 3)}
        for (s, o), v in sorted(agg.items(), key=lambda kv: -kv[1])
        if v >= 0.05
    ]
    out = {
        "device": dev.device_info(),
        "chunk": "96 frames, 95 tracked pairs (bench.py program)",
        "device_busy_ms_per_chunk": round(span, 3),
        "attribution": rows,
    }
    print(json.dumps(out, indent=1))
    if "--out" in sys.argv:
        p = sys.argv[sys.argv.index("--out") + 1]
        with open(p, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {p}", file=sys.stderr)


if __name__ == "__main__":
    main()
