"""Two-process jax.distributed test — the multi-process control path.

All other multi-device tests run ONE process with 8 virtual devices, which
exercises sharding correctness but never crosses a process boundary. This
spawns two real processes (4 virtual CPU devices each), joins them through
a coordinator, and runs a distributed bundle adjustment whose psums span
both — validating runtime.init_distributed, the cross-process mesh, and
the global-array plumbing end to end.
"""
import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_ba(tmp_path):
    port = _free_port()
    out_json = tmp_path / "dist_ba.json"
    worker = os.path.join(os.path.dirname(__file__), "_dist_worker.py")
    env = dict(os.environ)
    # The workers set their own platform/device-count config; scrub the
    # conftest's 8-device flag so each sees exactly 4 local devices.
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(port), str(out_json)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    res = json.loads(out_json.read_text())
    assert res["processes"] == 2
    assert res["global_devices"] == 8
    assert res["final_cost"] < res["initial_cost"] * 1e-2, res
    assert res["max_pose_err"] < 5e-3, res


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])
