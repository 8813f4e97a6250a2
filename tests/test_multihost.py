"""Multi-host (N=2 processes) trajectory sweep over jax.distributed.

The reference is single-process/single-GPU (SURVEY.md §2.5 / §5
"communication backend: none"); BASELINE config 5 requires a 10k
waypoint sweep across several hosts. This test runs the REAL
multi-process runtime on one machine: two OS processes, each with 4
virtual CPU devices, joined through a local coordinator — the same
code path a multi-host cluster runs, with its network replaced by
localhost gRPC.

Each process solves its contiguous waypoint block on its local
devices and the results merge with ``multihost_utils.process_allgather``
(ikpso.parallel.distributed.sweep_waypoints_multihost).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import sys, json
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from ikpso.parallel import distributed

distributed.initialize(f"localhost:{{port}}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.local_devices()) == 4
assert len(jax.devices()) == 8

import numpy as np
from ikpso.models import library
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig

spec, problem = library.planar_3dof()
rng = np.random.default_rng(0)
base = np.asarray(problem.targets)
W = 10240
waypoints = base[None] + rng.normal(
    scale=0.2, size=(W,) + base.shape
).astype(np.float32)
# The 3-DOF arm is planar: off-plane targets are unreachable and would
# put an error floor under the quality assertion below.
waypoints[..., 2] = base[..., 2]
merged, sl = distributed.sweep_waypoints_multihost(
    spec, problem, waypoints, jax.random.key(0),
    batch_size=512,
    pso=PSOConfig(iterations=20, inertia_mode="canonical",
                  inertia=0.5, inertia_end=0.2),
    fit=FitnessConfig(angle_weight=0.0),
    num_particles=64,
)
json.dump(
    dict(
        process=pid,
        slice=[int(sl.start), int(sl.stop)],
        n=int(merged.errors.size),
        err_mean=float(merged.errors.mean()),
        err_p95=float(np.percentile(merged.errors, 95)),
        finite=bool(np.isfinite(merged.errors).all()),
        angles_checksum=float(np.abs(merged.angles).sum()),
        rate=float(merged.solves_per_second),
    ),
    open(out, "w"),
)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sweep_partitions_and_merges(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items() if not k.startswith("XLA_FLAGS")
    }
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port), str(outs[i])],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    logs = [p.communicate(timeout=540) for p in procs]
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0, se.decode()[-3000:]

    r0, r1 = (json.loads(o.read_text()) for o in outs)
    # Partition: contiguous, disjoint, covering [0, 10240).
    assert r0["slice"] == [0, 5120]
    assert r1["slice"] == [5120, 10240]
    # Merge: every process holds the identical complete global result.
    assert r0["n"] == r1["n"] == 10240
    assert r0["finite"] and r1["finite"]
    np.testing.assert_allclose(r0["err_mean"], r1["err_mean"], rtol=1e-6)
    np.testing.assert_allclose(
        r0["angles_checksum"], r1["angles_checksum"], rtol=1e-6
    )
    # And the sweep actually solved: near-anchor waypoints to ~cm scale.
    assert r0["err_p95"] < 0.2, r0
    assert r0["rate"] > 0
