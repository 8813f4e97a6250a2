"""Multi-host runtime: initialization and trajectory-sweep sharding.

The reference has no distributed backend at all (single process,
single GPU — SURVEY.md §5 "communication backend" row). This
framework scales across processes with ``jax.distributed``: every
process runs the same program, the global mesh spans all processes'
devices, and waypoint (swarm) shards are split between them.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (no-op if single-process).

    Nothing detects a cluster by itself: pass the coordinator address
    (``host:port``), the process count and this process's id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        if jax.process_count() == 1 and num_processes is None:
            return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_waypoint_slice(num_waypoints: int) -> slice:
    """Which contiguous waypoint block this process owns.

    The host-level decomposition of a trajectory sweep: waypoints are
    split evenly across processes; each process builds only its local
    targets (data never leaves the host it is needed on).
    """
    p = jax.process_count()
    i = jax.process_index()
    per = -(-num_waypoints // p)
    return slice(i * per, min((i + 1) * per, num_waypoints))


def sweep_waypoints_multihost(
    spec,
    problem,
    waypoints: np.ndarray,
    key,
    *,
    batch_size: int = 256,
    use_local_mesh: bool = True,
    **solve_kwargs,
):
    """A trajectory sweep sharded across the processes of a pod.

    The host-level decomposition of BASELINE config 5 ("10k waypoints
    across a multi-host pod slice"): each process solves its contiguous
    :func:`process_waypoint_slice` block on its OWN local devices (a
    local swarm mesh — waypoints are independent, so the only
    cross-host traffic is the final result merge, which rides DCN via
    ``multihost_utils.process_allgather``). Every process returns the
    complete, identically-ordered global result.

    Call :func:`initialize` first; under a single process this
    degrades gracefully to a plain local sweep.

    Returns ``(SweepResult, slice)`` — the merged global result plus
    this process's waypoint slice (for per-host logging).
    """
    import jax.numpy as jnp

    from ikpso.harness.trajectory import SweepResult, solve_waypoints
    from ikpso.parallel.mesh import make_mesh

    waypoints = np.asarray(waypoints, np.float32)
    w = waypoints.shape[0]
    p = jax.process_count()
    per = -(-w // p)
    sl = process_waypoint_slice(w)
    local = waypoints[sl]
    if local.shape[0] == 0:
        raise ValueError(
            f"process {jax.process_index()} owns no waypoints "
            f"({w} waypoints over {p} processes); shrink the pod or "
            "grow the sweep"
        )
    # Distinct RNG stream per host (same role as the per-shard fold_in
    # inside solve_sharded).
    key = jax.random.fold_in(key, jax.process_index())

    mesh = None
    if use_local_mesh and len(jax.local_devices()) > 1:
        mesh = make_mesh(devices=jax.local_devices())
    res = solve_waypoints(
        spec, problem, local, key,
        batch_size=min(batch_size, local.shape[0]),
        mesh=mesh,
        **solve_kwargs,
    )

    if p == 1:
        return res, sl

    from jax.experimental import multihost_utils

    # Pad every process's block to the common `per` rows so the gather
    # is rectangular (static shapes; edge rows are dropped after).
    ang = pad_to_multiple(res.angles, per)
    err = pad_to_multiple(res.errors, per)
    rate = np.asarray([res.solves_per_second], np.float32)
    all_ang = np.asarray(multihost_utils.process_allgather(jnp.asarray(ang)))
    all_err = np.asarray(multihost_utils.process_allgather(jnp.asarray(err)))
    all_rate = np.asarray(multihost_utils.process_allgather(jnp.asarray(rate)))
    merged = SweepResult(
        angles=all_ang.reshape(p * per, -1)[:w],
        errors=all_err.reshape(p * per)[:w],
        # Hosts sweep concurrently: aggregate throughput is the sum.
        solves_per_second=float(all_rate.sum()),
    )
    return merged, sl


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad a waypoint batch so its swarm axis divides the mesh evenly
    (static shapes per jit trace; SURVEY.md §7 'hard parts')."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode="edge")
