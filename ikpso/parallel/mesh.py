"""Device-mesh construction helpers.

The reference is single-process/single-GPU with no communication
backend (SURVEY.md §2.5); this design scales over a
``jax.sharding.Mesh`` with named axes:

  * ``swarm``    — independent IK problems (targets/waypoints); zero
    communication (the expert-parallel analog).
  * ``particle`` — the particle axis of one big swarm split across
    devices; global-best needs an all-reduce per iteration (the
    reference's thrust device-wide reduction, reborn as collectives).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

SWARM_AXIS = "swarm"
PARTICLE_AXIS = "particle"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (SWARM_AXIS,),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    Defaults to a 1-D ``('swarm',)`` mesh over all devices — the
    embarrassingly-parallel layout that keeps every collective off the
    hot path. ``shape=(n_swarm, n_particle)`` with
    ``axis_names=('swarm', 'particle')`` gives the 2-D hybrid.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    need = int(np.prod(shape))
    if need > len(devices):
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def swarm_mesh(devices=None) -> Mesh:
    return make_mesh(devices=devices)


def hybrid_mesh(num_particle_shards: int, devices=None) -> Mesh:
    """2-D mesh: particle shards innermost, swarms over the rest.

    The cards of a host are joined all to all, so the layout follows
    the algorithm alone."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % num_particle_shards:
        raise ValueError(
            f"{n} devices not divisible by {num_particle_shards} particle shards"
        )
    return make_mesh(
        (n // num_particle_shards, num_particle_shards),
        (SWARM_AXIS, PARTICLE_AXIS),
        devices,
    )
