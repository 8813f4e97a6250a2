"""Multi-chip / multi-host scaling: meshes, sharded solves, collectives."""

from ikpso.parallel.distributed import (
    initialize,
    process_waypoint_slice,
    sweep_waypoints_multihost,
)
from ikpso.parallel.mesh import PARTICLE_AXIS, SWARM_AXIS, hybrid_mesh, make_mesh, swarm_mesh
from ikpso.parallel.sharded import distributed_argmin, make_sharded_solver, solve_sharded
