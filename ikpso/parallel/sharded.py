"""Sharded PSO solves: swarm-parallel, particle-parallel, or both.

Mapping from the reference's parallelism story (SURVEY.md §2.5):

  * The reference's one CUDA-thread-per-particle data parallelism
    becomes the vectorized particle axis inside one chip.
  * Its ``thrust::min_element`` device-wide reduction becomes either a
    local ``argmin`` (swarm fits on one chip) or
    :func:`distributed_argmin` — a min + owner-select all-reduce over
    the mesh's ``particle`` axis (NVLink between the cards of a host).
  * Swarm batching (absent in the reference, which re-solves one
    problem per frame) shards over the ``swarm`` axis with zero
    communication.

Everything is ``shard_map`` over a ``Mesh``; under ``jit`` the whole
multi-chip solve is one XLA program with no host round-trips.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso.ops.fitness import FitnessConfig
from ikpso.parallel.mesh import PARTICLE_AXIS, SWARM_AXIS
from ikpso.pso.config import PSOConfig
from ikpso.pso.solver import SolveResult, solve

_INT_MAX = jnp.iinfo(jnp.int32).max


def distributed_argmin(
    val: jnp.ndarray, coords: jnp.ndarray, axis_name: str
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Global (min value, argmin coords) across a mesh axis.

    Three collectives: ``pmin`` on the value, ``pmin`` on the owner
    rank (deterministic tie-break: lowest rank wins, mirroring
    thrust::min_element's first-minimum semantics), and a ``psum``
    carrying only the winner's coordinates.
    """
    gval = lax.pmin(val, axis_name)
    me = lax.axis_index(axis_name)
    owner = jnp.where(val <= gval, me, _INT_MAX)
    min_owner = lax.pmin(owner, axis_name)
    contrib = jnp.where((me == min_owner)[..., None], coords, 0.0)
    gcoords = lax.psum(contrib, axis_name)
    return gval, gcoords


def _problem_specs(problem: IKProblem, spec: P):
    return jax.tree.map(lambda _: spec, problem)


def solve_sharded(
    chain: ChainSpec,
    problem: IKProblem,
    key: jnp.ndarray,
    mesh: Mesh,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    fitness_fn=None,
    jit: bool = True,
    impl: str = "jnp",
    interpret=False,
) -> SolveResult:
    """Solve a swarm batch across a device mesh.

    If the mesh has a ``swarm`` axis, the problem's leading (swarm)
    axis is sharded over it (S must divide evenly). If it has a
    ``particle`` axis, each swarm's ``num_particles`` (a GLOBAL count)
    are split over it and gbest reductions ride the interconnect.

    Returns a SolveResult whose arrays are globally-shaped
    ``jax.Array``s sharded/replicated per the mesh.
    """
    has_swarm = SWARM_AXIS in mesh.axis_names
    has_particle = PARTICLE_AXIS in mesh.axis_names
    n_particle_shards = mesh.shape[PARTICLE_AXIS] if has_particle else 1
    if num_particles % n_particle_shards:
        raise ValueError(
            f"num_particles={num_particles} not divisible by "
            f"{n_particle_shards} particle shards"
        )
    local_particles = num_particles // n_particle_shards

    s = problem.pose.shape[0]
    if has_swarm and s % mesh.shape[SWARM_AXIS]:
        raise ValueError(
            f"swarm count {s} not divisible by mesh swarm axis "
            f"{mesh.shape[SWARM_AXIS]}"
        )

    swarm_spec = P(SWARM_AXIS) if has_swarm else P()
    in_specs = (_problem_specs(problem, swarm_spec), P())
    trace_spec = P(None, SWARM_AXIS) if has_swarm else P(None)
    out_specs = SolveResult(
        angles=swarm_spec,
        fitness=swarm_spec,
        pose=swarm_spec,
        effector_error=swarm_spec,
        trace=trace_spec,
    )

    gbest_reduce = (
        functools.partial(distributed_argmin, axis_name=PARTICLE_AXIS)
        if has_particle
        else None
    )

    if impl == "fused":
        if has_particle:
            raise ValueError(
                "impl='fused' shards swarms only; the megakernel's gbest "
                "is swarm-local (use impl='jnp' for particle-axis sharding)"
            )
        from ikpso.pso.fused import make_fused_solver

        fused = make_fused_solver(
            chain, pso=pso, fit=fit, obstacles=obstacles,
            num_particles=num_particles,
            interpret=interpret,
        )

    def body(local_problem: IKProblem, k: jnp.ndarray) -> SolveResult:
        # Distinct RNG stream per shard: swarm shards hold different
        # problems, particle shards hold different particles.
        if has_swarm:
            k = jax.random.fold_in(k, lax.axis_index(SWARM_AXIS))
        if has_particle:
            k = jax.random.fold_in(k, lax.axis_index(PARTICLE_AXIS))
        if impl == "fused":
            return fused(local_problem, k)
        return solve(
            chain,
            local_problem,
            k,
            pso=pso,
            fit=fit,
            obstacles=obstacles,
            num_particles=local_particles,
            fitness_fn=fitness_fn,
            gbest_reduce=gbest_reduce,
            vary_axes=(PARTICLE_AXIS,) if has_particle else (),
        )

    # The megakernel's outputs vary over the swarm axis like its inputs;
    # the Pallas interpreter (CPU runs of the kernel) cannot track that
    # through its grid loop, so the varying-axes check is off for it.
    mapped = jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=impl != "fused",
    )
    if jit:
        mapped = jax.jit(mapped)
    # Place inputs to match the shardings (avoids resharding transfers).
    problem = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, swarm_spec)), problem
    )
    return mapped(problem, key)


def make_sharded_solver(chain: ChainSpec, mesh: Mesh, **kwargs):
    """Jitted closure over :func:`solve_sharded` (solver cache)."""

    def _solve(problem: IKProblem, key: jnp.ndarray) -> SolveResult:
        return solve_sharded(chain, problem, key, mesh, **kwargs)

    return _solve
