"""The PSO IK solver: one jitted function, zero host syncs.

Algorithm parity with the reference's ``calculatePSO``
(reference kernel.cu:279-327), restructured for XLA:

  reference (per PSO iteration)            here
  --------------------------------------   ----------------------------
  simulateParticlesKernel launch           velocity/position update in
   + cudaDeviceSynchronize                  the lax.scan body
  updateLocalBests launch                  fitness + where-update
  thrust::min_element (device reduction)   per-swarm argmin on device
   + 1-float D2H memcpy                     (no transfer)
  conditional gbest-coords kernel + sync   jnp.where on the scan carry

The reference crosses the host/device boundary >= 3x per iteration
(SURVEY.md §3.3); here the entire solve — warm-start init, the
iteration loop, and the final result — is a single XLA program.

State layout: ``(S, P, D)`` — S swarms (one per IK target/waypoint),
P particles, D degrees of freedom. Swarm batching replaces the
reference's one-swarm-per-frame serialization; sharding the S axis
over a device mesh is `ikpso.parallel`.

RNG: counter-based threefry keys split per iteration — deterministic
and replayable like the reference's index-seeded curand states
(reference utility_kernels.cuh:28), but with no per-particle state
arrays to allocate or carry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso.ops import fk as fk_ops
from ikpso.ops.fitness import FitnessConfig, fitness, true_effector_error
from ikpso.pso.config import PSOConfig

FitnessFn = Callable[[jnp.ndarray], jnp.ndarray]  # (S, P, D) -> (S, P)
# Optional cross-device reduction applied to the per-shard gbest
# candidate: ((S,), (S, D)) -> ((S,), (S, D)). Used when the particle
# axis of a swarm is sharded across devices (ikpso.parallel) — the
# collective form of the reference's thrust::min_element (SURVEY.md §2.5).
GbestReduce = Callable[[jnp.ndarray, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Output of one batched PSO solve.

    Attributes:
      angles: ``(S, D)`` global-best joint angles per swarm.
      fitness: ``(S,)`` global-best fitness values.
      pose: ``(S, N, 3)`` the problem pose with joint rows replaced by
        the solution (ready to feed back as the next warm start —
        the reference's ``FromCoords`` step, Main.cpp:227).
      effector_error: ``(S,)`` true summed Euclidean effector error of
        the solution (the reference's host oracle ``checkDistance``).
      trace: ``(iterations + 1, S)`` global-best fitness after init and
        after each iteration — the convergence curve.
    """

    angles: jnp.ndarray
    fitness: jnp.ndarray
    pose: jnp.ndarray
    effector_error: jnp.ndarray
    trace: jnp.ndarray


def _swarm_argmin(values: jnp.ndarray, coords: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-swarm best: values (S, P), coords (S, P, D) -> (S,), (S, D)."""
    idx = jnp.argmin(values, axis=-1)
    best_val = jnp.take_along_axis(values, idx[:, None], axis=-1)[:, 0]
    best_coords = jnp.take_along_axis(coords, idx[:, None, None], axis=-2)[:, 0, :]
    return best_val, best_coords


def pso_iteration(
    x: jnp.ndarray,
    v: jnp.ndarray,
    lbest: jnp.ndarray,
    lbest_val: jnp.ndarray,
    gbest: jnp.ndarray,
    gbest_val: jnp.ndarray,
    key: jnp.ndarray,
    fitness_fn: FitnessFn,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    pso: PSOConfig,
    gbest_reduce: Optional[GbestReduce] = None,
    iteration=0,
):
    """One PSO step over the full (S, P, D) state. Pure; scan body."""
    shape = x.shape
    n_kick = 1 if pso.rekick_interval > 0 else 0
    if pso.inertia_mode == "randomized":
        # v = w*U()*v + c1*U()*(lbest-x) + c2*U()*(gbest-x)
        # (reference kernel.cu:164-166 — inertia also randomized).
        u = jax.random.uniform(key, (3 + n_kick,) + shape, dtype=x.dtype)
        u_w, u_c, u_s = u[0], u[1], u[2]
    else:
        u = jax.random.uniform(key, (2 + n_kick,) + shape, dtype=x.dtype)
        u_w = jnp.ones_like(x)
        u_c, u_s = u[0], u[1]

    if n_kick:
        # Periodic velocity re-kick: overwrite the inertia memory with
        # a fresh init-style draw; cognitive/social pull still applies
        # this step. See PSOConfig.rekick_interval. With a threshold,
        # only not-yet-converged swarms (gbest above it) are kicked.
        kick = (iteration > 0) & (iteration % pso.rekick_interval == 0)
        if pso.rekick_threshold >= 0.0:
            kick = kick & (gbest_val > pso.rekick_threshold)[:, None, None]
        v = jnp.where(kick, (u[-1] * 2.0 - 1.0) * pso.rekick_scale, v)

    v = (
        pso.inertia_at(iteration) * u_w * v
        + pso.cognitive * u_c * (lbest - x)
        + pso.social * u_s * (gbest[:, None, :] - x)
    )
    # Position integrate, then per-axis joint-limit clamp; velocity is
    # left unclamped, exactly like the reference (kernel.cu:168-187).
    x = jnp.clip(x + v, lo, hi)

    f = fitness_fn(x)
    improved = f < lbest_val
    lbest_val = jnp.where(improved, f, lbest_val)
    lbest = jnp.where(improved[..., None], x, lbest)

    cand_val, cand = _swarm_argmin(lbest_val, lbest)
    if gbest_reduce is not None:
        cand_val, cand = gbest_reduce(cand_val, cand)
    better = cand_val < gbest_val
    gbest_val = jnp.where(better, cand_val, gbest_val)
    gbest = jnp.where(better[:, None], cand, gbest)
    return x, v, lbest, lbest_val, gbest, gbest_val


def init_swarm(
    key: jnp.ndarray,
    anchor_angles: jnp.ndarray,
    num_particles: int,
    fitness_fn: FitnessFn,
    pso: PSOConfig,
    gbest_reduce: Optional[GbestReduce] = None,
    limits: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
):
    """Swarm init (reference initParticlesKernel, kernel.cu:223-266).

    ``init_mode="warm"`` (default): all particles start AT the current
    pose; exploration comes only from uniform random initial
    velocities — the animation-friendly design decision of the
    reference's iteration 2 (Documentation/Iteration_2/Raport_2.tex:58,
    via SURVEY.md §0). ``init_mode="uniform"``: particles start
    uniformly over the joint range (``limits``) — the reference's
    iteration-1 protocol, for parity with that report.
    """
    s, d = anchor_angles.shape
    if pso.init_mode in ("uniform", "hybrid"):
        # "hybrid": particle 0 warm, the rest uniform — anchored basin
        # coverage for single-shot far targets.
        if limits is None:
            raise ValueError(
                f"init_mode={pso.init_mode!r} requires joint limits"
            )
        lo, hi = limits
        key, key_x = jax.random.split(key)
        x = jax.random.uniform(
            key_x, (s, num_particles, d), dtype=anchor_angles.dtype,
            minval=jnp.maximum(lo, -2 * jnp.pi), maxval=jnp.minimum(hi, 2 * jnp.pi),
        )
        if pso.init_mode == "hybrid":
            x = x.at[:, 0, :].set(anchor_angles)
    else:
        x = jnp.broadcast_to(anchor_angles[:, None, :], (s, num_particles, d))
    v = jax.random.uniform(
        key,
        (s, num_particles, d),
        dtype=anchor_angles.dtype,
        minval=-pso.init_velocity_scale,
        maxval=pso.init_velocity_scale,
    )
    lbest = x
    lbest_val = fitness_fn(x)
    gbest_val, gbest = _swarm_argmin(lbest_val, lbest)
    if gbest_reduce is not None:
        gbest_val, gbest = gbest_reduce(gbest_val, gbest)
    return x, v, lbest, lbest_val, gbest, gbest_val


def solve(
    spec: ChainSpec,
    problem: IKProblem,
    key: jnp.ndarray,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    fitness_fn: Optional[FitnessFn] = None,
    gbest_reduce: Optional[GbestReduce] = None,
    vary_axes: Tuple[str, ...] = (),
) -> SolveResult:
    """Solve a batch of IK problems with PSO. Jit-compatible end to end.

    ``problem`` must carry exactly one leading swarm axis (shape
    ``(S, ...)``); use :func:`solve_single` for a lone problem.
    Custom ``fitness_fn`` overrides the jnp fitness (e.g. the
    megakernel's fitness, ``ikpso.pso.fused.kernel_fitness``).
    """
    anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)  # (S, D)
    if anchor_angles.ndim != 2:
        raise ValueError(
            "solve() expects a single leading swarm axis; got pose shape "
            f"{problem.pose.shape}. Use solve_single() for unbatched problems."
        )

    if fitness_fn is None:
        anchor_positions = fk_ops.fk_points(spec, problem.pose, problem.origin)

        def fitness_fn(x):
            return fitness(
                spec,
                x,
                problem,
                config=fit,
                obstacles=obstacles,
                anchor_angles=anchor_angles,
                anchor_positions=anchor_positions,
            )

    # Per-node limits -> per-DOF clamp bounds, broadcast over (S, P, D).
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)

    key_init, key_loop = jax.random.split(key)
    x0, v0, lbest0, lbest_val0, gbest0, gbest_val0 = init_swarm(
        key_init, anchor_angles, num_particles, fitness_fn, pso, gbest_reduce,
        limits=(lo, hi),
    )
    if vary_axes:
        # Under shard_map with a sharded particle axis, the warm-start
        # state is device-invariant (broadcast anchor) but becomes
        # device-varying after one iteration of per-shard randomness;
        # mark the carry as varying up front so the scan types match.
        def _ensure_varying(t):
            vma = getattr(jax.typeof(t), "vma", frozenset())
            missing = tuple(a for a in vary_axes if a not in vma)
            if missing:
                t = jax.lax.pcast(t, missing, to="varying")
            return t

        x0, v0, lbest0, lbest_val0 = (
            _ensure_varying(t) for t in (x0, v0, lbest0, lbest_val0)
        )
    state = (x0, v0, lbest0, lbest_val0, gbest0, gbest_val0)

    def body(carry, inputs):
        it_key, it = inputs
        x, v, lbest, lbest_val, gbest, gbest_val = carry
        new = pso_iteration(
            x, v, lbest, lbest_val, gbest, gbest_val,
            it_key, fitness_fn, lo, hi, pso, gbest_reduce, iteration=it,
        )
        return new, new[5]  # trace gbest_val

    it_keys = jax.random.split(key_loop, pso.iterations)
    (x, v, lbest, lbest_val, gbest, gbest_val), trace = jax.lax.scan(
        body, state, (it_keys, jnp.arange(pso.iterations))
    )
    trace = jnp.concatenate([state[5][None], trace], axis=0)

    solved_pose = fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], gbest)
    err = true_effector_error(spec, solved_pose, problem)
    return SolveResult(
        angles=gbest,
        fitness=gbest_val,
        pose=solved_pose,
        effector_error=err,
        trace=trace,
    )


def solve_single(
    spec: ChainSpec,
    problem: IKProblem,
    key: jnp.ndarray,
    **kwargs,
) -> SolveResult:
    """Solve one unbatched IK problem (adds/strips the swarm axis)."""
    batched = jax.tree.map(lambda x: x[None], problem)
    res = solve(spec, batched, key, **kwargs)
    return jax.tree.map(lambda x: x[0] if x.ndim > 0 and x.shape[0] == 1 else x[:, 0], res)


def make_solver(
    spec: ChainSpec,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    fitness_fn: Optional[FitnessFn] = None,
    gbest_reduce: Optional[GbestReduce] = None,
):
    """A jitted ``(problem, key) -> SolveResult`` closure.

    Shapes (S, P, D) are static per trace; re-tracing happens per
    ChainSpec topology / particle count — the XLA replacement for the
    reference's compile-time ``DEGREES_OF_FREEDOM`` (ik_constants.h:2).
    """

    @jax.jit
    def _solve(problem: IKProblem, key: jnp.ndarray) -> SolveResult:
        return solve(
            spec,
            problem,
            key,
            pso=pso,
            fit=fit,
            obstacles=obstacles,
            num_particles=num_particles,
            fitness_fn=fitness_fn,
            gbest_reduce=gbest_reduce,
        )

    return _solve
