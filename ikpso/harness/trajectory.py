"""Trajectory sweeps: thousands of waypoints as batched swarms.

BASELINE config 5: "10k waypoints solved as independent swarms across
several hosts". Waypoints are chunked into fixed-size batches
(static shapes per jit trace), each batch is one batched solve, and
progress checkpoints to npz so a preempted sweep resumes at the last
finished batch (SURVEY.md §5 checkpoint/resume plan).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso.models.library import batched_problem
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig
from ikpso.pso.solver import make_solver
from ikpso.utils import checkpoint as ckpt


@dataclasses.dataclass
class SweepResult:
    angles: np.ndarray  # (W, D)
    errors: np.ndarray  # (W,)
    solves_per_second: float


@dataclasses.dataclass
class TrackResult:
    """Output of :func:`track_trajectories`."""

    angles: np.ndarray  # (T, S, D)
    errors: np.ndarray  # (T, S) true effector error per step
    final_pose: np.ndarray  # (S, N, 3)
    solves_per_second: float
    wall_time_s: float


def _build_solver(spec, pso, fit, obstacles, num_particles, impl):
    if impl == "fused":
        from ikpso.pso.fused import make_fused_solver

        return make_fused_solver(
            spec, pso=pso, fit=fit, obstacles=obstacles,
            num_particles=num_particles,
        )
    return make_solver(
        spec, pso=pso, fit=fit, obstacles=obstacles,
        num_particles=num_particles,
    )


def track_trajectories(
    spec: ChainSpec,
    problem: IKProblem,
    path: np.ndarray,
    key: jnp.ndarray,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    impl: str = "jnp",
    polish: int = 0,
    timeit: bool = False,
    mesh=None,
) -> TrackResult:
    """Track S moving targets over T steps, fully on device.

    The reference's animation loop re-solves every rendered frame as
    the targets move, warm-starting each solve from the pose the
    previous frame produced (reference Main.cpp:222-227: ToCUDA ->
    calculatePSO -> FromCoords, with host marshaling between every
    frame). Here the WHOLE trajectory is one jitted XLA program:
    ``lax.scan`` over the T path steps with the solver in the body,
    the solved pose chained as the next step's warm start and
    locality anchor — S independent trajectories advance in lockstep
    with zero host round-trips between frames.

    Args:
      path: ``(T, S, E, 3)`` target positions per step and trajectory.
      polish: K LM steps per frame on each gbest, gated on the
        locality-aware cost (pso/polish.py) so tracked motion stays
        animation-smooth.
      timeit: run the compiled program twice and report steady-state
        wall time (first call includes compilation).
      mesh: optional device mesh — the trajectory (S) axis shards over
        its swarm axis, so N devices track N times the trajectories in
        the same wall time; the scan chain stays per-shard (zero
        cross-device communication between steps).
    """
    path = jnp.asarray(path, jnp.float32)
    t = path.shape[0]
    base = batched_problem(problem, path[0])
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from ikpso.parallel.mesh import SWARM_AXIS
        from ikpso.parallel.sharded import make_sharded_solver

        solver = make_sharded_solver(
            spec, mesh, pso=pso, fit=fit, obstacles=obstacles,
            num_particles=num_particles, impl=impl,
        )
        path = jax.device_put(
            path,
            NamedSharding(mesh, PartitionSpec(None, SWARM_AXIS)),
        )
        base = jax.device_put(
            base, NamedSharding(mesh, PartitionSpec(SWARM_AXIS))
        )
    else:
        solver = _build_solver(
            spec, pso, fit, obstacles, num_particles, impl,
        )
    if polish:
        from ikpso.pso.polish import wrap_with_polish

        solver = wrap_with_polish(
            solver, spec, steps=polish,
            locality_weight=float(np.asarray(fit.angle_weight))
            / max(1, spec.dof // 3),
            obstacles=obstacles,
            collision_backend=fit.collision_backend,
            collision_shape=fit.collision_shape,
            gizmo_size=fit.gizmo_size,
        )

    @jax.jit
    def run(pose0, path, key):
        keys = jax.random.split(key, t)

        def body(pose, xs):
            tgt, k = xs
            res = solver(base.replace(pose=pose, targets=tgt), k)
            return res.pose, (res.angles, res.effector_error)

        final_pose, (angles, errors) = jax.lax.scan(
            body, pose0, (path, keys)
        )
        return final_pose, angles, errors

    start = time.perf_counter()
    out = run(base.pose, path, key)
    out = jax.block_until_ready(out)
    wall = time.perf_counter() - start
    if timeit:
        start = time.perf_counter()
        out = jax.block_until_ready(run(base.pose, path, key))
        wall = time.perf_counter() - start
    final_pose, angles, errors = out
    errors_np = np.asarray(errors)
    if not np.isfinite(errors_np).all():
        import warnings

        bad = int((~np.isfinite(errors_np)).sum())
        warnings.warn(
            f"track_trajectories: {bad} non-finite step errors",
            stacklevel=2,
        )
    solves = int(t * path.shape[1])
    return TrackResult(
        angles=np.asarray(angles),
        errors=errors_np,
        final_pose=np.asarray(final_pose),
        solves_per_second=solves / wall if wall > 0 else float("inf"),
        wall_time_s=wall,
    )


def follow_targets(
    spec: ChainSpec,
    problem: IKProblem,
    updates,
    key: jnp.ndarray,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    impl: str = "jnp",
    polish: int = 0,
):
    """Streaming re-solve loop over externally-fed target updates.

    The honest analog of the reference's interactive manipulation
    loop (reference Main.cpp:401-453: the user drags a target gizmo —
    or the arm BASE with the arrow keys, which move the origin node's
    position — and every frame re-solves from the pose the previous
    frame produced). Where :func:`track_trajectories` requires the
    whole path up front (one scan-chained XLA program),
    this is the ONLINE form: ``updates`` is any iterator arriving one
    item at a time — a UI, a file tail, a socket. Each item is either
    an ``(E, 3)`` (or ``(S, E, 3)``) target array, or a dict with any
    of the keys ``"targets"`` (same shapes) and ``"origin"`` (``(3,)``
    or ``(S, 3)`` base world translation — the arrow-key arm drag).
    Omitted fields keep their previous value; an origin-only first
    update solves for ``problem.targets``. The solver compiles ONCE
    (first step); every later step is a single warm-started dispatch
    re-using the previous solved pose as init and locality anchor,
    exactly like the scan body (origin and targets are data, so base
    moves never retrace).

    Yields one dict per consumed update:
    ``{step, effector_error, angles, wall_ms}`` (error/angles are
    numpy, wall is the blocking dispatch time — steady-state after
    step 0's compile).
    """
    import time as _time

    solver = _build_solver(
        spec, pso, fit, obstacles, num_particles, impl,
    )
    if polish:
        from ikpso.pso.polish import wrap_with_polish

        solver = wrap_with_polish(
            solver, spec, steps=polish,
            locality_weight=float(np.asarray(fit.angle_weight))
            / max(1, spec.dof // 3),
            obstacles=obstacles,
            collision_backend=fit.collision_backend,
            collision_shape=fit.collision_shape,
            gizmo_size=fit.gizmo_size,
        )
    base = None
    pose = None
    prev_angles = None
    for step, upd in enumerate(updates):
        if isinstance(upd, dict):
            tgt, origin = upd.get("targets"), upd.get("origin")
        else:
            tgt, origin = upd, None
        if tgt is not None:
            tgt = jnp.asarray(tgt, jnp.float32)
            if tgt.ndim == 2:
                tgt = tgt[None]
        if base is None:
            base = batched_problem(
                problem,
                tgt
                if tgt is not None
                else jnp.asarray(problem.targets, jnp.float32)[None],
            )
            pose = base.pose
        if tgt is not None:
            base = base.replace(targets=tgt)
        if origin is not None:
            o = jnp.asarray(origin, jnp.float32)
            base = base.replace(
                origin=jnp.broadcast_to(o, base.origin.shape)
            )
        key, k = jax.random.split(key)
        t0 = _time.perf_counter()
        res = solver(base.replace(pose=pose), k)
        res = jax.block_until_ready(res)
        wall = _time.perf_counter() - t0
        pose = res.pose
        angles = np.asarray(res.angles)
        out = dict(
            step=step,
            effector_error=np.asarray(res.effector_error),
            angles=angles,
            wall_ms=wall * 1e3,
        )
        if prev_angles is not None:
            out["angle_delta_max"] = float(
                np.abs(angles - prev_angles).max()
            )
        prev_angles = angles
        yield out


def circle_paths(
    targets: np.ndarray,
    steps: int,
    num_paths: int,
    *,
    radius: float = 0.25,
    revolutions: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """(T, S, E, 3) circular target paths starting AT the base targets.

    Each trajectory orbits every effector target around its base
    position in the XY plane with a per-trajectory random phase, so the
    S trajectories are decorrelated. Step 0 equals the base targets
    (offset zero), matching the warm-start assumption that the initial
    pose is near-solving.
    """
    targets = np.asarray(targets, np.float32)  # (E, 3)
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, size=(1, num_paths, 1))
    theta = np.linspace(
        0, 2 * np.pi * revolutions, steps, dtype=np.float64
    )[:, None, None]
    dx = radius * (np.cos(theta + phase) - np.cos(phase))
    dy = radius * (np.sin(theta + phase) - np.sin(phase))
    out = np.broadcast_to(
        targets[None, None], (steps, num_paths) + targets.shape
    ).copy()
    out[..., 0] += dx
    out[..., 1] += dy
    return out.astype(np.float32)


def solve_waypoints(
    spec: ChainSpec,
    problem: IKProblem,
    waypoints: np.ndarray,
    key: jnp.ndarray,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    batch_size: int = 256,
    checkpoint_path: Optional[str] = None,
    mesh=None,
    impl: str = "jnp",
    retries: int = 0,
    retry_init_mode: Optional[str] = None,
    retry_iterations: Optional[int] = None,
    retry_err_threshold: float = 1e-3,
    polish: int = 0,
) -> SweepResult:
    """Solve every waypoint (W, E, 3) as an independent swarm.

    With ``mesh`` given, each batch is solved via the sharded path
    (swarm axis across devices); otherwise single-device batched.
    Each waypoint warm-starts from ``problem.pose`` — independent
    solves, retryable by construction. ``retries`` wraps the solver in
    the jitted top-k retry (re-solve the worst eighth of each batch up
    to N rounds — production tail hardening, pso/restarts.py);
    ``retry_init_mode`` (e.g. ``"uniform"``/``"hybrid"``) gives the
    retry rounds a different swarm init, de-correlating wrong-basin
    retries from the failed warm basin.
    ``polish`` adds K LM steps on each waypoint's gbest through the
    differentiable FK (pso/polish.py; accept-if-better per waypoint).
    """
    waypoints = np.asarray(waypoints, np.float32)
    w = waypoints.shape[0]
    dof = spec.dof

    state = ckpt.load(checkpoint_path) if checkpoint_path else None
    if state is None or state.angles.shape != (w, dof):
        state = ckpt.fresh_state(w, dof, key)

    def build(pso_cfg):
        if mesh is None:
            sv = _build_solver(
                spec, pso_cfg, fit, obstacles, num_particles, impl,
            )
        else:
            from ikpso.parallel.sharded import make_sharded_solver

            sv = make_sharded_solver(
                spec,
                mesh,
                pso=pso_cfg,
                fit=fit,
                obstacles=obstacles,
                num_particles=num_particles,
                impl=impl,
            )

        if polish:
            from ikpso.pso.polish import wrap_with_polish

            sv = wrap_with_polish(
                sv, spec, steps=polish, obstacles=obstacles,
                collision_backend=fit.collision_backend,
                collision_shape=fit.collision_shape,
                gizmo_size=fit.gizmo_size,
            )
        return sv

    from ikpso.pso.restarts import wrap_with_topk_retries

    solver = wrap_with_topk_retries(
        build, pso, rounds=retries, bucket=max(1, batch_size // 8),
        err_threshold=retry_err_threshold, retry_init_mode=retry_init_mode,
        retry_iterations=retry_iterations,
    )

    run_key = state.key
    start = time.perf_counter()
    solved = 0
    cursor = state.cursor
    while cursor < w:
        end = min(cursor + batch_size, w)
        chunk = waypoints[cursor:end]
        # Pad the tail chunk to the static batch size.
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        batch = batched_problem(problem, jnp.asarray(chunk))
        run_key, sub = jax.random.split(run_key)
        res = solver(batch, sub)
        from ikpso.utils.guards import check_solve_result

        check_solve_result(res, context=f"waypoints {cursor}:{end}")
        n = end - cursor
        state.angles[cursor:end] = np.asarray(res.angles)[:n]
        state.errors[cursor:end] = np.asarray(res.effector_error)[:n]
        solved += n
        cursor = end
        state = dataclasses.replace(
            state,
            cursor=cursor,
            key_data=np.asarray(jax.random.key_data(run_key)),
        )
        if checkpoint_path:
            ckpt.save(checkpoint_path, state)
    wall = time.perf_counter() - start

    return SweepResult(
        angles=state.angles,
        errors=state.errors,
        solves_per_second=solved / wall if wall > 0 and solved else 0.0,
    )
