"""The reference's validation experiment, reproduced as a harness.

Protocol (reference Main.cpp:171-216, 330-337, SURVEY.md §4): reset
the arm to its canonical pose, move the targets to a fixed second set
(a ~0.5-unit target jump), then re-solve every frame — each solve
warm-started from the previous frame's result — until the summed true
Euclidean effector error drops to ``eps_dist`` (0.025 in the
reference, Main.cpp:134). The frames-to-converge count is the metric
published in the reference's three experiment reports
(Documentation/Iteration_{1,2,3}; BASELINE.md).

Batched twist: the reference runs one trial at a time in its render
loop; here T independent trials run as T parallel swarms of one
batched solve per frame — the frame loop is the only host iteration,
and it exists because each frame's warm start depends on the previous
frame's result (inherently sequential, like the reference).
"""

from __future__ import annotations

import dataclasses
import sys
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
from ikpso.utils.diagnostics import DiagnosticsWriter


@dataclasses.dataclass
class ExperimentResult:
    """Frames-to-converge statistics over all trials.

    ``frames`` is -1 for trials that hit ``max_frames`` unconverged.
    The avg/min/max fields mirror the reference reports' tables
    (Documentation/Iteration_3/Raport_3.tex:86-91).
    """

    frames: np.ndarray  # (trials,)
    final_error: np.ndarray  # (trials,)
    solves_per_second: float
    wall_time_s: float
    # Per-frame motion statistics over all pre-convergence frames of
    # all trials — the reference reports' other two tables ("angle
    # delta per DOF" / "node position delta", e.g.
    # Documentation/Iteration_3/Raport_3.tex:92-103). Keys avg/min/max.
    angle_delta: Optional[dict] = None
    pos_delta: Optional[dict] = None

    @property
    def converged(self) -> np.ndarray:
        return self.frames >= 0

    def summary(self) -> dict:
        ok = self.frames[self.converged]
        out = dict(
            trials=int(self.frames.size),
            converged=int(ok.size),
            frames_avg=float(ok.mean()) if ok.size else float("nan"),
            frames_min=int(ok.min()) if ok.size else -1,
            frames_max=int(ok.max()) if ok.size else -1,
            frames_std=float(ok.std()) if ok.size else float("nan"),
            solves_per_second=self.solves_per_second,
            wall_time_s=self.wall_time_s,
        )
        if self.angle_delta is not None:
            out["angle_delta"] = self.angle_delta
        if self.pos_delta is not None:
            out["pos_delta"] = self.pos_delta
        return out


def frames_to_converge(
    spec: ChainSpec,
    problem: IKProblem,
    reset_targets: jnp.ndarray,
    key: jnp.ndarray,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 16384,
    eps_dist: float = 0.025,
    max_frames: int = 300,
    trials: int = 32,
    diagnostics: Optional[DiagnosticsWriter] = None,
    impl: str = "jnp",
    validate: bool = True,
    trial_batch: Optional[int] = None,
    progress: bool = False,
    polish: int = 0,
    rng_mode: str = "independent",
    _session=None,
) -> ExperimentResult:
    """Run the reset->solve->converge experiment.

    Args:
      spec / problem: the arm and its canonical (default) pose — the
        state the reference's ``resetArm`` restores (Main.cpp:330-337).
      reset_targets: ``(E, 3)`` the post-reset target set the trials
        must reach.
      trials: number of independent trials, run as parallel swarms
        (each gets its own RNG stream; the reference reruns the same
        deterministic stream instead, SURVEY.md §2.4.5).
      diagnostics: optional 4-stream writer; logs trial 0's frames,
        matching the reference's single-run logging.
      trial_batch: cap on trials run as parallel swarms at once. A
        (trials, P, D) jnp swarm state OOMs a single chip past ~32
        trials at the reference's 16384x21 shape, so larger counts run
        as sequential batches (independent RNG streams) and merge —
        per-trial statistics are unaffected (trials never interact).
      rng_mode: ``"independent"`` (default) gives every frame a fresh
        split of the caller's key — trials/frames are independent
        draws. ``"session"`` is the reference-compat mode: ONE logical
        RNG stream advances across every frame AND every trial chunk
        of the whole call — the analog of the reference seeding
        its per-particle XORWOW states once at startup
        (utility_kernels.cuh:28,33-47, called once from Main.cpp:145)
        and letting them run continuously across all frames and
        logged trials of a data-gathering session. Implemented as
        ``fold_in(session_key, running_frame_counter)``; the counter
        continues across trial batches, so batch k's streams depend
        on how many frames batch k-1 consumed — like the reference's
        trial t starting where trial t-1's stream ended. (Tests the
        stream-continuation hypothesis for the iteration-2 parity
        delta.)

    Returns:
      ExperimentResult with per-trial frame counts (a trial's count is
      the number of solves until its error first reaches ``eps_dist``).
    """
    if rng_mode not in ("independent", "session"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if rng_mode == "session" and _session is None:
        _session = {"key": key, "counter": 0}
    if trial_batch is not None and trials > trial_batch:
        chunks = []
        remaining = trials
        while remaining > 0:
            n = min(remaining, trial_batch)
            key, sub = jax.random.split(key)
            chunks.append(
                frames_to_converge(
                    spec, problem, reset_targets, sub,
                    pso=pso, fit=fit, obstacles=obstacles,
                    num_particles=num_particles, eps_dist=eps_dist,
                    max_frames=max_frames, trials=n,
                    # Reference-style single-run logging: first batch only.
                    diagnostics=diagnostics if not chunks else None,
                    impl=impl, validate=validate, progress=progress,
                    polish=polish,
                    rng_mode=rng_mode, _session=_session,
                )
            )
            remaining -= n
            if progress:
                print(
                    f"[experiment] batch done: {trials - remaining}/{trials} "
                    f"trials", file=sys.stderr, flush=True,
                )
        wall = sum(c.wall_time_s for c in chunks)
        total = sum(c.solves_per_second * c.wall_time_s for c in chunks)

        def _merge(ds):
            ds = [d for d in ds if d]
            if not ds:
                return None
            n = sum(d["n"] for d in ds)
            return dict(
                avg=sum(d["avg"] * d["n"] for d in ds) / n,
                min=min(d["min"] for d in ds),
                max=max(d["max"] for d in ds),
                n=n,
            )

        return ExperimentResult(
            frames=np.concatenate([c.frames for c in chunks]),
            final_error=np.concatenate([c.final_error for c in chunks]),
            solves_per_second=total / wall if wall > 0 else float("inf"),
            wall_time_s=wall,
            angle_delta=_merge([c.angle_delta for c in chunks]),
            pos_delta=_merge([c.pos_delta for c in chunks]),
        )

    targets = jnp.broadcast_to(
        jnp.asarray(reset_targets, jnp.float32)[None],
        (trials,) + tuple(np.shape(reset_targets)),
    )
    batched = batched_problem(problem, targets)
    if impl == "fused":
        from ikpso.pso.fused import make_fused_solver

        solver = make_fused_solver(
            spec, pso=pso, fit=fit, obstacles=obstacles,
            num_particles=num_particles,
        )
    else:
        solver = make_solver(
            spec,
            pso=pso,
            fit=fit,
            obstacles=obstacles,
            num_particles=num_particles,
        )
    if polish:
        # Opt-in LM refinement per frame (pso/polish.py). Not part of
        # the reference-parity protocol: the reference has no local
        # refinement, so parity runs keep polish=0. The polish
        # objective mirrors the frame fitness: effector error plus the
        # angular-locality anchor at the reference's normalization
        # (kernel.cu:150), so per-frame motion stays animation-smooth.
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

    frames = np.full((trials,), -1, np.int64)
    final_error = np.full((trials,), np.inf, np.float64)
    done = np.zeros((trials,), bool)
    current = batched

    from ikpso.ops.fk import fk_points, pose_to_angles

    # Per-frame motion accumulators (reference degStream/posStream
    # analysis, Raport tables "angle delta per DOF" / "node position
    # delta"). Baselines: the canonical pose the trials reset from.
    prev_angles = np.asarray(pose_to_angles(spec, batched.pose))
    prev_pos = np.asarray(fk_points(spec, batched.pose, batched.origin))[:, 1:]
    d_stats = {"sum": 0.0, "n": 0, "min": np.inf, "max": -np.inf}
    p_stats = {"sum": 0.0, "n": 0, "min": np.inf, "max": -np.inf}

    def _acc(stats, vals):
        if vals.size:
            stats["sum"] += float(vals.sum())
            stats["n"] += int(vals.size)
            stats["min"] = min(stats["min"], float(vals.min()))
            stats["max"] = max(stats["max"], float(vals.max()))

    start = time.perf_counter()
    n_solves = 0
    for frame in range(1, max_frames + 1):
        if _session is not None:
            # Session stream: one continuously-advancing counter over
            # the whole call (all frames, all trial chunks).
            sub = jax.random.fold_in(_session["key"], _session["counter"])
            _session["counter"] += 1
        else:
            key, sub = jax.random.split(key)
        res = solver(current, sub)
        n_solves += 1
        if validate:
            from ikpso.utils.guards import check_solve_result

            check_solve_result(res, context=f"frame {frame}")
        err = np.asarray(res.effector_error)
        final_error = np.where(done, final_error, err)

        # Motion deltas for still-active trials (the reference logs
        # every frame up to and including the converging one).
        angles_np = np.asarray(res.angles)
        pos_np = np.asarray(fk_points(spec, res.pose, batched.origin))[:, 1:]
        active = ~done
        _acc(d_stats, np.abs(angles_np - prev_angles)[active])
        _acc(p_stats, np.linalg.norm(pos_np - prev_pos, axis=-1)[active])
        prev_angles, prev_pos = angles_np, pos_np

        if diagnostics is not None and not done[0]:
            diagnostics.log_frame(angles_np[0], pos_np[0], float(err[0]))

        newly = (~done) & (err <= eps_dist)
        frames[newly] = frame
        if progress and (frame % 25 == 0 or newly.any()):
            print(
                f"[experiment] frame {frame}: {int((done | newly).sum())}/"
                f"{trials} converged", file=sys.stderr, flush=True,
            )
        if diagnostics is not None and newly[0]:
            diagnostics.log_convergence(frame)
        done |= newly
        if done.all():
            break
        # Warm start next frame from this frame's solution (the
        # reference's FromCoords step, Main.cpp:227). Converged trials
        # keep solving harmlessly (their pose is already at target).
        current = dataclasses.replace(current, pose=res.pose)
    wall = time.perf_counter() - start

    def _final(stats):
        if not stats["n"]:
            return None
        return dict(
            avg=stats["sum"] / stats["n"], min=stats["min"], max=stats["max"],
            n=stats["n"],
        )

    return ExperimentResult(
        frames=frames,
        final_error=final_error,
        solves_per_second=(n_solves * trials) / wall if wall > 0 else float("inf"),
        wall_time_s=wall,
        angle_delta=_final(d_stats),
        pos_delta=_final(p_stats),
    )


def run_reference_experiment(
    key=None,
    *,
    trials: int = 32,
    num_particles: int = 16384,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    eps_dist: float = 0.025,
    max_frames: int = 300,
    diagnostics: Optional[DiagnosticsWriter] = None,
    trial_batch: int = 32,
) -> ExperimentResult:
    """The exact shipped-code experiment: 21-DOF arm, 16384 particles,
    15 randomized-inertia iterations, angle_weight 3.0, eps 0.025.

    ``trial_batch`` bounds how many trials run as parallel swarms at
    once (see :func:`frames_to_converge`).
    """
    from ikpso.models.library import reference_arm, reference_reset_targets

    if key is None:
        key = jax.random.key(0)
    spec, problem = reference_arm()
    return frames_to_converge(
        spec,
        problem,
        reference_reset_targets(),
        key,
        pso=pso,
        fit=fit,
        num_particles=num_particles,
        eps_dist=eps_dist,
        max_frames=max_frames,
        trials=trials,
        diagnostics=diagnostics,
        trial_batch=trial_batch,
    )
