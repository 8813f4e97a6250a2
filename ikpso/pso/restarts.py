"""Retry failed solves: the guaranteed fix for premature convergence.

Short PSO stages with small swarms leave a small tail of
prematurely-converged swarms — stuck local minima, not precision
limits. Because every solve is stateless and independent, the
cheapest rescue is a *fresh independent sample*: re-solve only the
failed swarms with a new RNG key and keep the better result per swarm.
With a per-solve failure rate p, k retry rounds leave a p^(k+1) tail
(1.6% -> ~0.03% after one round) for ~p extra compute.

Static shapes: the failed subset's size is data-dependent, so
failures are gathered into a FIXED-size bucket (padded by repeating
the first failed index) — one extra compiled program per bucket size
rather than one per failure count. Gather/scatter runs on host via
numpy between the two jitted solves; the solves themselves stay
device-resident.

The reference has no equivalent (its only retry is the human pressing
R again, Main.cpp:412-418); this is the production hardening layer on
top of the same PSO.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models.chain import IKProblem
from ikpso.pso.solver import SolveResult

Solver = Callable[[IKProblem, jnp.ndarray], SolveResult]


def _gather_problem(problem: IKProblem, idx: np.ndarray) -> IKProblem:
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[idx]), problem)


def _scatter_better(
    base: SolveResult, retry: SolveResult, idx: np.ndarray, take: np.ndarray
) -> SolveResult:
    """Write retry results back into base where ``take`` (over the
    bucket) marks an improvement. Duplicated padding indices are safe:
    only true failure slots can improve, and np writes of identical
    best-rows are idempotent."""
    sel = idx[take]
    if sel.size == 0:
        return base

    def merge(b, r):
        b = np.asarray(b).copy()
        b[sel] = np.asarray(r)[take]
        return jnp.asarray(b)

    return SolveResult(
        angles=merge(base.angles, retry.angles),
        fitness=merge(base.fitness, retry.fitness),
        pose=merge(base.pose, retry.pose),
        effector_error=merge(base.effector_error, retry.effector_error),
        trace=base.trace,
    )


def solve_with_retries(
    solver: Solver,
    problem: IKProblem,
    key: jnp.ndarray,
    *,
    err_threshold: float = 1e-3,
    max_rounds: int = 1,
    bucket: int = 1024,
    retry_solver: Optional[Solver] = None,
) -> SolveResult:
    """Base solve + up to ``max_rounds`` retry rounds on failed swarms.

    Args:
      solver: the batched base solver (e.g. ``make_fused_solver(...)``).
      err_threshold: true-effector-error bound defining failure
        (1e-3 units = 1 mm at metre scale, matching BASELINE's <1mm).
      bucket: fixed retry batch size — failures are gathered into
        ``ceil(n/bucket)`` padded chunks, each one jitted program.
      retry_solver: optional distinct solver for retries (e.g. more
        iterations or a bigger swarm for the hard cases); defaults to
        ``solver``.
    """
    res = solver(problem, key)
    retry_solver = retry_solver or solver
    bucket = max(1, min(bucket, int(problem.batch_shape()[0])))
    for _ in range(max_rounds):
        err = np.asarray(res.effector_error)
        failed = np.flatnonzero(err > err_threshold)
        if failed.size == 0:
            break
        for start in range(0, failed.size, bucket):
            chunk = failed[start:start + bucket]
            idx = np.full((bucket,), chunk[0], dtype=np.int64)
            idx[: chunk.size] = chunk
            key, sub = jax.random.split(key)
            retry = retry_solver(_gather_problem(problem, idx), sub)
            take = np.asarray(retry.effector_error) < np.asarray(
                res.effector_error
            )[idx]
            # Padding duplicates the first failed index; keep only the
            # first occurrence so duplicate writes cannot race.
            first = np.zeros((bucket,), bool)
            first[np.unique(idx, return_index=True)[1]] = True
            res = _scatter_better(res, retry, idx, take & first)
    return res


def make_retry_solver(solver: Solver, **retry_kwargs) -> Solver:
    """Wrap a batched solver with :func:`solve_with_retries`."""

    def _solve(problem: IKProblem, key: jnp.ndarray) -> SolveResult:
        return solve_with_retries(solver, problem, key, **retry_kwargs)

    return _solve


def wrap_solver_with_target_walk(
    solver: Solver, spec, steps: int, jitter: float = 0.0
) -> Solver:
    """Re-solve via a W-step warm target walk instead of one jump.

    The reference's own protocol for far targets is not a single-shot
    solve: its interactive loop re-solves EVERY frame as the target
    moves, each frame warm-started from the previous solution
    (reference Main.cpp:222-227). This wrapper runs that protocol as
    one jitted program: interpolate the targets from the CURRENT
    pose's effector positions to the true targets in ``steps`` equal
    fractions, re-solving warm at each step (``lax.scan`` over the
    walk, the final step exactly at the true targets). Each step is a
    small target jump in the easy warm regime — the measured fix for
    basins that resist dozens of independent cold restarts (the
    45-DOF humanoid, whose single-shot solve plateaus short of 100%
    under every retry escalation). Orientation targets (if any) are held
    fixed at the true values — only positions walk; the reference's
    drag loop has no orientation either.

    Used as a RETRY solver (``wrap_with_topk_retries(...,
    retry_walk_steps=W)``): the failed bucket gets a W-step walk from
    its warm-start pose instead of another cold restart. (NOT from the
    current best: walking from a failed swarm's best pose anchors the
    warm start inside the wrong basin it is stuck in; the canonical-pose
    walk is the escape mechanism.)

    ``jitter`` > 0 varies the PATH per call: each intermediate
    waypoint gets a random offset drawn from that step's key, scaled
    by the per-effector start-to-target distance and annealed to zero
    at both endpoints (4f(1-f)) — so retry round k walks a different
    CURVED path than round k-1 while still starting canonical and
    ending exactly at the true targets — for straight-line-infeasible
    target sets (a straight interpolation can exit the reachable set; a
    curve can go around).
    """
    if steps < 1:
        raise ValueError(f"target walk needs steps >= 1, got {steps}")

    from ikpso.ops.fk import fk_points

    def _solve(problem: IKProblem, key: jnp.ndarray) -> SolveResult:
        keys = jax.random.split(key, steps)
        if steps > 1:
            start = fk_points(spec, problem.pose, problem.origin)[
                :, list(spec.effector_idx), :
            ]
            fracs = (
                jnp.arange(1, steps, dtype=jnp.float32) / float(steps)
            )
            span = jnp.linalg.norm(
                problem.targets - start, axis=-1, keepdims=True
            )

            def body(pose, xs):
                f, k = xs
                tgt = start + f * (problem.targets - start)
                if jitter:
                    off = jax.random.normal(
                        jax.random.fold_in(k, 0x0FF5E7), start.shape
                    )
                    tgt = tgt + (jitter * 4.0 * f * (1.0 - f)) * span * off
                r = solver(problem.replace(pose=pose, targets=tgt), k)
                return r.pose, None

            pose, _ = jax.lax.scan(
                body, problem.pose, (fracs, keys[:-1])
            )
            problem = problem.replace(pose=pose)
        # Final step at the TRUE targets returns the full result (its
        # effector_error is scored against the real problem).
        return solver(problem, keys[-1])

    return _solve


def wrap_with_topk_retries(
    build,
    pso,
    *,
    rounds: int,
    bucket: int,
    err_threshold: float = 1e-3,
    retry_init_mode: Optional[str] = None,
    retry_iterations: Optional[int] = None,
    spec=None,
    retry_walk_steps: int = 0,
    retry_walk_jitter: float = 0.0,
    bucket_decay: int = 1,
) -> Solver:
    """Build a solver and wrap it in jitted top-k retries.

    ``build(pso_config) -> Solver`` constructs the (possibly
    polish-wrapped) solver; when ``retry_init_mode`` differs from the
    base config's init, the retry rounds get their OWN solver with
    that init — a warm retry with fresh RNG tends to land back in the
    failed basin, while a uniform/hybrid retry re-explores globally.
    ``retry_iterations`` likewise deepens only the retry rounds' PSO
    budget: the failed
    bucket is a small fraction of the batch, so a much deeper re-solve
    costs little (the wrong-basin tail-closing tool).

    ``bucket_decay=k`` shrinks the bucket k-fold each round (floored
    at 1024): round 1 covers the base failure set, later rounds chase
    the geometrically-shrinking residue with matched compute (see
    :func:`make_topk_retry_solver`). 1 = the constant-bucket behavior.

    ``retry_walk_steps=W`` (requires ``spec``) makes each retry round
    a W-step warm TARGET WALK (:func:`wrap_solver_with_target_walk`)
    from the problem's warm-start pose — the canonical-to-goal walk
    protocol — instead of an independent re-solve: the tail-closing
    tool for basins that resist cold restarts (45-DOF humanoid). The
    walk needs its warm start intact, so ``retry_init_mode`` is
    ignored when a walk is requested (a uniform/hybrid init would
    discard exactly the pose each step warms from).
    """
    solver = build(pso)
    if not rounds:
        return solver
    retry_solver = None
    retry_cfg = {}
    if retry_walk_steps and spec is None:
        raise ValueError("retry_walk_steps requires spec")
    if retry_init_mode and retry_init_mode != pso.init_mode \
            and not retry_walk_steps:
        retry_cfg["init_mode"] = retry_init_mode
    if retry_iterations and retry_iterations != pso.iterations:
        retry_cfg["iterations"] = retry_iterations
        if pso.rekick_interval and retry_iterations % pso.rekick_interval:
            retry_cfg["rekick_interval"] = 0
    if retry_cfg:
        retry_solver = build(dataclasses.replace(pso, **retry_cfg))
    if retry_walk_steps:
        retry_solver = wrap_solver_with_target_walk(
            retry_solver or solver, spec, retry_walk_steps,
            jitter=retry_walk_jitter,
        )
    if bucket_decay > 1:
        buckets = [
            max(min(bucket, 1024), bucket // bucket_decay**r)
            for r in range(rounds)
        ]
    else:
        buckets = bucket
    return make_topk_retry_solver(
        solver, err_threshold=err_threshold, rounds=rounds, bucket=buckets,
        retry_solver=retry_solver,
    )


def make_topk_retry_solver(
    solver: Solver,
    *,
    bucket=1024,
    err_threshold: float = 1e-3,
    rounds: int = 1,
    retry_solver: Optional[Solver] = None,
    retry_start: str = "problem",
) -> Solver:
    """Fully-jitted retry: base solve + re-solve of the ``bucket``
    WORST swarms, merged on device — one XLA program, zero host syncs.

    Where :func:`solve_with_retries` gathers the exact failure set on
    the host (general, but each round pays host<->device round-trips),
    this picks the top-``bucket`` worst swarms
    with a device-side ``argsort``: the shapes are static, the whole
    base+retry+merge pipeline jits into a single dispatch, and the only
    cost is always re-solving ``bucket`` swarms (~bucket/S extra
    compute) whether or not they all failed. The ``err_threshold``
    guard keeps already-converged swarms' results bit-stable.

    ``bucket`` may be a sequence of per-round sizes: the failure count
    shrinks geometrically with each round (each round's fresh solve
    fails independently at the base rate), so matched shrinking
    buckets deliver the same coverage for a fraction of the re-solve
    compute.

    The reference's analog would be "run the kernel again on the worst
    problems" — impossible to express without host logic in its
    architecture (SURVEY.md §3.3); here it is three extra XLA ops.
    """
    retry_solver_ = retry_solver or solver
    buckets = (
        [int(bucket)] * rounds
        if np.ndim(bucket) == 0
        else [int(b) for b in bucket]
    )
    if len(buckets) < rounds:
        buckets += [buckets[-1]] * (rounds - len(buckets))

    def _solve(problem: IKProblem, key: jnp.ndarray) -> SolveResult:
        # Base solve consumes the caller's key unchanged, so the
        # wrapper is a strict superset of the bare solver (same base
        # trajectory); retry streams derive via fold_in.
        res = solver(problem, key)
        s = res.effector_error.shape[0]
        out = res
        k2 = jax.random.fold_in(key, 0x7e7)
        for rnd in range(rounds):
            b = min(buckets[rnd], s)
            k2, ks = jax.random.split(k2)
            worst = jax.lax.top_k(out.effector_error, b)[1]
            # retry_start="problem" (default): retry from the ORIGINAL
            # warm pose. Retrying "from the current best" regresses both
            # retry flavors: a failed swarm's best pose is a wrong-basin
            # trap, and seeding the next attempt there re-converges into
            # the same trap instead of escaping on a fresh stream from
            # the canonical pose. The merge only accepts improvements,
            # so the cost is purely lost rescues. "best" stays available
            # for A/B.
            sub_problem = jax.tree.map(
                lambda x: jnp.take(x, worst, axis=0), problem
            )
            if retry_start == "best":
                sub_problem = sub_problem.replace(
                    pose=jnp.take(out.pose, worst, axis=0)
                )
            retry = retry_solver_(sub_problem, ks)
            prev_err = jnp.take(out.effector_error, worst)
            better = (retry.effector_error < prev_err) & (
                prev_err > err_threshold
            )
            # Route not-better rows out of bounds; "drop" makes the
            # scatter a no-op for them. `worst` indices are unique, so
            # kept writes cannot collide.
            safe = jnp.where(better, worst, s)

            def merge(base, new):
                # Not-better rows carry the out-of-bounds index and are
                # dropped, so scattering `new` directly is safe.
                return base.at[safe].set(new, mode="drop")

            out = SolveResult(
                angles=merge(out.angles, retry.angles),
                fitness=merge(out.fitness, retry.fitness),
                pose=merge(out.pose, retry.pose),
                effector_error=merge(out.effector_error, retry.effector_error),
                trace=out.trace,
            )
        return out

    return jax.jit(_solve)
