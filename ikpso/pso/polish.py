"""Gauss-Newton / Levenberg-Marquardt polish of PSO solutions.

A capability the reference cannot express: its fitness is a CUDA
kernel, opaque to differentiation, so the only way to sharpen a
solution is more PSO iterations (reference kernel.cu:307-323 just
loops the stochastic update). Here FK is a JAX program, so the exact
Jacobian of the effector residuals w.r.t. the joint angles is
available in closed form (ops/jacobian.py) — and a handful of
damped-least-squares steps on the *single* gbest point per swarm
replaces the tail of the PSO run at ~1/P of the cost per step
(P particles no longer participate).

Division of labor: PSO (global, stochastic) finds the basin in ~half
the iterations it would need to also polish; LM (local, quadratic)
drives the residual to float32 rounding in 3-6 steps. Per-swarm
accept-if-better gating makes the stage monotonic — a swarm whose
polish diverges (wrong basin, joint-limit wall, gimbal point) keeps
its PSO answer, so ``wrap_with_polish`` can never hurt.

Why no autodiff / no LAPACK in the hot path: ``jacfwd`` costs D
tangent FK passes, and batched ``jnp.linalg.solve`` on tiny (M, M)
systems is a pivoted-LU loop per system. The analytic Jacobian is one
FK pass of cross products, and the normal equations are solved by an
unrolled static-size Cholesky: pure elementwise ops over the swarm
axis. ``jacfwd`` remains the oracle in tests.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ikpso.models.chain import ChainSpec, IKProblem
from ikpso.ops import fk as fk_ops
from ikpso.ops.jacobian import fk_with_jacobian
from ikpso.ops.rotations import euler_xyz_to_matrix


def _vee_residual(re, rt_mat, weight):
    """World-frame rotation-vector residual per effector.

    ``0.5 * vee(M - M^T)`` with ``M = R_fk @ R_target^T`` — the
    sin(theta)-scaled world rotation axis, zero exactly at alignment,
    whose Jacobian w.r.t. joint angles is (+)the world rotation axes
    of the joints (ops/jacobian.py orientation rows).
    """
    m = jnp.einsum("...eij,...ekj->...eik", re, rt_mat, precision="highest")
    vee = 0.5 * jnp.stack(
        [
            m[..., 2, 1] - m[..., 1, 2],
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 1, 0] - m[..., 0, 1],
        ],
        axis=-1,
    )
    return jnp.sqrt(weight) * vee


def _residual_fn(spec: ChainSpec, use_orientation: bool,
                 orientation_weight: float):
    """Unbatched residual: (D,) angles -> (M,) weighted residual vector.

    Position rows are ``sqrt(w_e) * (fk_pos - target)`` per effector —
    so ``|r|^2`` equals the reference's weighted squared effector cost
    (reference kernel.cu:139-146). This is the ``jacfwd`` oracle for
    the analytic path below (tests/test_jacobian.py).
    """
    eff = list(spec.effector_idx)
    w_pos = jnp.sqrt(spec.effector_weight[jnp.array(eff)])

    def residual(angles, root_rot, origin, targets, target_rot):
        pose = fk_ops.angles_to_pose(spec, root_rot, angles)
        pos, rot = fk_ops.fk(spec, pose, origin)
        r = (pos[eff, :] - targets) * w_pos[:, None]  # (E, 3)
        parts = [r.reshape(-1)]
        if use_orientation:
            rt = euler_xyz_to_matrix(target_rot)  # (E, 3, 3)
            parts.append(
                _vee_residual(rot[eff, :, :], rt, orientation_weight)
                .reshape(-1)
            )
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    return residual


def _chol_solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD solve via unrolled static-size Cholesky.

    ``a`` is ``(..., M, M)`` SPD (damped normal matrix), ``b`` is
    ``(..., M)``. Unrolling over the static M keeps every operation
    elementwise over the batch — no pivoted-LU loop per tiny system.
    """
    m = a.shape[-1]
    low = [[None] * m for _ in range(m)]
    for i in range(m):
        for jc in range(i + 1):
            s = a[..., i, jc]
            for k in range(jc):
                s = s - low[i][k] * low[jc][k]
            if i == jc:
                low[i][jc] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                low[i][jc] = s / low[jc][jc]
    y = [None] * m
    for i in range(m):
        s = b[..., i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return jnp.stack(x, axis=-1)


def _batched_residual(spec, problem, use_orientation, orientation_weight,
                      locality_weight):
    """Batched residual closure ``(S, D) -> (S, M)`` for a problem.

    Row blocks: weighted effector position error; optional world-frame
    rotation-vector error; optional Tikhonov locality anchor
    (see :func:`polish_angles`).
    """
    eff = list(spec.effector_idx)
    w_pos = jnp.sqrt(spec.effector_weight[jnp.array(eff)])
    root_rot = problem.pose[..., 0, :]
    origin = problem.origin
    targets = problem.targets
    rt_mat = (
        euler_xyz_to_matrix(problem.target_rot) if use_orientation else None
    )
    anchor = fk_ops.pose_to_angles(spec, problem.pose)

    def flatten(r):  # (..., E, 3) -> (..., E*3)
        return r.reshape(r.shape[:-2] + (-1,))

    def res_only(x):
        pose = fk_ops.angles_to_pose(spec, root_rot, x)
        pos, rot = fk_ops.fk(spec, pose, origin)
        r = flatten((pos[..., eff, :] - targets) * w_pos[:, None])
        if use_orientation:
            r = jnp.concatenate(
                [
                    r,
                    flatten(
                        _vee_residual(
                            rot[..., eff, :, :], rt_mat, orientation_weight
                        )
                    ),
                ],
                axis=-1,
            )
        if locality_weight:
            r = jnp.concatenate(
                [r, jnp.sqrt(locality_weight) * (x - anchor)], axis=-1
            )
        return r

    return res_only


def residual_cost(
    spec: ChainSpec,
    problem: IKProblem,
    angles: jnp.ndarray,
    *,
    use_orientation: bool = False,
    orientation_weight: float = 1.0,
    locality_weight: float = 0.0,
) -> jnp.ndarray:
    """``(S,)`` squared residual norm — the objective polish minimizes."""
    r = _batched_residual(
        spec, problem, use_orientation, orientation_weight, locality_weight
    )(angles)
    return jnp.sum(r * r, axis=-1)


def soa_traceable(spec: ChainSpec, d: int, use_orientation: bool) -> bool:
    """Whether the SoA LM core is safe to trace for this model.

    The SoA core unrolls the m-row Jacobian and the (m, m) normal
    system into scalar (S,) ops — graph size grows ~ m^2 * D, and
    tracing a WIDE multi-effector model explodes (measured: the
    45-DOF 5-effector humanoid, m=15 -> m^2*D = 10125, >22 GB of
    tracer state and >9 min without finishing; the 150-DOF
    single-effector snake, m=3 -> m^2*D = 1350, traces in seconds AND
    stays SoA: its tensor path carries (S, M, M) minor-dim tensors
    for no gain). Gate on
    m^2*D, the actual trace-size driver, with a carve-out keeping
    FEW-effector chains (m <= 9, i.e. <= 3 position effectors) SoA to
    512 DOF — a bare m^2*D cap would tip snakes past ~148 links onto
    the slow tensor path while their trace size is still far under
    the humanoid blow-up point. Models over both limits use the
    tensor path (dual-form (m, m) solve — small and quick to
    compile). Guarded by tests/test_polish.py's routing test.
    """
    e_rows = 3 * len(spec.effector_idx) * (2 if use_orientation else 1)
    if e_rows <= 9 and d <= 512:
        return True
    return e_rows * e_rows * d <= 4000


@partial(
    jax.jit,
    static_argnames=(
        "steps", "use_orientation", "orientation_weight",
        "locality_weight", "soa",
    ),
)
def polish_angles(
    spec: ChainSpec,
    problem: IKProblem,
    angles: jnp.ndarray,
    *,
    steps: int = 4,
    init_damping: float = 1e-3,
    use_orientation: bool = False,
    orientation_weight: float = 1.0,
    locality_weight: float = 0.0,
    soa: bool = True,
) -> jnp.ndarray:
    """Levenberg-Marquardt refinement of per-swarm joint angles.

    Args:
      problem: batched ``(S, ...)`` problem (targets drive the residual).
      angles: ``(S, D)`` starting angles (typically PSO gbest).
      steps: fixed LM step count (static; unrolled by ``lax.scan``).
      init_damping: initial per-swarm lambda (see the damping race
        below for how it adapts).
      locality_weight: weight of optional Tikhonov rows
        ``sqrt(w) * (x - anchor)`` anchoring to the problem's current
        pose — the LM mirror of the reference's angular-locality
        fitness term (kernel.cu:78-84). With it, polish minimizes the
        same cost family as the PSO fitness and keeps per-frame motion
        animation-smooth; pass the reference normalization
        ``angle_weight / (DOF/3)`` for exact cost parity.

    Returns:
      ``(S, D)`` refined angles, clipped to joint limits; each swarm's
      residual norm is non-increasing (rejected steps keep ``x``).
    """
    if soa and soa_traceable(spec, angles.shape[-1], use_orientation):
        # Fast path: the residual (position, optional orientation and
        # locality rows) has a fully-unrolled structure-of-arrays
        # implementation with one (S,) array per quantity
        # (pso/polish_soa.py), identical semantics to float rounding.
        # The tensor path below remains the oracle
        # (tests/test_polish.py equivalence suites).
        from ikpso.pso.polish_soa import polish_angles_soa

        return polish_angles_soa(
            spec, problem, angles, steps=steps,
            init_damping=init_damping, locality_weight=locality_weight,
            use_orientation=use_orientation,
            orientation_weight=orientation_weight,
        )

    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    eff = list(spec.effector_idx)
    w_pos = jnp.sqrt(spec.effector_weight[jnp.array(eff)])

    root_rot = problem.pose[..., 0, :]
    origin = problem.origin
    d = angles.shape[-1]
    res_only = _batched_residual(
        spec, problem, use_orientation, orientation_weight, locality_weight
    )
    anchor = fk_ops.pose_to_angles(spec, problem.pose)
    sqrt_lw = jnp.sqrt(locality_weight) if locality_weight else None
    targets = problem.targets
    rt_mat = (
        euler_xyz_to_matrix(problem.target_rot) if use_orientation else None
    )

    def err2(x):
        r = res_only(x)
        return jnp.sum(r * r, axis=-1)

    def res_from_fk(pe, re, x):
        # Residual from an FK already computed by fk_with_jacobian —
        # avoids a second full FK pass per LM step.
        r = ((pe - targets) * w_pos[:, None]).reshape(pe.shape[:-2] + (-1,))
        if use_orientation:
            ro = _vee_residual(re, rt_mat, orientation_weight)
            r = jnp.concatenate(
                [r, ro.reshape(ro.shape[:-2] + (-1,))], axis=-1
            )
        if locality_weight:
            r = jnp.concatenate([r, sqrt_lw * (x - anchor)], axis=-1)
        return r

    # Residual-row weights for the analytic Jacobian (rows must match
    # the weighted residual layout).
    row_w = jnp.repeat(w_pos, 3)
    if use_orientation:
        row_w = jnp.concatenate(
            [row_w, jnp.full((len(eff) * 3,), jnp.sqrt(orientation_weight))]
        )

    # Locked coordinates (min == max, e.g. the revolute wrist of the
    # 7-DOF arm locks two axes of its node) must not receive any of the
    # minimum-norm step, or the clip truncates it and quadratic
    # convergence degrades to linear (measured: ~0.2x/step instead of
    # floor-in-3-steps). Same for coords pinned at a bound and pushed
    # outward: gradient-projection active set.
    free_static = hi > lo

    def step(carry, _):
        x, lam = carry
        pose = fk_ops.angles_to_pose(spec, root_rot, x)
        pe, re, j = fk_with_jacobian(
            spec, pose, origin, orientation=use_orientation
        )
        j = j * row_w[:, None]
        r = res_from_fk(pe, re, x)
        if locality_weight:
            # Tikhonov locality rows: residual sqrt(w)(x - anchor),
            # Jacobian sqrt(w) * I.
            jl = jnp.broadcast_to(
                sqrt_lw * jnp.eye(d, dtype=j.dtype), x.shape[:-1] + (d, d)
            )
            j = jnp.concatenate([j, jl], axis=-2)
        g0 = jnp.einsum("smd,sm->sd", j, r, precision="highest")
        at_lo = (x <= lo + 1e-7) & (g0 > 0)
        at_hi = (x >= hi - 1e-7) & (g0 < 0)
        free = free_static & ~at_lo & ~at_hi
        j = j * free[:, None, :].astype(j.dtype)
        m = j.shape[-2]

        def candidate(lam_k):
            if m <= d:
                # Underdetermined/redundant arm (the usual IK case):
                # the primal normal matrix J^T J is rank-deficient, so
                # use the dual (damped-least-squares) form — the
                # minimum-norm GN step, exact as lam -> 0, and an
                # (M, M) solve instead of (D, D).
                jjt = jnp.einsum("smd,snd->smn", j, j, precision="highest")
                a = jjt + lam_k[:, None, None] * jnp.eye(m, dtype=x.dtype)
                y = _chol_solve(a, r)
                dx = -jnp.einsum("smd,sm->sd", j, y, precision="highest")
            else:
                h = jnp.einsum("smd,sme->sde", j, j, precision="highest")
                a = h + lam_k[:, None, None] * jnp.eye(d, dtype=x.dtype)
                dx = -_chol_solve(a, g0)
            return jnp.clip(x + dx, lo, hi)

        # Damping race: try 0.1/1/10x lambda per step and keep the best
        # candidate per swarm. A single-lambda LM wastes steps climbing
        # out of an overshooting start (measured: 3 rejected steps
        # before the first accept on far starts); the race costs only
        # two extra residual evaluations — trivial beside the Jacobian
        # pass — and removes the climb entirely.
        mults = (0.1, 1.0, 10.0)
        cands = jnp.stack([candidate(lam * mk) for mk in mults])  # (3, S, D)
        errs = jnp.stack([err2(c) for c in cands])  # (3, S)
        kbest = jnp.argmin(errs, axis=0)  # (S,)
        ebest = jnp.take_along_axis(errs, kbest[None], axis=0)[0]
        xbest = jnp.take_along_axis(
            cands, kbest[None, :, None], axis=0
        )[0]
        lam_best = lam * jnp.asarray(mults, x.dtype)[kbest]
        better = ebest < jnp.sum(r * r, axis=-1)
        x = jnp.where(better[:, None], xbest, x)
        lam = jnp.clip(
            jnp.where(better, lam_best * 0.5, lam * 10.0), 1e-8, 1e6
        )
        return (x, lam), None

    lam0 = jnp.full(angles.shape[:-1], init_damping, angles.dtype)
    (x, _), _ = jax.lax.scan(step, (angles, lam0), None, length=steps)
    return x


def wrap_with_polish(
    solver,
    spec: ChainSpec,
    *,
    steps: int = 4,
    use_orientation: bool = False,
    orientation_weight: float = 1.0,
    init_damping: float = 1e-3,
    locality_weight: float = 0.0,
    obstacles=None,
    collision_backend: str = "sat",
    collision_shape: str = "box",
    gizmo_size: float = 0.2,
):
    """Wrap a ``(problem, key) -> SolveResult`` solver with LM polish.

    The polished answer is taken per swarm ONLY if it does not regress
    the gate metric; otherwise the PSO answer stands. Without locality
    the gate is the true effector error (the host-oracle metric,
    reference Main.cpp:290-298), so the wrap can never hurt accuracy.
    With ``locality_weight`` the gate is the combined residual cost
    polish minimizes (position error may trade against motion
    locality, exactly as in the reference's fitness). ``fitness`` and
    ``trace`` keep the PSO values (they describe the swarm run, not
    the polished point).

    The LM objective knows nothing about colliders, so with
    ``obstacles`` given the gate additionally requires the polished
    pose to be collision-free (the same joint-gizmo/link-box test the
    fitness uses, reference kernel.cu:104-136) — a polish step can
    never move a feasible PSO answer into an obstacle.
    """
    if obstacles is not None:
        from ikpso.ops.collision import get_chain_collider

        _collides = get_chain_collider(collision_backend, collision_shape)

    @jax.jit
    def _solve(problem: IKProblem, key: jnp.ndarray):
        base = solver(problem, key)
        x = polish_angles(
            spec, problem, base.angles,
            steps=steps,
            init_damping=init_damping,
            use_orientation=use_orientation,
            orientation_weight=orientation_weight,
            locality_weight=locality_weight,
        )
        pose = fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], x)
        # Row-FK metric: same value as true_effector_error to float
        # rounding, without the tensor FK's (S, N, 3, 3) intermediates
        # (see polish_soa.true_effector_error_rows).
        from ikpso.pso.polish_soa import true_effector_error_rows

        err = true_effector_error_rows(spec, problem, x)
        if locality_weight:
            cost = lambda a: residual_cost(  # noqa: E731
                spec, problem, a,
                use_orientation=use_orientation,
                orientation_weight=orientation_weight,
                locality_weight=locality_weight,
            )
            take = cost(x) <= cost(base.angles)
        else:
            take = err <= base.effector_error
        if obstacles is not None:
            pos, rot = fk_ops.fk(spec, pose, problem.origin)
            parent_pos = pos[..., list(spec.parent[1:]), :]

            def _hit(args):
                p, r, pp = args
                return _collides(
                    p, r, pp, spec.length[1:], obstacles.center,
                    obstacles.half_extent, obstacles.rot,
                    gizmo_size=gizmo_size,
                )

            hit = _hit((pos[:, 1:, :], rot[:, 1:, :, :], parent_pos))
            take = take & ~hit
        return dataclasses.replace(
            base,
            angles=jnp.where(take[..., None], x, base.angles),
            pose=jnp.where(take[..., None, None], pose, base.pose),
            effector_error=jnp.where(take, err, base.effector_error),
        )

    return _solve
