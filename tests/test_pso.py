"""PSO solver: determinism, convergence, and algorithm semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ikpso.models import library
from ikpso.ops import fk as fk_ops
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig
from ikpso.pso.solver import make_solver, solve, solve_single


def _single(problem):
    return jax.tree.map(lambda x: x[None], problem)


def test_planar_3dof_converges():
    # BASELINE config 1: 3-DOF planar, 256 particles, 100 iterations.
    spec, problem = library.planar_3dof(target=(1.5, 1.5, 0.0))
    pso = PSOConfig(iterations=100)
    fit = FitnessConfig(angle_weight=0.0)  # pure reaching
    res = solve_single(
        spec, problem, jax.random.key(0), pso=pso, fit=fit, num_particles=256
    )
    assert float(res.effector_error) < 1e-2


def test_warm_start_init_semantics():
    # All particles start at the anchor; with zero iterations the
    # result IS the anchor pose (reference initParticlesKernel).
    spec, problem = library.reference_arm()
    pso = PSOConfig(iterations=0)
    res = solve_single(spec, problem, jax.random.key(1), pso=pso, num_particles=32)
    anchor = np.asarray(fk_ops.pose_to_angles(spec, problem.pose))
    np.testing.assert_allclose(np.asarray(res.angles), anchor, atol=1e-6)


def test_uniform_init_semantics():
    # Iteration-1 parity mode: particles start spread over the joint
    # range, so even with zero iterations the best-of-init beats a
    # hopeless warm start when the anchor is far from the target.
    spec, problem = library.planar_3dof(target=(0.0, 2.5, 0.0))
    pso = PSOConfig(iterations=0, init_mode="uniform")
    fit = FitnessConfig(angle_weight=0.0)
    res_u = solve_single(
        spec, problem, jax.random.key(3), pso=pso, fit=fit, num_particles=512
    )
    res_w = solve_single(
        spec, problem, jax.random.key(3), pso=PSOConfig(iterations=0), fit=fit,
        num_particles=512,
    )
    # Warm start with 0 iterations returns the anchor exactly; uniform
    # init's best random sample must already be closer.
    assert float(res_u.effector_error) < float(res_w.effector_error)
    # Samples respect joint limits.
    lo = np.asarray(spec.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec.max_rotation[1:]).reshape(-1)
    a = np.asarray(res_u.angles)
    assert (a >= np.maximum(lo, -2 * np.pi) - 1e-6).all()
    assert (a <= np.minimum(hi, 2 * np.pi) + 1e-6).all()


def test_bad_init_mode_rejected():
    with pytest.raises(ValueError):
        PSOConfig(init_mode="bogus")


def test_hybrid_init_semantics():
    # Particle 0 warm, rest uniform: with zero iterations and the
    # anchor already AT the (trivial) target, the warm particle must
    # win — hybrid returns the anchor exactly, like a pure warm start —
    # while on a far target the uniform spread must beat the anchor.
    spec, problem = library.planar_3dof(target=(0.0, 2.5, 0.0))
    fit = FitnessConfig(angle_weight=0.0)
    res_h = solve_single(
        spec, problem, jax.random.key(3),
        pso=PSOConfig(iterations=0, init_mode="hybrid"), fit=fit,
        num_particles=512,
    )
    res_w = solve_single(
        spec, problem, jax.random.key(3), pso=PSOConfig(iterations=0),
        fit=fit, num_particles=512,
    )
    assert float(res_h.effector_error) < float(res_w.effector_error)

    # Anchor-perfect problem: the warm particle 0 is exact (fitness 0)
    # and must be the returned gbest.
    spec2, problem2 = library.planar_3dof()
    from ikpso.ops import fk as fk_ops

    anchor_targets = fk_ops.fk_points(spec2, problem2.pose, problem2.origin)[
        np.array(spec2.effector_idx)
    ]
    problem2 = problem2.replace(targets=anchor_targets)
    res_a = solve_single(
        spec2, problem2, jax.random.key(5),
        pso=PSOConfig(iterations=0, init_mode="hybrid"), fit=fit,
        num_particles=512,
    )
    anchor = np.asarray(fk_ops.pose_to_angles(spec2, problem2.pose))
    np.testing.assert_allclose(np.asarray(res_a.angles), anchor, atol=1e-6)


def test_determinism_same_key():
    spec, problem = library.planar_3dof()
    r1 = solve_single(spec, problem, jax.random.key(7), num_particles=64)
    r2 = solve_single(spec, problem, jax.random.key(7), num_particles=64)
    np.testing.assert_array_equal(np.asarray(r1.angles), np.asarray(r2.angles))
    np.testing.assert_array_equal(np.asarray(r1.trace), np.asarray(r2.trace))


def test_different_keys_differ():
    spec, problem = library.planar_3dof()
    r1 = solve_single(spec, problem, jax.random.key(1), num_particles=64)
    r2 = solve_single(spec, problem, jax.random.key(2), num_particles=64)
    assert not np.array_equal(np.asarray(r1.angles), np.asarray(r2.angles))


def test_gbest_trace_monotone_nonincreasing():
    spec, problem = library.reference_arm()
    res = solve_single(spec, problem, jax.random.key(3), num_particles=128)
    trace = np.asarray(res.trace)  # solve_single strips the swarm axis
    assert np.all(np.diff(trace) <= 1e-7)


def test_joint_limits_respected():
    spec, problem = library.reference_arm()  # limits [0, 2pi]
    res = solve_single(spec, problem, jax.random.key(4), num_particles=128)
    a = np.asarray(res.angles)
    assert np.all(a >= -1e-6)
    assert np.all(a <= 2 * np.pi + 1e-6)


def test_locked_axes_stay_zero():
    # planar_3dof locks X and Y axes via degenerate [0, 0] limits.
    spec, problem = library.planar_3dof()
    res = solve_single(spec, problem, jax.random.key(5), num_particles=64)
    a = np.asarray(res.angles).reshape(-1, 3)
    np.testing.assert_allclose(a[:, 0], 0.0, atol=1e-7)
    np.testing.assert_allclose(a[:, 1], 0.0, atol=1e-7)


def test_batched_swarms_shapes():
    spec, problem = library.reference_arm()
    targets = jnp.broadcast_to(problem.targets, (5, 3, 3))
    batched = library.batched_problem(problem, targets)
    pso = PSOConfig(iterations=3)
    res = solve(spec, batched, jax.random.key(0), pso=pso, num_particles=64)
    assert res.angles.shape == (5, spec.dof)
    assert res.fitness.shape == (5,)
    assert res.pose.shape == (5, 8, 3)
    assert res.effector_error.shape == (5,)
    assert res.trace.shape == (4, 5)


def test_batched_swarm_independence():
    # Different targets per swarm must give different solutions.
    spec, problem = library.planar_3dof()
    targets = jnp.asarray([[[1.5, 1.5, 0.0]], [[2.0, -0.5, 0.0]]], jnp.float32)
    batched = library.batched_problem(problem, targets)
    fit = FitnessConfig(angle_weight=0.0)
    res = solve(
        spec, batched, jax.random.key(0),
        pso=PSOConfig(iterations=60), fit=fit, num_particles=256,
    )
    assert float(res.effector_error[0]) < 5e-2
    assert float(res.effector_error[1]) < 5e-2
    assert not np.allclose(np.asarray(res.angles[0]), np.asarray(res.angles[1]))


def test_canonical_vs_randomized_inertia_modes():
    spec, problem = library.planar_3dof()
    for mode in ("canonical", "randomized"):
        res = solve_single(
            spec,
            problem,
            jax.random.key(0),
            pso=PSOConfig(iterations=30, inertia_mode=mode),
            fit=FitnessConfig(angle_weight=0.0),
            num_particles=128,
        )
        assert float(res.effector_error) < 0.2, mode


def test_make_solver_jits_and_caches():
    spec, problem = library.planar_3dof()
    solver = make_solver(spec, pso=PSOConfig(iterations=5), num_particles=64)
    batched = _single(problem)
    r1 = solver(batched, jax.random.key(0))
    r2 = solver(batched, jax.random.key(0))
    np.testing.assert_array_equal(np.asarray(r1.angles), np.asarray(r2.angles))


def test_orientation_target_solving():
    # 6-DOF arm with orientation cost: final orientation should be
    # closer to the target than without the cost.
    spec, problem = library.arm_6dof(target=(1.0, 0.8, 0.3), target_rot=(0.0, 0.0, 0.8))
    from ikpso.ops.rotations import euler_xyz_to_matrix

    def orient_err(res):
        _, rots = fk_ops.fk(spec, res.pose, problem.origin)
        eff_rot = rots[..., spec.effector_idx[0], :, :]
        tgt = euler_xyz_to_matrix(problem.target_rot[0])
        return float(jnp.sum((eff_rot - tgt) ** 2))

    common = dict(num_particles=512, key=jax.random.key(0))
    with_rot = solve_single(
        spec, problem,
        pso=PSOConfig(iterations=80),
        fit=FitnessConfig(angle_weight=0.0, orientation_weight=1.0),
        **common,
    )
    without_rot = solve_single(
        spec, problem.replace(target_rot=None),
        pso=PSOConfig(iterations=80),
        fit=FitnessConfig(angle_weight=0.0),
        **common,
    )
    assert orient_err(with_rot) < orient_err(without_rot)


def test_invalid_inertia_mode_raises():
    with pytest.raises(ValueError):
        PSOConfig(inertia_mode="bogus")


def test_inertia_schedule_requires_canonical():
    import pytest

    with pytest.raises(ValueError):
        PSOConfig(inertia_mode="randomized", inertia_end=0.2)


def test_inertia_schedule_converges():
    spec, problem = library.planar_3dof(target=(1.5, 1.5, 0.0))
    problems = library.batched_problem(problem, problem.targets[None])
    res = solve(
        spec,
        problems,
        jax.random.key(0),
        pso=PSOConfig(
            iterations=40, inertia_mode="canonical", inertia=0.6, inertia_end=0.2
        ),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=256,
    )
    assert float(res.effector_error[0]) < 5e-2
    # Schedule endpoints: inertia_at spans [inertia, inertia_end].
    pso = PSOConfig(iterations=11, inertia_mode="canonical", inertia=0.6, inertia_end=0.2)
    assert abs(float(pso.inertia_at(0)) - 0.6) < 1e-6
    assert abs(float(pso.inertia_at(10)) - 0.2) < 1e-6


def test_rekick_overwrites_velocity_memory():
    # On a kick iteration, pso_iteration must be independent of the
    # incoming velocity (the kick replaces it before the update); on a
    # non-kick iteration, different velocities must yield different
    # results. PSOConfig.rekick_interval semantics.
    from ikpso.pso.solver import pso_iteration

    spec, problem = library.arm_7dof()
    d = spec.dof
    s, p = 2, 8
    key = jax.random.key(3)
    x = jax.random.normal(key, (s, p, d)) * 0.1
    lbest = x
    gbest = x[:, 0, :]
    lo = jnp.full((d,), -10.0)
    hi = jnp.full((d,), 10.0)

    def fit_fn(xx):
        return jnp.sum(xx**2, axis=-1)

    lval = fit_fn(x)
    gval = lval[:, 0]
    pso = PSOConfig(iterations=4, rekick_interval=2)

    def step(v0, it):
        return pso_iteration(
            x, v0, lbest, lval, gbest, gval, jax.random.key(7),
            fit_fn, lo, hi, pso, iteration=jnp.asarray(it),
        )

    v_a = jnp.ones((s, p, d))
    v_b = -3.0 * jnp.ones((s, p, d))
    out_kick_a = step(v_a, 2)
    out_kick_b = step(v_b, 2)
    np.testing.assert_array_equal(
        np.asarray(out_kick_a[0]), np.asarray(out_kick_b[0])
    )
    np.testing.assert_array_equal(
        np.asarray(out_kick_a[1]), np.asarray(out_kick_b[1])
    )
    out_nk_a = step(v_a, 1)
    out_nk_b = step(v_b, 1)
    assert not np.allclose(np.asarray(out_nk_a[0]), np.asarray(out_nk_b[0]))


def test_rekick_zero_matches_disabled_default():
    # rekick_interval=0 (the default) must not change the RNG stream
    # or the trajectory at all.
    spec, problem = library.arm_7dof()
    r0 = solve_single(
        spec, problem, jax.random.key(0),
        pso=PSOConfig(iterations=5), num_particles=128,
    )
    r1 = solve_single(
        spec, problem, jax.random.key(0),
        pso=PSOConfig(iterations=5, rekick_interval=0), num_particles=128,
    )
    np.testing.assert_array_equal(np.asarray(r0.angles), np.asarray(r1.angles))


def test_rekick_solver_end_to_end():
    spec, problem = library.arm_7dof()
    res = solve_single(
        spec, problem, jax.random.key(0),
        pso=PSOConfig(iterations=8, rekick_interval=3, rekick_scale=0.5),
        num_particles=256,
    )
    assert np.isfinite(float(res.fitness))
    tr = np.asarray(res.trace)
    assert (np.diff(tr[:, 0] if tr.ndim > 1 else tr) <= 1e-6).all()


def test_rekick_threshold_selective():
    # Selective re-kick: swarms whose gbest fitness is already at or
    # below rekick_threshold must NOT be kicked (their step is
    # identical regardless of incoming velocity memory only when
    # kicked — so here the incoming velocity must matter), while
    # above-threshold swarms must be kicked (velocity independent).
    from ikpso.pso.solver import pso_iteration

    spec, _ = library.arm_7dof()
    d = spec.dof
    s, p = 2, 8
    x = jnp.zeros((s, p, d))
    lbest = x
    gbest = x[:, 0, :]
    lo, hi = jnp.full((d,), -10.0), jnp.full((d,), 10.0)

    def fit_fn(xx):
        return jnp.sum(xx**2, axis=-1)

    lval = fit_fn(x)
    # Swarm 0 "converged" (gbest 0.0 <= thr), swarm 1 stuck (above thr).
    gval = jnp.asarray([0.0, 5.0])
    pso = PSOConfig(iterations=4, rekick_interval=2, rekick_threshold=1.0)

    def step(v0):
        return pso_iteration(
            x, v0, lbest, lval, gbest, gval, jax.random.key(7),
            fit_fn, lo, hi, pso, iteration=jnp.asarray(2),
        )

    v_a = jnp.ones((s, p, d))
    v_b = -3.0 * jnp.ones((s, p, d))
    out_a, out_b = step(v_a), step(v_b)
    xa, xb = np.asarray(out_a[0]), np.asarray(out_b[0])
    assert not np.allclose(xa[0], xb[0])          # swarm 0: not kicked
    np.testing.assert_array_equal(xa[1], xb[1])   # swarm 1: kicked


def test_snake_30dof_converges_with_polish():
    # Long-chain model (30 articulated DOF): PSO finds the basin and
    # the LM polish drives the redundant chain to sub-mm — topology is
    # runtime data here, vs the reference's compile-time DOF
    # (reference ik_constants.h:3).
    from ikpso.pso.polish import wrap_with_polish

    spec, problem = library.snake_30dof()
    assert spec.dof == 30
    pso = PSOConfig(iterations=40, inertia_mode="canonical")
    fit = FitnessConfig(angle_weight=0.0)

    def base(p, key):
        return solve(spec, p, key, pso=pso, fit=fit, num_particles=512)

    solver = wrap_with_polish(base, spec, steps=6)
    res = solver(_single(problem), jax.random.key(3))
    assert float(res.effector_error[0]) < 1e-3


def test_humanoid_tree_solving():
    """45-DOF 5-effector humanoid: multi-level branching solves.

    Two interior nodes have 3 children each (pelvis: spine + both
    legs; chest: head + both arms) — deeper tree structure than the
    reference's single 3-effector branch (Main.cpp:100-117). Targets
    are FK positions of a bent pose, so a (near-)zero-error solution
    exists.
    """
    spec, problem = library.humanoid_45dof()
    assert spec.num_nodes == 16
    # Branch points: nodes 0 and 2 each have three children.
    parent = np.asarray(spec.parent)
    assert (parent == 0).sum() == 3 and (parent == 2).sum() == 3
    pso = PSOConfig(
        iterations=60, inertia_mode="canonical", inertia=0.5,
        inertia_end=0.2, init_mode="hybrid",
    )
    fit = FitnessConfig(angle_weight=0.0)
    res = solve_single(
        spec, problem, jax.random.key(0), pso=pso, fit=fit,
        num_particles=512,
    )
    # Summed over 5 effectors; straight-pose initial error is >5.
    # Single-shot PSO captures the basin coarsely — 45-D with five
    # coupled effector constraints is not single-shot-polishable from
    # that far out (measured: best-of-9 deep restarts + 50 LM steps
    # all stall at 0.1-0.4; the LM sticks in limit/singularity traps).
    assert float(res.effector_error) < 1.5

    # The production far-target recipe is the reference's own
    # protocol (Main.cpp:222-227 re-solves warm every frame as the
    # target moves): WALK the targets from the canonical pose's
    # effector positions to the bent-pose targets, warm re-solve per
    # step, LM polish finishing each. 12 steps cover the 5.3-unit
    # total displacement to float rounding (~1e-6).
    from ikpso.harness.trajectory import follow_targets

    start = np.asarray(fk_ops.fk_points(spec, problem.pose, problem.origin))[
        np.asarray(list(spec.effector_idx))
    ]
    end = np.asarray(problem.targets)
    steps = 12
    updates = [start + (end - start) * ((t + 1) / steps) for t in range(steps)]
    last = None
    for rec in follow_targets(
        spec, problem, updates, jax.random.key(0),
        pso=PSOConfig(iterations=30, inertia_mode="canonical",
                      inertia=0.5, inertia_end=0.2, init_mode="warm"),
        fit=fit, num_particles=512, polish=6,
    ):
        last = rec
    assert float(last["effector_error"].max()) < 1e-3
