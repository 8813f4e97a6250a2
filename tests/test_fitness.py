"""Fitness semantics vs the numpy oracle and component behaviors."""

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models import library
from ikpso.models.chain import Obstacles
from ikpso.ops import fk as fk_ops
from ikpso.ops.fitness import (
    COLLISION_PENALTY,
    FitnessConfig,
    fitness,
    true_effector_error,
)

from oracle import fitness_oracle


def test_fitness_matches_oracle(rng):
    spec, problem = library.reference_arm()
    cfg = FitnessConfig(angle_weight=3.0, distance_weight=0.7)
    for _ in range(5):
        angles = rng.uniform(0, 2 * np.pi, size=(spec.dof,)).astype(np.float32)
        ours = float(fitness(spec, jnp.asarray(angles), problem, config=cfg))
        ref = fitness_oracle(
            spec.parent,
            np.asarray(spec.length),
            np.asarray(problem.pose, np.float64),
            np.asarray(problem.origin),
            angles,
            spec.effector_idx,
            [1.0, 1.0, 1.0],
            np.asarray(problem.targets),
            angle_weight=3.0,
            distance_weight=0.7,
        )
        assert abs(ours - ref) / max(abs(ref), 1.0) < 1e-4


def test_fitness_zero_at_anchor_with_perfect_targets():
    # If targets sit exactly at the current effector positions, the
    # anchor pose has zero cost (all terms vanish).
    spec, problem = library.reference_arm()
    eff = fk_ops.effector_positions(spec, problem.pose, problem.origin)
    problem = problem.replace(targets=eff)
    angles = fk_ops.pose_to_angles(spec, problem.pose)
    val = float(fitness(spec, angles, problem))
    assert abs(val) < 1e-9


def test_angle_locality_term():
    spec, problem = library.reference_arm()
    eff = fk_ops.effector_positions(spec, problem.pose, problem.origin)
    problem = problem.replace(targets=eff)
    angles = np.asarray(fk_ops.pose_to_angles(spec, problem.pose)).copy()
    base = float(fitness(spec, jnp.asarray(angles), problem))
    # Fitness must increase when any joint leaves the anchor.
    # angle_weight/J * delta^2 with J=7, delta=0.1 -> 3/7*0.01
    angles[4] += 0.1
    moved = float(
        fitness(
            spec,
            jnp.asarray(angles),
            problem,
            config=FitnessConfig(angle_weight=3.0, distance_weight=0.0),
        )
    )
    # effector cost changes too (joint 4 moves the arm), so only check
    # the locality floor: moved >= base + angle term is not exact;
    # instead verify the pure-angle case on a non-ancestor joint of the
    # effectors... all joints are ancestors here, so check monotone +.
    assert moved > base


def test_effector_weighting():
    spec, problem = library.reference_arm()
    angles = fk_ops.pose_to_angles(spec, problem.pose)
    cfg = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    base = float(fitness(spec, angles, problem, config=cfg))
    # Doubling all effector weights doubles the pure-effector cost.
    import dataclasses

    spec2 = dataclasses.replace(spec, effector_weight=spec.effector_weight * 2.0)
    doubled = float(fitness(spec2, angles, problem, config=cfg))
    np.testing.assert_allclose(doubled, 2 * base, rtol=1e-6)


def test_collision_penalty():
    spec, problem = library.planar_3dof()
    angles = fk_ops.pose_to_angles(spec, problem.pose)  # straight along +X
    # Box far away: no hit.
    far = Obstacles.from_boxes([(0.0, 5.0, 0.0)], [(1.0, 1.0, 1.0)])
    ok = float(fitness(spec, angles, problem, obstacles=far))
    assert ok < 1e10
    # Box sitting on the arm: rejected with FLT_MAX.
    hit = Obstacles.from_boxes([(1.5, 0.0, 0.0)], [(1.0, 1.0, 1.0)])
    bad = float(fitness(spec, angles, problem, obstacles=hit))
    assert bad == float(COLLISION_PENALTY)


def test_orientation_cost_is_optional_and_active():
    spec, problem = library.arm_6dof()
    angles = fk_ops.pose_to_angles(spec, problem.pose)
    cfg = FitnessConfig(angle_weight=0.0, orientation_weight=1.0)
    with_rot = float(fitness(spec, angles, problem, config=cfg))
    without = float(
        fitness(spec, angles, problem.replace(target_rot=None), config=cfg)
    )
    assert with_rot > without  # orientation mismatch adds cost


def test_batched_particles_match_loop(rng):
    spec, problem = library.reference_arm()
    problems = library.batched_problem(
        problem, jnp.broadcast_to(problem.targets, (4, 3, 3))
    )
    x = rng.uniform(0, 2 * np.pi, size=(4, 16, spec.dof)).astype(np.float32)
    batched = np.asarray(fitness(spec, jnp.asarray(x), problems))
    assert batched.shape == (4, 16)
    for p in range(16):
        single = float(fitness(spec, jnp.asarray(x[0, p]), problem))
        np.testing.assert_allclose(batched[0, p], single, rtol=1e-5)


def test_true_effector_error_is_euclidean():
    spec, problem = library.planar_3dof(target=(3.0, 0.0, 0.0))
    # Straight arm reaches exactly (3,0,0): error 0.
    err = float(true_effector_error(spec, problem.pose, problem))
    assert err < 1e-6
    # Move target 0.3 away: Euclidean (not squared) error.
    p2 = problem.replace(targets=jnp.asarray([[3.0, 0.3, 0.0]], jnp.float32))
    err2 = float(true_effector_error(spec, p2.pose, p2))
    np.testing.assert_allclose(err2, 0.3, atol=1e-6)


def test_fitness_jits():
    spec, problem = library.reference_arm()
    f = jax.jit(lambda a: fitness(spec, a, problem))
    angles = fk_ops.pose_to_angles(spec, problem.pose)
    assert np.isfinite(float(f(angles)))


def test_fitness_fk_scan_matches_unrolled():
    # FitnessConfig.fk_impl="scan" (log-depth associative-scan FK) must
    # be numerically interchangeable with the unrolled walk on a deep
    # serial chain — the deep-chain option wired into the solver path.
    import jax

    from ikpso.models import library

    spec, problem = library.snake(10)
    batched = library.batched_problem(
        problem, jnp.broadcast_to(problem.targets, (2,) + problem.targets.shape)
    )
    x = jnp.asarray(
        np.random.default_rng(3).uniform(-1.5, 1.5, (2, 64, spec.dof)),
        jnp.float32,
    )
    f_unrolled = fitness(
        spec, x, batched, config=FitnessConfig(angle_weight=1.0)
    )
    f_scan = fitness(
        spec, x, batched, config=FitnessConfig(angle_weight=1.0, fk_impl="scan")
    )
    np.testing.assert_allclose(
        np.asarray(f_scan), np.asarray(f_unrolled), rtol=1e-5, atol=1e-5
    )

    # Solver end-to-end with the scan FK (jit + lax.scan compose).
    from ikpso.pso.config import PSOConfig
    from ikpso.pso.solver import solve

    res = solve(
        spec, batched, jax.random.key(0),
        pso=PSOConfig(iterations=5),
        fit=FitnessConfig(angle_weight=0.0, fk_impl="scan"),
        num_particles=64,
    )
    assert np.isfinite(np.asarray(res.fitness)).all()


def test_fitness_fk_scan_rejects_trees():
    import pytest

    from ikpso.models import library

    spec, problem = library.reference_arm()  # 3 effector children = tree
    batched = library.batched_problem(
        problem, jnp.broadcast_to(problem.targets, (1,) + problem.targets.shape)
    )
    x = jnp.zeros((1, 8, spec.dof), jnp.float32)
    with pytest.raises(ValueError, match="serial"):
        fitness(spec, x, batched, config=FitnessConfig(fk_impl="scan"))
