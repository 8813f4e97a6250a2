"""The megakernel's FK+fitness (ops.tile_fitness) vs the jnp reference.

``kernel_fitness`` runs the solver kernel's own fitness path in the
Pallas interpreter on CPU (SURVEY.md §5: interpreter-mode tests replace
the reference's nonexistent sanitizers); ``chip_smoke.py`` runs the
same comparison compiled for the GPU at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ikpso.models import library
from ikpso.models.chain import Obstacles
from ikpso.ops.fitness import COLLISION_PENALTY, FitnessConfig, fitness
from ikpso.pso import fused
from ikpso.pso.fused import kernel_fitness
from ikpso.pso.config import PSOConfig
from ikpso.pso.solver import solve


TILE_P = 128


def kernel_fitness_fn(spec, batched, fit=FitnessConfig(), obstacles=None,
                        interpret=True):
    """Solver-compatible ``fitness_fn`` backed by the kernel's fitness."""
    fused._refuse_gjk(fit, obstacles)

    def fitness_fn(x):
        return kernel_fitness(spec, x, batched, fit, obstacles, interpret=interpret)

    return fitness_fn


def _x(rng, s, p, d, lo=0.0, hi=2 * np.pi):
    return jnp.asarray(rng.uniform(lo, hi, size=(s, p, d)), jnp.float32)


def _batched(problem, s):
    targets = jnp.broadcast_to(problem.targets, (s,) + problem.targets.shape)
    return library.batched_problem(problem, targets)


@pytest.mark.parametrize("dist_w", [0.0, 0.7])
def test_kernel_matches_jnp_reference_arm(rng, dist_w):
    spec, problem = library.reference_arm()
    batched = _batched(problem, 2)
    cfg = FitnessConfig(angle_weight=3.0, distance_weight=dist_w)
    x = _x(rng, 2, TILE_P, spec.dof)
    ref = np.asarray(fitness(spec, x, batched, config=cfg))
    kernel_fn = kernel_fitness_fn(spec, batched, fit=cfg, interpret=True)
    got = np.asarray(kernel_fn(x))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_kernel_matches_jnp_planar(rng):
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 1)
    cfg = FitnessConfig(angle_weight=1.0)
    x = _x(rng, 1, TILE_P, spec.dof, lo=-np.pi, hi=np.pi)
    ref = np.asarray(fitness(spec, x, batched, config=cfg))
    got = np.asarray(kernel_fitness_fn(spec, batched, fit=cfg, interpret=True)(x))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_kernel_collision_matches_jnp(rng):
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 1)
    obstacles = Obstacles.from_boxes(
        [(1.5, 0.5, 0.0), (-1.0, -1.0, 0.0)],
        [(1.0, 1.0, 1.0), (0.8, 0.8, 0.8)],
        quats=[(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)],
    )
    cfg = FitnessConfig(angle_weight=1.0)
    x = _x(rng, 1, TILE_P, spec.dof, lo=-np.pi, hi=np.pi)
    ref = np.asarray(fitness(spec, x, batched, config=cfg, obstacles=obstacles))
    got = np.asarray(
        kernel_fitness_fn(spec, batched, fit=cfg, obstacles=obstacles, interpret=True)(x)
    )
    # Some poses are rejected; masks must agree and values must match.
    hit_ref = ref >= float(COLLISION_PENALTY)
    hit_got = got >= float(COLLISION_PENALTY)
    np.testing.assert_array_equal(hit_got, hit_ref)
    assert hit_ref.any(), "test should exercise collisions"
    assert (~hit_ref).any(), "test should exercise free poses"
    np.testing.assert_allclose(got[~hit_ref], ref[~hit_ref], rtol=2e-4, atol=2e-4)


def test_kernel_rejects_bad_particle_count(rng):
    # Any particle count runs (padded lanes are dropped); angles whose
    # DOF count does not match the chain are refused.
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 1)
    fn = kernel_fitness_fn(spec, batched, interpret=True)
    x = _x(rng, 1, 100, spec.dof)
    ref = np.asarray(fitness(spec, x, batched, config=FitnessConfig()))
    np.testing.assert_allclose(np.asarray(fn(x)), ref, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        fn(_x(rng, 1, 100, spec.dof + 3))


def test_solver_with_pallas_fitness_converges():
    spec, problem = library.planar_3dof(target=(1.5, 1.5, 0.0))
    batched = _batched(problem, 1)
    fit = FitnessConfig(angle_weight=0.0)
    fitness_fn = kernel_fitness_fn(spec, batched, fit=fit, interpret=True)
    res = solve(
        spec,
        batched,
        jax.random.key(0),
        pso=PSOConfig(iterations=40),
        fit=fit,
        num_particles=TILE_P,
        fitness_fn=fitness_fn,
    )
    assert float(res.effector_error[0]) < 5e-2


def test_kernel_orientation_matches_jnp(rng):
    spec, problem = library.arm_6dof()
    assert problem.target_rot is not None
    batched = _batched(problem, 2)
    batched = batched.replace(
        target_rot=jnp.broadcast_to(
            problem.target_rot, (2,) + problem.target_rot.shape
        )
    )
    cfg = FitnessConfig(angle_weight=1.0, orientation_weight=0.5)
    x = _x(rng, 2, TILE_P, spec.dof, lo=-np.pi, hi=np.pi)
    ref = np.asarray(fitness(spec, x, batched, config=cfg))
    got = np.asarray(kernel_fitness_fn(spec, batched, fit=cfg, interpret=True)(x))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_kernel_capsule_collision_matches_jnp(rng):
    # collision_shape="capsule": the kernel's closed-form point/segment
    # OBB distances vs the jnp capsule collider — masks and free-pose
    # values must agree.
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 1)
    obstacles = Obstacles.from_boxes(
        [(1.5, 0.5, 0.0), (-1.0, -1.0, 0.0)],
        [(1.0, 1.0, 1.0), (0.8, 0.8, 0.8)],
        quats=[(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)],
    )
    cfg = FitnessConfig(angle_weight=1.0, collision_shape="capsule")
    x = _x(rng, 1, TILE_P, spec.dof, lo=-np.pi, hi=np.pi)
    ref = np.asarray(fitness(spec, x, batched, config=cfg, obstacles=obstacles))
    got = np.asarray(
        kernel_fitness_fn(spec, batched, fit=cfg, obstacles=obstacles, interpret=True)(x)
    )
    hit_ref = ref >= float(COLLISION_PENALTY)
    hit_got = got >= float(COLLISION_PENALTY)
    np.testing.assert_array_equal(hit_got, hit_ref)
    assert hit_ref.any(), "test should exercise collisions"
    assert (~hit_ref).any(), "test should exercise free poses"
    np.testing.assert_allclose(got[~hit_ref], ref[~hit_ref], rtol=2e-4, atol=2e-4)


def test_kernel_refuses_gjk_backend():
    # No silent SAT fallback: the kernel paths must raise on
    # collision_backend="gjk", not quietly run SAT.
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 1)
    obstacles = Obstacles.from_boxes([(1.5, 0.5, 0.0)], [(1.0, 1.0, 1.0)])
    cfg = FitnessConfig(collision_backend="gjk")
    with pytest.raises(NotImplementedError, match="gjk"):
        kernel_fitness_fn(spec, batched, fit=cfg, obstacles=obstacles, interpret=True)
    # Without obstacles the backend never runs; building is fine.
    kernel_fitness_fn(spec, batched, fit=cfg, interpret=True)


def test_poly_sincos_accuracy():
    # The kernel's range-reduced polynomial sincos must track the stock
    # functions to ~f32 round-off over the full joint-angle range.
    from ikpso.ops.tile_fitness import _sincos

    x = jnp.linspace(-4 * np.pi, 4 * np.pi, 100001).astype(jnp.float32)
    s, c = _sincos(x)
    # f32 range reduction costs ~k*2pi*eps near the range ends; 2e-6
    # absolute is ~5 um of effector error at this model's reach.
    np.testing.assert_allclose(np.asarray(s), np.sin(np.asarray(x)), atol=2e-6)
    np.testing.assert_allclose(np.asarray(c), np.cos(np.asarray(x)), atol=2e-6)


def test_kernel_trig_impls_agree(rng):
    # poly vs exact trig in the same kernel: fitness values must agree
    # to well under the solver's decision scale.
    spec, problem = library.arm_7dof()
    batched = _batched(problem, 1)
    x = _x(rng, 1, TILE_P, spec.dof, lo=-2 * np.pi, hi=2 * np.pi)
    f_poly = np.asarray(
        kernel_fitness_fn(
            spec, batched, fit=FitnessConfig(trig_impl="poly"), interpret=True
        )(x)
    )
    f_exact = np.asarray(
        kernel_fitness_fn(
            spec, batched, fit=FitnessConfig(trig_impl="exact"), interpret=True
        )(x)
    )
    np.testing.assert_allclose(f_poly, f_exact, rtol=1e-5, atol=1e-5)
