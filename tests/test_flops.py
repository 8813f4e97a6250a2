"""Counted-op model: primitive accounting and kernel-model sanity."""

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models import library
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig
from ikpso.utils.flops import (
    count_fn,
    fitness_tile_count,
    fused_solve_count,
    pso_update_count,
)


def test_count_fn_elementwise_and_nesting():
    c = count_fn(lambda a, b: a * b + a, jnp.zeros((4, 8)), jnp.zeros((4, 8)))
    assert c.flops == 64 and c.transcendentals == 0

    @jax.jit
    def f(a):
        return jnp.sin(a) * 2.0

    c2 = count_fn(lambda a: f(a) + f(a), jnp.zeros((8,)))
    assert c2.transcendentals == 16 and c2.flops == 24

    c3 = count_fn(
        lambda a, b: jnp.matmul(a, b), jnp.zeros((4, 8)), jnp.zeros((8, 16))
    )
    assert c3.flops == 2 * 4 * 8 * 16


def test_count_fn_scan_multiplies_by_length():
    def step(c, _):
        return c * c + 1.0, None

    def run(x):
        return jax.lax.scan(step, x, None, length=5)[0]

    c = count_fn(run, jnp.zeros((8,)))
    assert c.flops == 5 * 16


def test_fitness_tile_count_matches_real_kernel_jaxpr():
    # The model traces the same tile function the megakernel runs;
    # its per-iteration count must land in the band of the kernel's
    # own loop body (fitness + update, ~700 ops per particle here).
    spec, _ = library.arm_7dof()
    fit = FitnessConfig(angle_weight=0.0)
    pso = PSOConfig(iterations=8, inertia_mode="canonical",
                    inertia=0.5, inertia_end=0.2)
    per_fit = fitness_tile_count(spec, fit, particles=128)
    per_up = pso_update_count(spec, pso)
    per_iter = per_fit.flops + per_up.flops
    assert 500 < per_iter < 800, per_iter
    assert per_fit.transcendentals == 0  # poly trig: no transcendentals
    assert per_up.rng_elems == 2 * spec.dof

    c = fused_solve_count(
        spec, pso, fit, num_particles=128, num_swarms=1024,
    )
    # 9 fitness evals + 8 updates + 9 gbest extractions, per particle.
    per_particle = c.flops / (1024 * 128)
    assert 4000 < per_particle < 9000, per_particle


def test_obstacle_and_orientation_counts_increase():
    spec, _ = library.arm_7dof()
    base = fitness_tile_count(spec, FitnessConfig(angle_weight=0.0))
    obst = fitness_tile_count(
        spec, FitnessConfig(angle_weight=0.0), num_obstacles=2
    )
    orient = fitness_tile_count(
        spec, FitnessConfig(angle_weight=0.0, orientation_weight=1.0),
        use_orientation=True,
    )
    assert obst.flops > base.flops + 500
    assert orient.flops > base.flops
