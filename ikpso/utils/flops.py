"""Counted-op FLOP model: walk real jaxprs instead of hand-waving.

The cost of the hot kernels is COUNTED from the traced program: every
elementwise primitive contributes its output element count, matmuls
contribute 2mnk, transcendentals (sin/cos/exp/...) are tallied
separately (they cost many ops each), and PRNG draws separately. The
model functions below trace the same tile function the megakernel
executes (``ops.tile_fitness.fk_fitness_tile``), so the counts move
with the code automatically, whatever the platform.

Used by bench.py to report the counted GFLOP/s of a solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models.chain import ChainSpec
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig

# Primitives counted as one FLOP per output element.
_ELEMENTWISE_1 = {
    "add", "sub", "mul", "div", "max", "min", "neg", "abs", "sign",
    "floor", "ceil", "round", "rem", "pow", "and", "or", "xor", "not",
    "shift_left", "shift_right_logical", "shift_right_arithmetic",
    "gt", "lt", "ge", "le", "eq", "ne", "nextafter", "select_n",
    "clamp", "square",
}
# Transcendentals: tallied separately (sin/cos are many ops each).
_TRANSCENDENTAL = {
    "sin", "cos", "tan", "exp", "exp2", "log", "log2", "tanh", "logistic",
    "sqrt", "rsqrt", "cbrt", "atan2", "asin", "acos", "atan", "erf",
}
# Pure data movement / bookkeeping: zero cost.
_FREE = {
    "broadcast_in_dim", "reshape", "transpose", "slice", "squeeze",
    "concatenate", "convert_element_type", "iota", "copy", "rev",
    "bitcast_convert_type", "roll", "dynamic_slice", "dynamic_update_slice",
    "gather", "scatter", "stop_gradient", "expand_dims", "pad",
    "get", "swap", "masked_load", "masked_store", "program_id",
    "num_programs", "prng_seed", "split", "random_seed", "random_wrap",
    "random_unwrap", "pjit", "custom_jvp_call", "custom_vjp_call",
    "debug_print",
}


@dataclasses.dataclass
class FlopCount:
    """Float ops / transcendental evals / PRNG elements drawn."""

    flops: float = 0.0
    transcendentals: float = 0.0
    rng_elems: float = 0.0

    def __add__(self, other):
        return FlopCount(
            self.flops + other.flops,
            self.transcendentals + other.transcendentals,
            self.rng_elems + other.rng_elems,
        )

    def __mul__(self, k):
        return FlopCount(self.flops * k, self.transcendentals * k, self.rng_elems * k)

    __rmul__ = __mul__


def _out_elems(eqn) -> int:
    return int(sum(np.prod(v.aval.shape, dtype=np.int64) for v in eqn.outvars))


def count_jaxpr(jaxpr, mult: float = 1.0) -> FlopCount:
    """Recursively count a jaxpr's primitive costs."""
    total = FlopCount()
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        sub = None
        if name in ("scan",):
            sub = (eqn.params["jaxpr"].jaxpr, eqn.params["length"])
        elif name in ("while",):
            # fori_loop lowers to while; trip count is not in the
            # jaxpr. Callers should trace loop bodies directly (the
            # model functions below do); count one body as a floor.
            sub = (eqn.params["body_jaxpr"].jaxpr, 1)
        elif name in ("cond",):
            sub = (eqn.params["branches"][0].jaxpr, 1)
        elif name in ("pjit", "jit", "closed_call", "core_call", "custom_jvp_call",
                      "custom_vjp_call", "remat", "checkpoint"):
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            sub = (getattr(inner, "jaxpr", inner), 1)
        elif name == "pallas_call":
            grid = eqn.params.get("grid_mapping")
            n = int(np.prod(grid.grid, dtype=np.int64)) if grid is not None else 1
            sub = (eqn.params["jaxpr"], n)
        if sub is not None:
            inner, k = sub
            total = total + count_jaxpr(inner, mult * k)
            continue
        elems = _out_elems(eqn)
        if name in _TRANSCENDENTAL:
            total.transcendentals += mult * elems
        elif name == "integer_pow":
            total.flops += mult * elems * max(1, eqn.params.get("y", 2) - 1)
        elif name in ("prng_random_bits", "random_bits", "threefry2x32"):
            total.rng_elems += mult * elems
        elif name == "dot_general":
            a, b = (v.aval.shape for v in eqn.invars[:2])
            dims = eqn.params["dimension_numbers"][0]
            k = int(np.prod([a[i] for i in dims[0]], dtype=np.int64))
            total.flops += mult * 2.0 * k * _out_elems(eqn)
        elif name in ("reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
                      "reduce_and", "reduce_or", "argmax", "argmin",
                      "cumsum", "cummax", "cummin", "reduce_precision"):
            in_elems = int(np.prod(eqn.invars[0].aval.shape, dtype=np.int64))
            total.flops += mult * in_elems
        elif name in _ELEMENTWISE_1:
            total.flops += mult * elems
        elif name in _FREE:
            pass
        else:
            # Unknown primitive: charge one op per output element
            # (conservative floor) rather than failing.
            total.flops += mult * elems
    return total


def count_fn(fn, *args) -> FlopCount:
    """Count the ops of ``fn(*args)`` from its traced jaxpr."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    return count_jaxpr(jaxpr.jaxpr)


# ---------------------------------------------------------------------------
# Model functions for the solver kernel: trace the SAME tile code the
# megakernel runs.


def fitness_tile_count(
    spec: ChainSpec,
    fit: FitnessConfig,
    *,
    num_obstacles: int = 0,
    use_orientation: bool = False,
    particles: int = 128,
) -> FlopCount:
    """Ops of ONE fk_fitness_tile evaluation, per particle.

    Traces ops.tile_fitness.fk_fitness_tile on a ``(particles,)`` tile
    (one swarm, as the megakernel holds it) and divides by the particle
    count, so the number tracks the kernel source exactly.
    """
    from ikpso.ops.tile_fitness import MetaLayout, fk_fitness_tile

    d = spec.dof
    lay = MetaLayout(spec, num_obstacles, use_orientation)
    use_distance = float(np.asarray(fit.distance_weight)) != 0.0

    def run(x, meta_vec, sw_vec):
        return fk_fitness_tile(
            spec,
            lambda dd: x[dd],
            lambda i: meta_vec[i],
            lambda i: sw_vec[i],
            (particles,),
            num_obstacles=num_obstacles,
            use_distance_term=use_distance,
            gizmo_size=fit.gizmo_size,
            use_orientation=use_orientation,
            collision_shape=fit.collision_shape,
            trig_impl=fit.trig_impl,
        )

    x = jnp.zeros((d, particles), jnp.float32)
    meta_vec = jnp.zeros((lay.meta_size,), jnp.float32)
    sw_vec = jnp.zeros((lay.swarm_size,), jnp.float32)
    return count_fn(run, x, meta_vec, sw_vec) * (1.0 / particles)


def pso_update_count(spec: ChainSpec, pso: PSOConfig) -> FlopCount:
    """Ops of one PSO velocity/position update, per particle.

    Mirrors the megakernel's update: (randomized: 3 | else 2) uniform
    draws per DOF element (hash mix + shift + convert + scale = 1 rng
    elem + 3 flops), the velocity FMA chain, integrate, and the
    two-sided clamp.
    """
    d = spec.dof
    randomized = pso.inertia_mode == "randomized"
    n_draws = 3 if randomized else 2
    per_dof = FlopCount(
        flops=n_draws * 3  # shift/convert/scale per uniform
        + (8 if randomized else 7)  # v = w(*u)*v + c1*u*(l-x) + c2*u*(g-x)
        + 1  # x += v
        + 2,  # clamp(lo, hi)
        transcendentals=0.0,
        rng_elems=n_draws,
    )
    return per_dof * d


def gbest_count(d: int) -> FlopCount:
    """Ops of one in-block gbest extraction, per particle.

    An argmin over the swarm's fitness vector, the winner compare, and
    D masked sums (select + add per element each).
    """
    return FlopCount(flops=1 + 1 + 2 * d)


def fused_solve_count(
    spec: ChainSpec,
    pso: PSOConfig,
    fit: FitnessConfig,
    *,
    num_particles: int,
    num_swarms: int,
    num_obstacles: int = 0,
    use_orientation: bool = False,
) -> FlopCount:
    """Counted ops of one full megakernel PSO solve batch.

    (iterations + 1) fitness evaluations, iterations updates, and
    iterations + 1 gbest extractions, all per particle, times S*P
    particles. Init draws are folded into the update count's RNG rate.
    """
    per_fit = fitness_tile_count(
        spec, fit, num_obstacles=num_obstacles,
        use_orientation=use_orientation, particles=num_particles,
    )
    per_particle = (
        (pso.iterations + 1) * per_fit
        + pso.iterations * pso_update_count(spec, pso)
        + (pso.iterations + 1) * gbest_count(spec.dof)
    )
    return per_particle * (num_swarms * num_particles)
