"""PSO megakernel: one swarm's whole solve in one Pallas Triton program.

The reference's per-frame solve crosses the host/device boundary >= 3x
per PSO iteration (thrust reduction + scalar memcpy + synchronize,
reference kernel.cu:307-323; SURVEY.md §3.3). The jnp/``lax.scan``
solver (ikpso.pso.solver) removes the host syncs, but still moves the
swarm state ``(S, P, D)`` and fresh uniform draws through device
memory every iteration.

Here one program of a ``grid=(S,)`` launch owns one swarm for the
whole solve:

  * the particles lie along the block, one ``(P,)`` vector per DOF (D
    is unrolled in Python: Triton blocks are powers of two, D usually
    is not) — positions, velocities and local bests stay in registers;
  * init (warm / uniform / hybrid), FK + fitness (``ops.tile_fitness``),
    the velocity update and the joint-limit clamp run in-kernel from
    the swarm's packed constants;
  * random numbers come from a counter-based hash of (swarm seed, draw
    slot, DOF, particle) — the curand-per-particle equivalent
    (reference utility_kernels.cuh:21-47) without any state arrays;
  * the global best is an in-block argmin (lowest index on ties, like
    thrust::min_element) plus D masked sums; nothing crosses programs;
  * only the swarm's constants come in and its best row goes out.

The wrapper pads P to a power of two; padded particles carry +inf
fitness and are never chosen. Chain constants (lengths, weights,
joint limits, obstacles) are baked into the kernel as constants;
iterations and particle count are trace-time constants too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso.ops import fk as fk_ops
from ikpso.ops.fitness import FitnessConfig
from ikpso.ops.tile_fitness import (
    MetaLayout,
    fk_fitness_tile,
    pack_meta,
    pack_swarm,
)
from ikpso.pso.config import PSOConfig
from ikpso.pso.solver import SolveResult

_INV_2_24 = np.float32(1.0 / (1 << 24))
_INF = np.float32(np.inf)
_GOLDEN = 0x9E3779B9  # Weyl increment between consecutive counters
_SLOT_MUL = 0x85EBCA6B  # spreads draw-slot indices before mixing


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def num_warps(p_pad: int) -> int:
    """Two particles per thread, 1 to 8 warps.

    On an H100 (700 W) the headline PSO stage (P=128, S=1,048,576) took
    39.4 ms with 2 warps, 40.8 ms with 1 and 45.3 ms with 4 (one
    particle per thread, more threads sharing each in-block reduction).
    """
    return min(max(p_pad // 64, 1), 8)


def _u32(v) -> np.uint32:
    return np.uint32(int(v) & 0xFFFFFFFF)


def mix32(x):
    """lowbias32 (C. Wellons): a bijective uint32 avalanche mixer."""
    srl = jax.lax.shift_right_logical
    x = x ^ srl(x, np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ srl(x, np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ srl(x, np.uint32(16))


def swarm_key(seed0, seed1):
    """Per-swarm stream key from the swarm's two uint32 seed words."""
    return mix32(seed0 ^ mix32(seed1))


def draw_key(skey, slot):
    """Key of one draw slot (one ``(D, P)`` block of uniforms)."""
    slot = jnp.asarray(slot).astype(jnp.uint32)
    return mix32(skey ^ (slot * np.uint32(_SLOT_MUL)))


def lane_counters(p_pad: int):
    """Per-particle Weyl offsets ``particle * golden`` (uint32)."""
    lane = jax.lax.broadcasted_iota(jnp.uint32, (p_pad,), 0)
    return lane * np.uint32(_GOLDEN)


def uniform(dkey, lane_g, dof: int, p_pad: int):
    """U[0, 1) for one DOF's ``(P,)`` particle vector of a draw slot.

    The counter is ``dof * p_pad + particle``; its Weyl offset splits
    into the per-lane vector ``lane_g`` and a trace-time constant. The
    top 24 bits become the mantissa. The shift MUST be logical: an
    arithmetic shift sign-extends draws with the top bit set and warps
    the distribution to [-0.5, 0.5) (PSO still "works" with that, it
    just converges far worse).
    """
    bits = mix32((dkey + _u32(dof * p_pad * _GOLDEN)) + lane_g)
    top = jax.lax.shift_right_logical(bits, np.uint32(8))
    return top.astype(jnp.int32).astype(jnp.float32) * _INV_2_24


def _fitness_closure(spec, fit, meta, num_obstacles, use_orientation,
                     sw, p_real, p_pad):
    """Per-swarm fitness of a list of D ``(P,)`` angle vectors."""
    meta_c = [float(v) for v in meta]
    use_distance = float(np.asarray(fit.distance_weight)) != 0.0
    lane = jax.lax.broadcasted_iota(jnp.int32, (p_pad,), 0)

    def fitness_of(x):
        f = fk_fitness_tile(
            spec,
            lambda dd: x[dd],
            lambda i: meta_c[i],
            sw,
            (p_pad,),
            num_obstacles=num_obstacles,
            use_distance_term=use_distance,
            gizmo_size=fit.gizmo_size,
            use_orientation=use_orientation,
            collision_shape=fit.collision_shape,
            trig_impl=fit.trig_impl,
        )
        if p_pad != p_real:
            f = jnp.where(lane < p_real, f, _INF)
        return f

    return fitness_of


def _scalar_cache(ref):
    """Memoized scalar loads of a swarm's packed constants."""
    cache = {}

    def sw(i):
        if i not in cache:
            cache[i] = ref[i]
        return cache[i]

    return sw


def draws_per_iteration(pso: PSOConfig) -> Tuple[int, int]:
    """(init draw slots, slots per iteration) of the kernel's stream.

    Slot layout: the init position draw (non-warm inits) at slot 0,
    then the init velocity draw; iteration ``it`` owns the block
    starting at ``n_init + it * per_iter``: u_cognitive, u_social,
    [u_inertia if randomized], [u_kick if re-kick is on].
    """
    n_init = 1 if pso.init_mode == "warm" else 2
    per_iter = (3 if pso.inertia_mode == "randomized" else 2) + (
        1 if pso.rekick_interval else 0
    )
    return n_init, per_iter


def _build_solver_kernel(spec, pso, fit, meta, num_obstacles,
                         use_orientation, p_real, p_pad, d_pad,
                         debug_uniforms):
    d = spec.dof
    lay = MetaLayout(spec, num_obstacles, use_orientation)
    lo = [float(v) for v in np.asarray(spec.min_rotation)[1:].reshape(-1)]
    hi = [float(v) for v in np.asarray(spec.max_rotation)[1:].reshape(-1)]
    randomized = pso.inertia_mode == "randomized"
    n_init, per_iter = draws_per_iteration(pso)
    rekick = pso.rekick_interval
    interval = max(1, pso.gbest_interval)
    c1 = np.float32(pso.cognitive)
    c2 = np.float32(pso.social)
    vscale = np.float32(pso.init_velocity_scale)
    two_pi = 2.0 * np.pi

    def kernel(swarm_ref, seed_ref, *rest):
        if debug_uniforms:
            u_ref, ang_ref, val_ref = rest
        else:
            ang_ref, val_ref = rest
        sw = _scalar_cache(swarm_ref)
        fitness_of = _fitness_closure(
            spec, fit, meta, num_obstacles, use_orientation, sw,
            p_real, p_pad,
        )
        lane = jax.lax.broadcasted_iota(jnp.int32, (p_pad,), 0)

        if debug_uniforms:
            def draw(slot):
                return [u_ref[slot, dd, :] for dd in range(d)]
        else:
            skey = swarm_key(seed_ref[0], seed_ref[1])
            lane_g = lane_counters(p_pad)

            def draw(slot):
                k = draw_key(skey, slot)
                return [uniform(k, lane_g, dd, p_pad) for dd in range(d)]

        def gbest_of(lbest, lval):
            win = jnp.argmin(lval)  # lowest index among equal minima
            sel = lane == win
            return [jnp.sum(jnp.where(sel, lbest[dd], 0.0)) for dd in range(d)]

        # Init (reference initParticlesKernel, kernel.cu:223-266 /
        # SURVEY.md §2.3; same semantics as pso/solver.py::init_swarm).
        anchor = [
            jnp.broadcast_to(sw(lay.OFF_ANCHOR + dd), (p_pad,))
            for dd in range(d)
        ]
        if pso.init_mode == "warm":
            x0 = anchor
        else:
            u0 = draw(0)
            x0 = []
            for dd in range(d):
                lo_c, hi_c = max(lo[dd], -two_pi), min(hi[dd], two_pi)
                xd = lo_c + u0[dd] * np.float32(hi_c - lo_c)
                if pso.init_mode == "hybrid":
                    xd = jnp.where(lane == 0, anchor[dd], xd)
                x0.append(xd)
        uv = draw(n_init - 1)
        v0 = [(uv[dd] * 2.0 - 1.0) * vscale for dd in range(d)]
        f0 = fitness_of(x0)
        gb0 = [jnp.float32(0.0)] * d

        def body(it, carry):
            x, v, lbest, lval, gb = carry
            new_gb = gbest_of(lbest, lval)
            if interval == 1:
                gb = new_gb
            else:
                # Relaxed social attractor: refresh every `interval`
                # iterations (PSOConfig.gbest_interval).
                refresh = jax.lax.rem(it, np.int32(interval)) == 0
                gb = [jnp.where(refresh, n, o) for n, o in zip(new_gb, gb)]
            base = n_init + it * per_iter
            u_c = draw(base)
            u_s = draw(base + 1)
            u_w = draw(base + 2) if randomized else None
            if rekick:
                # Periodic velocity re-kick (PSOConfig.rekick_interval):
                # overwrite the inertia memory with a fresh init-style
                # draw at every multiple of the interval except 0.
                u_k = draw(base + per_iter - 1)
                # lax.rem, not %: jnp's floor-mod lowers to a mixed-type
                # rem the Triton route refuses (it >= 0, so they agree).
                kick = (it > 0) & (jax.lax.rem(it, np.int32(rekick)) == 0)
                if pso.rekick_threshold >= 0.0:
                    kick = kick & (
                        jnp.min(lval) > np.float32(pso.rekick_threshold)
                    )
                scale = np.float32(pso.rekick_scale)
                v = [
                    jnp.where(kick, (u_k[dd] * 2.0 - 1.0) * scale, v[dd])
                    for dd in range(d)
                ]
            w_t = pso.inertia_at(it.astype(jnp.float32))
            new_x, new_v = [], []
            for dd in range(d):
                inert = w_t * u_w[dd] * v[dd] if randomized else w_t * v[dd]
                vd = (
                    inert
                    + c1 * u_c[dd] * (lbest[dd] - x[dd])
                    + c2 * u_s[dd] * (gb[dd] - x[dd])
                )
                # Integrate + per-axis joint-limit clamp (kernel.cu:168-187).
                xd = jnp.minimum(jnp.maximum(x[dd] + vd, lo[dd]), hi[dd])
                new_v.append(vd)
                new_x.append(xd)
            f = fitness_of(new_x)
            better = f < lval
            lval = jnp.where(better, f, lval)
            lbest = [jnp.where(better, new_x[dd], lbest[dd]) for dd in range(d)]
            return new_x, new_v, lbest, lval, gb

        _, _, lbest, lval, _ = jax.lax.fori_loop(
            0, pso.iterations, body, (x0, v0, x0, f0, gb0)
        )
        g = gbest_of(lbest, lval)
        col = jax.lax.broadcasted_iota(jnp.int32, (d_pad,), 0)
        row = jnp.zeros((d_pad,), jnp.float32)
        for dd in range(d):
            row = jnp.where(col == dd, g[dd], row)
        ang_ref[...] = row
        val_ref[...] = jnp.min(lval)

    return kernel


def _vma(args):
    # Under shard_map (ikpso.parallel.sharded impl="fused") the output
    # varies over whatever mesh axes the inputs vary over; the vma
    # must be declared explicitly on pallas_call out_shapes.
    vma = frozenset()
    for a in args:
        vma |= frozenset(getattr(jax.typeof(a), "vma", ()) or ())
    return vma


def _compiler_params(p_pad: int):
    # Named explicitly: the default Pallas GPU route in this JAX is
    # Mosaic GPU, and this kernel is written for the Triton route.
    return plgpu.CompilerParams(num_warps=num_warps(p_pad), num_stages=1)


def _pad_axis(a, axis: int, size: int):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - a.shape[axis])
    return jnp.pad(a, pad)


def fused_solve_raw(
    spec: ChainSpec,
    pso: PSOConfig,
    fit: FitnessConfig,
    swarm: jnp.ndarray,
    seeds: jnp.ndarray,
    *,
    num_particles: int,
    obstacles: Optional[Obstacles] = None,
    use_orientation: bool = False,
    uniforms: Optional[jnp.ndarray] = None,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the megakernel. Returns (gbest (S, D), gbest_val (S,)).

    ``swarm``: ``(S, K)`` packed per-swarm constants
    (:func:`ikpso.ops.tile_fitness.pack_swarm`); ``seeds``: ``(S, 2)``
    uint32 stream seeds. ``uniforms`` (testing only): ``(S, n_draws,
    D, P)`` draws injected in place of the hash stream (slot layout:
    :func:`draws_per_iteration`), so a reference can replay the
    kernel's trajectory exactly.
    """
    d = spec.dof
    s, k = swarm.shape
    p_pad, d_pad, k_pad = next_pow2(num_particles), next_pow2(d), next_pow2(k)
    num_obstacles = 0 if obstacles is None else obstacles.count
    meta = pack_meta(spec, fit, obstacles, use_orientation)
    kernel = _build_solver_kernel(
        spec, pso, fit, meta, num_obstacles, use_orientation,
        num_particles, p_pad, d_pad, debug_uniforms=uniforms is not None,
    )
    in_specs = [
        pl.BlockSpec((None, k_pad), lambda i: (i, 0)),
        pl.BlockSpec((None, 2), lambda i: (i, 0)),
    ]
    args = [_pad_axis(swarm.astype(jnp.float32), 1, k_pad),
            seeds.astype(jnp.uint32)]
    if uniforms is not None:
        u = uniforms.astype(jnp.float32)
        for axis, size in ((1, next_pow2(u.shape[1])), (2, d_pad), (3, p_pad)):
            u = _pad_axis(u, axis, size)
        in_specs.append(
            pl.BlockSpec((None,) + u.shape[1:], lambda i: (i, 0, 0, 0))
        )
        args.append(u)
    vma = _vma(args)
    ang, val = pl.pallas_call(
        kernel,
        grid=(s,),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, d_pad), lambda i: (i, 0)),
            pl.BlockSpec((None,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((s, d_pad), jnp.float32, vma=vma),
            jax.ShapeDtypeStruct((s,), jnp.float32, vma=vma),
        ],
        compiler_params=_compiler_params(p_pad),
        interpret=interpret,
        name="pso_megakernel",
    )(*args)
    return ang[:, :d], val


def _refuse_gjk(fit: FitnessConfig, obstacles: Optional[Obstacles]) -> None:
    if obstacles is not None and obstacles.count and fit.collision_backend == "gjk":
        raise NotImplementedError(
            "collision_backend='gjk' is jnp-path only: its 50-round "
            "support-point loop per (node x link x obstacle) pair has no "
            "place in a register-resident kernel, so the megakernel fuses "
            "only the closed-form backend ('sat'; exact for both "
            "collision shapes). Use impl='jnp' for GJK, or "
            "collision_backend='sat' here."
        )


def _uses_orientation(fit: FitnessConfig, problem: IKProblem) -> bool:
    return (
        problem.target_rot is not None
        and float(np.asarray(fit.orientation_weight)) != 0.0
    )


def kernel_fitness(
    spec: ChainSpec,
    x: jnp.ndarray,
    problem: IKProblem,
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """The megakernel's fitness alone: ``x (S, P, D) -> (S, P)``.

    One program per swarm evaluates ``ops.tile_fitness`` exactly as the
    solver kernel does — the path the plain ``ops.fitness.fitness``
    reference is compared against.
    """
    _refuse_gjk(fit, obstacles)
    s, p, d = x.shape
    if d != spec.dof:
        raise ValueError(f"x has {d} DOF, the chain has {spec.dof}")
    p_pad, d_pad = next_pow2(p), next_pow2(d)
    num_obstacles = 0 if obstacles is None else obstacles.count
    use_orientation = _uses_orientation(fit, problem)
    anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
    anchor_positions = fk_ops.fk_points(spec, problem.pose, problem.origin)
    swarm = pack_swarm(spec, problem, anchor_angles, anchor_positions,
                       use_orientation)
    k_pad = next_pow2(swarm.shape[-1])
    meta = pack_meta(spec, fit, obstacles, use_orientation)

    def kernel(swarm_ref, x_ref, out_ref):
        fitness_of = _fitness_closure(
            spec, fit, meta, num_obstacles, use_orientation,
            _scalar_cache(swarm_ref), p, p_pad,
        )
        out_ref[...] = fitness_of([x_ref[dd, :] for dd in range(d)])

    xt = _pad_axis(_pad_axis(jnp.swapaxes(x, 1, 2), 1, d_pad), 2, p_pad)
    out = pl.pallas_call(
        kernel,
        grid=(s,),
        in_specs=[
            pl.BlockSpec((None, k_pad), lambda i: (i, 0)),
            pl.BlockSpec((None, d_pad, p_pad), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, p_pad), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((s, p_pad), jnp.float32),
        compiler_params=_compiler_params(p_pad),
        interpret=interpret,
        name="pso_megakernel_fitness",
    )(_pad_axis(swarm, 1, k_pad), xt.astype(jnp.float32))
    return out[:, :p]


def make_fused_solver(
    spec: ChainSpec,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    interpret: bool = False,
):
    """A jitted ``(problem, key) -> SolveResult`` running the megakernel.

    Drop-in for :func:`ikpso.pso.solver.make_solver` minus the
    per-iteration ``trace`` (the scan-based solver remains the
    convergence-analysis tool; ``trace`` here has one entry: the final
    gbest fitness).
    """
    if num_particles < 1:
        raise ValueError(f"num_particles must be >= 1, got {num_particles}")
    _refuse_gjk(fit, obstacles)

    @jax.jit
    def _solve(problem: IKProblem, key: jnp.ndarray) -> SolveResult:
        # Pack and post-error through the SoA row FK (swarms along the
        # leading axis, one (S,) row per coordinate): no (S, N, 3, 3)
        # intermediates for work that is a few ops per swarm.
        from ikpso.pso.polish_soa import (
            anchor_positions_flat,
            true_effector_error_rows,
        )

        use_orientation = _uses_orientation(fit, problem)
        anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
        swarm = pack_swarm(spec, problem, anchor_angles,
                           anchor_positions_flat(spec, problem),
                           use_orientation)
        s = swarm.shape[0]
        seeds = jax.random.bits(key, (s, 2), dtype=jnp.uint32)
        gbest, gbest_val = fused_solve_raw(
            spec, pso, fit, swarm, seeds,
            num_particles=num_particles, obstacles=obstacles,
            use_orientation=use_orientation, interpret=interpret,
        )
        solved_pose = fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], gbest)
        err = true_effector_error_rows(spec, problem, gbest)
        return SolveResult(
            angles=gbest,
            fitness=gbest_val,
            pose=solved_pose,
            effector_error=err,
            trace=gbest_val[None],
        )

    return _solve
