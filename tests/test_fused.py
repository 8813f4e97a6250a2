"""PSO megakernel (ikpso.pso.fused), run by the Pallas interpreter.

The kernel is written for the Pallas Triton route; ``interpret=True``
runs the same kernel body on the CPU, counter-hash RNG included, so
convergence is testable here. Replays inject the uniform stream and
compare the whole trajectory with a numpy re-run that scores
particles with the plain ``ops.fitness`` oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ikpso.models import library
from ikpso.ops import fk as fk_ops
from ikpso.ops.fitness import FitnessConfig
from ikpso.ops.fitness import fitness as jnp_fitness
from ikpso.ops.tile_fitness import pack_swarm
from ikpso.pso import fused
from ikpso.pso.config import PSOConfig
from ikpso.pso.fused import fused_solve_raw, make_fused_solver


def _batched(problem, s):
    return library.batched_problem(
        problem, jnp.broadcast_to(problem.targets, (s,) + problem.targets.shape)
    )


def _swarm(spec, batched):
    anchor_angles = fk_ops.pose_to_angles(spec, batched.pose)
    anchor_positions = fk_ops.fk_points(spec, batched.pose, batched.origin)
    return pack_swarm(spec, batched, anchor_angles, anchor_positions)


def _run_injected(spec, problem, pso, fit, U, p, obstacles=None):
    """Kernel with the injected stream ``U (1, n_draws, D, p)``."""
    batched = _batched(problem, 1)
    gb, gv = fused_solve_raw(
        spec, pso, fit, _swarm(spec, batched), jnp.zeros((1, 2), jnp.uint32),
        num_particles=p, obstacles=obstacles, uniforms=U, interpret=True,
    )
    return np.asarray(gb[0]), float(gv[0])


def _replay(spec, problem, pso, fit, U, p, obstacles=None, kick=None):
    """Numpy re-run of the kernel's trajectory on the same draws.

    Returns (gbest angles, gbest fitness, saw_collision_penalty).
    ``kick(it)`` says whether the re-kick fires at iteration ``it``.
    """
    from ikpso.ops.fitness import COLLISION_PENALTY

    n_init, dpi = fused.draws_per_iteration(pso)
    Un = np.asarray(U[0])

    def to_pd(u):  # (D, P) -> (P, D)
        return u.T

    anchor = np.asarray(fk_ops.pose_to_angles(spec, problem.pose))
    lo = np.asarray(spec.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec.max_rotation[1:]).reshape(-1)
    fit_fn = jax.jit(
        lambda x: jnp_fitness(spec, x, problem, config=fit, obstacles=obstacles)
    )
    if pso.init_mode == "warm":
        x = np.tile(anchor, (p, 1)).astype(np.float32)
    else:
        lo_c = np.maximum(lo, -2 * np.pi).astype(np.float32)
        hi_c = np.minimum(hi, 2 * np.pi).astype(np.float32)
        x = (lo_c + to_pd(Un[0]) * (hi_c - lo_c)).astype(np.float32)
        if pso.init_mode == "hybrid":
            x[0] = anchor
    v = ((to_pd(Un[n_init - 1]) * 2.0 - 1.0) * pso.init_velocity_scale).astype(
        np.float32
    )
    lbest = x.copy()
    lval = np.asarray(fit_fn(jnp.asarray(x)))
    w, c1, c2 = (np.float32(pso.inertia), np.float32(pso.cognitive),
                 np.float32(pso.social))
    saw_penalty = False
    for it in range(pso.iterations):
        gb = lbest[int(np.argmin(lval))]
        base = n_init + dpi * it
        u_c, u_s, u_w = to_pd(Un[base]), to_pd(Un[base + 1]), to_pd(Un[base + 2])
        if kick is not None and kick(it):
            v = ((to_pd(Un[base + dpi - 1]) * 2.0 - 1.0)
                 * np.float32(pso.rekick_scale)).astype(np.float32)
        v = w * u_w * v + c1 * u_c * (lbest - x) + c2 * u_s * (gb[None] - x)
        x = np.clip(x + v, lo, hi).astype(np.float32)
        f = np.asarray(fit_fn(jnp.asarray(x)))
        saw_penalty |= bool(np.any(f >= COLLISION_PENALTY))
        m = f < lval
        lval = np.where(m, f, lval)
        lbest = np.where(m[:, None], x, lbest)
    i0 = int(np.argmin(lval))
    return lbest[i0], float(lval[i0]), saw_penalty


def _stream(pso, d, p, key):
    n_init, dpi = fused.draws_per_iteration(pso)
    return jax.random.uniform(
        jax.random.key(key), (1, n_init + dpi * pso.iterations, d, p),
        dtype=jnp.float32,
    )


def test_anchor_with_perfect_targets_stays_gbest():
    # Targets exactly at the anchor pose's effectors: the warm-start
    # fitness is 0 and no particle can beat it, so gbest must be the
    # anchor with fitness 0 regardless of the RNG stream.
    spec, problem = library.arm_7dof()
    eff = fk_ops.effector_positions(spec, problem.pose, problem.origin)
    problem = problem.replace(targets=eff)
    batched = _batched(problem, 2)
    solver = make_fused_solver(
        spec,
        pso=PSOConfig(iterations=3),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=256,
        interpret=True,
    )
    res = solver(batched, jax.random.key(0))
    np.testing.assert_allclose(np.asarray(res.fitness), 0.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(res.effector_error), 0.0, atol=1e-5)
    anchor = np.asarray(fk_ops.pose_to_angles(spec, problem.pose))
    np.testing.assert_allclose(np.asarray(res.angles), anchor[None].repeat(2, 0), atol=1e-6)


def test_fused_fitness_matches_jnp_at_anchor():
    # The anchor is a member of the warm-started swarm, so after one
    # iteration the gbest fitness can only be <= the jnp fitness of
    # the anchor.
    spec, problem = library.reference_arm()
    batched = _batched(problem, 2)
    fit = FitnessConfig(angle_weight=3.0, distance_weight=0.7)
    solver = make_fused_solver(
        spec,
        pso=PSOConfig(iterations=1),
        fit=fit,
        num_particles=256,
        interpret=True,
    )
    res = solver(batched, jax.random.key(1))
    anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
    ref = float(jnp_fitness(spec, anchor_angles, problem, config=fit))
    assert np.all(np.asarray(res.fitness) <= ref + 1e-6)


def test_joint_limits_respected():
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 2)
    solver = make_fused_solver(
        spec,
        pso=PSOConfig(iterations=5, init_mode="uniform"),
        num_particles=256,
        interpret=True,
    )
    res = solver(batched, jax.random.key(2))
    lo = np.asarray(spec.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec.max_rotation[1:]).reshape(-1)
    a = np.asarray(res.angles)
    assert (a >= lo - 1e-6).all() and (a <= hi + 1e-6).all()


def test_rejects_bad_particle_counts():
    # Any positive count runs (the wrapper pads to a power of two);
    # an empty swarm is refused.
    spec, _ = library.planar_3dof()
    for bad in (0, -128):
        with pytest.raises(ValueError, match="num_particles"):
            make_fused_solver(spec, num_particles=bad, interpret=True)


# --- The counter-based RNG, evaluated as plain jnp (the kernel runs the
# same functions on its (P,) vectors).


def _draws(seed0=1, seed1=2, slot=0, dof=0, p=4096, p_pad=None):
    p_pad = p_pad or p
    skey = fused.swarm_key(jnp.uint32(seed0), jnp.uint32(seed1))
    dkey = fused.draw_key(skey, slot)
    return np.asarray(
        fused.uniform(dkey, fused.lane_counters(p_pad), dof, p_pad)
    )[:p]


def test_counter_rng_range_and_moments():
    u = np.concatenate([_draws(slot=s, dof=d) for s in range(4) for d in range(9)])
    assert u.dtype == np.float32
    assert (u >= 0.0).all() and (u < 1.0).all()
    n = u.size
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / n)
    assert abs(u.var() - 1 / 12) < 2e-3
    # Uniform over deciles: chi-square with 9 dof well under its 0.1%
    # critical value (27.9).
    counts = np.histogram(u, bins=10, range=(0, 1))[0]
    chi2 = ((counts - n / 10) ** 2 / (n / 10)).sum()
    assert chi2 < 27.9, chi2


@pytest.mark.parametrize(
    "axis", ["swarm", "iteration_slot", "particle", "dof"]
)
def test_counter_rng_independence(axis):
    # Streams that differ in one coordinate of (swarm seed, draw slot,
    # particle, dof) must be uncorrelated and must not coincide.
    if axis == "swarm":
        a, b = _draws(seed0=7), _draws(seed0=8)
    elif axis == "iteration_slot":
        a, b = _draws(slot=3), _draws(slot=4)
    elif axis == "dof":
        a, b = _draws(dof=0), _draws(dof=1)
    else:
        u = _draws(p=8192)
        a, b = u[:-1], u[1:]  # neighbouring particles
    r = np.corrcoef(a, b)[0, 1]
    assert abs(r) < 4 / np.sqrt(a.size), r
    assert np.mean(a == b) < 1e-3


def test_counter_rng_reproducible_and_padding_invariant():
    np.testing.assert_array_equal(_draws(slot=5, dof=2), _draws(slot=5, dof=2))
    # A particle's draws depend on the padded width only through the
    # DOF offset: dof 0 is identical across paddings.
    np.testing.assert_array_equal(_draws(p=96, p_pad=128), _draws(p=96, p_pad=256))


def test_counter_rng_in_kernel_matches_plain():
    # The kernel consumes the shared draw functions with the documented
    # slot layout: rebuilding its stream in plain jnp and injecting it
    # reproduces the hash-driven solve bit for bit.
    spec, problem = library.planar_3dof()
    pso = PSOConfig(iterations=1, init_mode="uniform")
    n_init, dpi = fused.draws_per_iteration(pso)
    assert (n_init, dpi) == (2, 3)
    batched = _batched(problem, 1)
    seeds = jnp.asarray([[11, 22]], jnp.uint32)
    p = 128
    skey = fused.swarm_key(seeds[0, 0], seeds[0, 1])
    lane_g = fused.lane_counters(p)
    U = jnp.stack([
        jnp.stack([
            fused.uniform(fused.draw_key(skey, slot), lane_g, dd, p)
            for dd in range(spec.dof)
        ])
        for slot in range(n_init + dpi * pso.iterations)
    ])[None]
    kw = dict(num_particles=p, interpret=True)
    fit = FitnessConfig()
    swarm = _swarm(spec, batched)
    gh, vh = fused_solve_raw(spec, pso, fit, swarm, seeds, **kw)
    gi, vi = fused_solve_raw(spec, pso, fit, swarm, seeds, uniforms=U, **kw)
    np.testing.assert_array_equal(np.asarray(gh), np.asarray(gi))
    np.testing.assert_array_equal(np.asarray(vh), np.asarray(vi))


# --- The wrapper's shapes: interpret mode does not enforce the Triton
# block rule, so this is the only guard before the chip.


def _is_pow2(n):
    return n > 0 and n & (n - 1) == 0


@pytest.mark.parametrize(
    "model,particles,uniforms",
    [("arm_7dof", 128, False), ("reference_arm", 96, False),
     ("humanoid_45dof", 512, False), ("arm_7dof", 100, True)],
)
def test_wrapper_block_shapes_are_powers_of_two(monkeypatch, model,
                                                particles, uniforms):
    spec, problem = getattr(library, model)()
    s = 2
    batched = _batched(problem, s)
    seen = []
    real = fused.pl.pallas_call

    def spy(kernel, **kw):
        seen.append(kw)
        return real(kernel, **kw)

    monkeypatch.setattr(fused.pl, "pallas_call", spy)
    pso = PSOConfig(iterations=1)
    U = None
    if uniforms:
        n_init, dpi = fused.draws_per_iteration(pso)
        U = jnp.full((s, n_init + dpi, spec.dof, particles), 0.5, jnp.float32)
    g, v = fused_solve_raw(
        spec, pso, FitnessConfig(), _swarm(spec, batched),
        jnp.zeros((s, 2), jnp.uint32), num_particles=particles,
        uniforms=U, interpret=True,
    )
    assert g.shape == (s, spec.dof) and v.shape == (s,)
    (kw,) = seen
    assert kw["grid"] == (s,)
    specs = list(kw["in_specs"]) + list(kw["out_specs"])
    assert len(specs) == 4 + int(uniforms)
    for bs in specs:
        # None dims are squeezed (the fitness block is one scalar).
        dims = [b for b in bs.block_shape if b is not None]
        assert all(_is_pow2(b) for b in dims), bs.block_shape
    # The Triton route, two particles per thread, 1 to 8 warps.
    assert kw["compiler_params"].BACKEND == "triton"
    assert kw["compiler_params"].num_warps == min(
        8, max(1, fused.next_pow2(particles) // 64)
    )


def test_padded_particles_never_gbest():
    # P=100 pads to 128 lanes. The injected stream gives the 28 padded
    # lanes the same kind of draws as real ones, yet the result must
    # equal a 100-particle replay: padded lanes carry +inf fitness.
    spec, problem = library.arm_7dof()
    p = 100
    pso = PSOConfig(iterations=3, init_mode="uniform")
    fit = FitnessConfig(angle_weight=0.0)
    U = _stream(pso, spec.dof, fused.next_pow2(p), 21)
    gb_k, gv_k = _run_injected(spec, problem, pso, fit, U, p)
    gb_r, gv_r, _ = _replay(spec, problem, pso, fit, U[..., :p], p)
    np.testing.assert_allclose(gb_k, gb_r, atol=5e-4)
    np.testing.assert_allclose(gv_k, gv_r, rtol=1e-3, atol=1e-5)


def test_fused_replay_matches_jnp_reference():
    # Full-solve semantic equivalence: the kernel on an injected
    # uniform stream vs the numpy replay scored by ops.fitness.
    # Tolerances absorb float op-order differences between the kernel's
    # FK and the jnp fitness.
    spec, problem = library.arm_7dof()
    p = 256
    pso = PSOConfig(iterations=3, inertia_mode="randomized")
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    U = _stream(pso, spec.dof, p, 5)
    gb_k, gv_k = _run_injected(spec, problem, pso, fit, U, p)
    gb_r, gv_r, _ = _replay(spec, problem, pso, fit, U, p)
    np.testing.assert_allclose(gb_k, gb_r, atol=5e-4)
    np.testing.assert_allclose(gv_k, gv_r, rtol=1e-3, atol=1e-5)


def test_fused_converges_with_hash_rng():
    # Real hash RNG (interpret mode runs it too): PSO must cut the far
    # default target's error (~2.08 at the warm start) dramatically.
    spec, problem = library.arm_7dof()
    batched = _batched(problem, 4)
    solver = make_fused_solver(
        spec,
        pso=PSOConfig(iterations=30),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=1024,
        interpret=True,
    )
    res = solver(batched, jax.random.key(0))
    assert np.median(np.asarray(res.effector_error)) < 0.1
    # Distinct swarms draw distinct streams.
    assert len({tuple(r) for r in np.asarray(res.angles).round(5)}) > 1


def test_fused_replay_with_rekick_matches_reference():
    # Kick iterations must overwrite v with the (last-slot) kick draw
    # BEFORE the velocity update; others are unaffected.
    spec, problem = library.arm_7dof()
    p = 256
    kick_n, kscale = 2, 0.7
    pso = PSOConfig(
        iterations=4, inertia_mode="randomized",
        rekick_interval=kick_n, rekick_scale=kscale,
    )
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    U = _stream(pso, spec.dof, p, 11)
    gb_k, gv_k = _run_injected(spec, problem, pso, fit, U, p)
    gb_r, gv_r, _ = _replay(
        spec, problem, pso, fit, U, p,
        kick=lambda it: it > 0 and it % kick_n == 0,
    )
    np.testing.assert_allclose(gb_k, gb_r, atol=5e-4)
    np.testing.assert_allclose(gv_k, gv_r, rtol=1e-3, atol=1e-5)


def test_fused_rekick_threshold_gates_kick():
    # With perfect targets (gbest fitness exactly 0 from init) and a
    # threshold of 0, NO kick may fire — the solve must equal the
    # re-kick-free kernel bit for bit when fed the same per-iteration
    # draws.
    spec, problem = library.arm_7dof()
    eff = fk_ops.effector_positions(spec, problem.pose, problem.origin)
    problem = problem.replace(targets=eff)
    p, iters = 256, 4
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    base = PSOConfig(iterations=iters, inertia_mode="randomized")
    U3 = _stream(base, spec.dof, p, 2)
    # Per-iteration-4 stream whose first three slots equal U3's.
    u4 = [U3[:, 0]]
    for it in range(iters):
        u4.extend([U3[:, 1 + 3 * it + k] for k in range(3)])
        u4.append(jnp.full((1, spec.dof, p), 0.9, jnp.float32))
    U4 = jnp.stack(u4, axis=1)
    gated = PSOConfig(
        iterations=iters, inertia_mode="randomized",
        rekick_interval=2, rekick_threshold=0.0,
    )
    kicked = PSOConfig(
        iterations=iters, inertia_mode="randomized",
        rekick_interval=2, rekick_threshold=-1.0,
    )
    gb0, gv0 = _run_injected(spec, problem, base, fit, U3, p)
    gb1, gv1 = _run_injected(spec, problem, gated, fit, U4, p)
    np.testing.assert_array_equal(gb0, gb1)
    assert gv0 == gv1
    # The unconditional kick changes the particles, but gbest stays
    # the perfect anchor.
    _, gv2 = _run_injected(spec, problem, kicked, fit, U4, p)
    assert gv2 == 0.0


def test_fused_replay_with_obstacles_matches_jnp_reference():
    # The in-kernel SAT rejection must penalize exactly the poses
    # ops.fitness penalizes, so the whole trajectory — including which
    # local bests freeze at the penalty — matches the jnp oracle.
    from ikpso.models.chain import Obstacles

    spec, problem = library.arm_7dof()
    obstacles = Obstacles.from_boxes(
        jnp.asarray([[0.9, 0.9, 0.0], [-0.8, 0.4, 0.7]], jnp.float32),
        jnp.asarray([[0.5, 0.5, 0.5], [0.6, 0.6, 0.6]], jnp.float32),
    )
    p = 1024
    pso = PSOConfig(iterations=3, inertia_mode="randomized")
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    U = _stream(pso, spec.dof, p, 7)
    gb_k, gv_k = _run_injected(spec, problem, pso, fit, U, p, obstacles)
    gb_r, gv_r, saw_penalty = _replay(spec, problem, pso, fit, U, p, obstacles)
    # The scene must actually reject some explored poses, or this test
    # proves nothing about the collision path.
    assert saw_penalty
    np.testing.assert_allclose(gb_k, gb_r, atol=5e-4)
    np.testing.assert_allclose(gv_k, gv_r, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("init_mode", ["uniform", "hybrid"])
def test_fused_replay_init_modes_match_reference(init_mode):
    # Slot 0 is the init position draw (U over the ±2π-clamped joint
    # range), slot 1 the velocity draw; hybrid pins particle 0 to the
    # warm anchor.
    spec, problem = library.arm_7dof()
    p = 256
    pso = PSOConfig(iterations=3, inertia_mode="randomized", init_mode=init_mode)
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    U = _stream(pso, spec.dof, p, 7)
    gb_k, gv_k = _run_injected(spec, problem, pso, fit, U, p)
    gb_r, gv_r, _ = _replay(spec, problem, pso, fit, U, p)
    np.testing.assert_allclose(gb_k, gb_r, atol=5e-4)
    np.testing.assert_allclose(gv_k, gv_r, rtol=1e-3, atol=1e-5)


def test_fused_solver_refuses_gjk_backend():
    # No silent SAT fallback in the megakernel.
    from ikpso.models.chain import Obstacles

    spec, problem = library.planar_3dof()
    obstacles = Obstacles.from_boxes([(1.5, 0.5, 0.0)], [(1.0, 1.0, 1.0)])
    with pytest.raises(NotImplementedError, match="gjk"):
        make_fused_solver(
            spec, fit=FitnessConfig(collision_backend="gjk"),
            obstacles=obstacles, interpret=True,
        )
    # Obstacle-free configs never evaluate the backend.
    make_fused_solver(
        spec, fit=FitnessConfig(collision_backend="gjk"), interpret=True
    )


def test_fused_solver_capsule_obstacles():
    # Capsule colliders: a far obstacle leaves the anchor's
    # zero-fitness gbest intact; one wrapping the whole arm penalizes
    # every pose the swarm can reach.
    from ikpso.models.chain import Obstacles

    spec, problem = library.arm_7dof()
    eff = fk_ops.effector_positions(spec, problem.pose, problem.origin)
    problem = problem.replace(targets=eff)
    batched = _batched(problem, 2)
    fit = FitnessConfig(angle_weight=0.0, collision_shape="capsule")

    far = Obstacles.from_boxes([(5.0, 5.0, 5.0)], [(0.5, 0.5, 0.5)])
    solver = make_fused_solver(
        spec, pso=PSOConfig(iterations=2), fit=fit, obstacles=far,
        num_particles=256, interpret=True,
    )
    res = solver(batched, jax.random.key(0))
    np.testing.assert_allclose(np.asarray(res.fitness), 0.0, atol=1e-9)

    reach = float(np.abs(np.asarray(spec.length)).sum())
    wrap = Obstacles.from_boxes(
        [np.asarray(problem.origin, float).tolist()],
        [(2 * reach, 2 * reach, 2 * reach)],
    )
    solver2 = make_fused_solver(
        spec, pso=PSOConfig(iterations=2), fit=fit, obstacles=wrap,
        num_particles=256, interpret=True,
    )
    res2 = solver2(batched, jax.random.key(0))
    assert (np.asarray(res2.fitness) >= 1e30).all()


@pytest.mark.gpu
def test_fused_deep_chain_multirow_output(gpu):
    # A 129-DOF chain: anchor-exact targets must survive as gbest for
    # every one of the 129 DOF (the interpreter's compile of this
    # kernel takes far too long on a CPU).
    spec, problem = library.snake(43)  # 129 DOF
    assert spec.dof == 129
    eff = fk_ops.effector_positions(spec, problem.pose, problem.origin)
    problem = problem.replace(targets=eff)
    batched = _batched(problem, 8)
    solver = make_fused_solver(
        spec,
        pso=PSOConfig(iterations=2),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=128,
    )
    res = solver(batched, jax.random.key(0))
    assert res.angles.shape == (8, 129)
    assert float(np.asarray(res.fitness).max()) < 1e-7
    anchor = np.asarray(fk_ops.pose_to_angles(spec, problem.pose))
    np.testing.assert_allclose(
        np.asarray(res.angles), anchor[None].repeat(8, 0), atol=1e-6
    )


def test_fused_replay_humanoid_tree_matches_jnp_reference():
    # The in-kernel tree walk on a MULTI-LEVEL branching topology (two
    # interior nodes with 3 children each).
    spec, problem = library.humanoid_45dof()
    assert spec.dof == 45 and spec.num_nodes == 16
    p = 128
    pso = PSOConfig(iterations=2, inertia_mode="randomized")
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    U = _stream(pso, spec.dof, p, 11)
    gb_k, gv_k = _run_injected(spec, problem, pso, fit, U, p)
    gb_r, gv_r, _ = _replay(spec, problem, pso, fit, U, p)
    np.testing.assert_allclose(gb_k, gb_r, atol=5e-4)
    np.testing.assert_allclose(gv_k, gv_r, rtol=1e-3, atol=1e-5)
