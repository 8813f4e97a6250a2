"""Retry-on-failure wrapper (ikpso.pso.restarts)."""

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models import library
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig
from ikpso.pso.restarts import make_retry_solver, solve_with_retries
from ikpso.pso.solver import make_solver


def _setup(s=12):
    spec, problem = library.planar_3dof(target=(1.5, 1.5, 0.0))
    rng = np.random.RandomState(3)
    targets = jnp.asarray(
        np.asarray(problem.targets)[None] + rng.uniform(-0.4, 0.4, (s, 1, 3)) *
        np.asarray([1.0, 1.0, 0.0]),
        jnp.float32,
    )
    return spec, library.batched_problem(problem, targets)


def test_retry_rescues_failed_swarms():
    spec, batched = _setup()
    fit = FitnessConfig(angle_weight=0.0)
    # Base solver too weak to converge; retry solver strong.
    weak = make_solver(spec, pso=PSOConfig(iterations=1), fit=fit,
                       num_particles=64)
    strong = make_solver(spec, pso=PSOConfig(iterations=80), fit=fit,
                         num_particles=256)
    base = weak(batched, jax.random.key(0))
    base_err = np.asarray(base.effector_error)
    assert (base_err > 0.05).any()  # premise: weak solver fails some

    res = solve_with_retries(
        weak, batched, jax.random.key(0),
        err_threshold=0.05, max_rounds=1, bucket=4, retry_solver=strong,
    )
    err = np.asarray(res.effector_error)
    # Retried rows improved dramatically; no row got worse.
    assert (err <= base_err + 1e-7).all()
    assert np.median(err) < np.median(base_err)
    assert (err < 0.05).mean() > (base_err < 0.05).mean()


def test_retry_noop_when_all_converged():
    spec, batched = _setup(s=4)
    fit = FitnessConfig(angle_weight=0.0)
    solver = make_solver(spec, pso=PSOConfig(iterations=60), fit=fit,
                         num_particles=256)
    res0 = solver(batched, jax.random.key(1))
    wrapped = make_retry_solver(solver, err_threshold=1e9)  # nothing fails
    res1 = wrapped(batched, jax.random.key(1))
    np.testing.assert_array_equal(
        np.asarray(res0.angles), np.asarray(res1.angles)
    )


def test_topk_retry_is_jitted_and_rescues():
    from ikpso.pso.restarts import make_topk_retry_solver

    spec, batched = _setup(s=12)
    fit = FitnessConfig(angle_weight=0.0)
    weak = make_solver(spec, pso=PSOConfig(iterations=1), fit=fit,
                       num_particles=64)
    strong = make_solver(spec, pso=PSOConfig(iterations=80), fit=fit,
                         num_particles=256)
    base_err = np.asarray(weak(batched, jax.random.key(4)).effector_error)

    wrapped = make_topk_retry_solver(
        weak, bucket=4, err_threshold=0.05, rounds=2, retry_solver=strong,
    )
    res = wrapped(batched, jax.random.key(4))
    err = np.asarray(res.effector_error)
    # Only ever replaces with strictly-better results; two rounds of
    # 4-worst retries must lift the success rate.
    assert (err <= base_err + 1e-7).all()
    assert (err < 0.05).mean() > (base_err < 0.05).mean()
    # Deterministic under jit: same key -> same result.
    res2 = wrapped(batched, jax.random.key(4))
    np.testing.assert_array_equal(np.asarray(res2.angles), np.asarray(res.angles))


def test_topk_retry_keeps_converged_rows_bit_stable():
    from ikpso.pso.restarts import make_topk_retry_solver

    spec, batched = _setup(s=6)
    fit = FitnessConfig(angle_weight=0.0)
    solver = make_solver(spec, pso=PSOConfig(iterations=60), fit=fit,
                         num_particles=256)
    res0 = solver(batched, jax.random.key(5))
    wrapped = make_topk_retry_solver(solver, bucket=3, err_threshold=1e9)
    res1 = wrapped(batched, jax.random.key(5))
    # err_threshold=inf: no row may be touched even though the bucket
    # re-solved the 3 worst.
    np.testing.assert_array_equal(
        np.asarray(res0.angles), np.asarray(res1.angles)
    )


def test_retry_bucket_padding_and_chunking():
    # bucket > failures (padding) and bucket < failures (chunking)
    # both preserve monotonic improvement.
    spec, batched = _setup(s=10)
    fit = FitnessConfig(angle_weight=0.0)
    weak = make_solver(spec, pso=PSOConfig(iterations=1), fit=fit,
                       num_particles=64)
    strong = make_solver(spec, pso=PSOConfig(iterations=80), fit=fit,
                         num_particles=256)
    base_err = np.asarray(weak(batched, jax.random.key(2)).effector_error)
    for bucket in (3, 64):
        res = solve_with_retries(
            weak, batched, jax.random.key(2),
            err_threshold=0.05, max_rounds=1, bucket=bucket,
            retry_solver=strong,
        )
        err = np.asarray(res.effector_error)
        assert (err <= base_err + 1e-7).all(), bucket
        assert (err < 0.05).mean() >= (base_err < 0.05).mean()


def test_wrap_with_topk_retries_builder_and_bucket_alignment():
    # The builder constructs base + diverse-init retry solvers from one
    # build(); an odd bucket size is used as given.
    from ikpso.pso.restarts import wrap_with_topk_retries

    spec, batched = _setup(s=8)
    fit = FitnessConfig(angle_weight=0.0)
    built_inits = []

    def build(pso_cfg):
        built_inits.append(pso_cfg.init_mode)
        return make_solver(spec, pso=pso_cfg, fit=fit, num_particles=64)

    pso = PSOConfig(iterations=4)
    solver = wrap_with_topk_retries(
        build, pso, rounds=2, bucket=3, retry_init_mode="uniform",
    )
    # Two solvers built: warm base + uniform retry.
    assert built_inits == ["warm", "uniform"]
    res = solver(batched, jax.random.key(0))
    assert np.isfinite(np.asarray(res.effector_error)).all()

    # rounds=0 is a passthrough: exactly one solver, same results.
    built_inits.clear()
    bare = wrap_with_topk_retries(
        build, pso, rounds=0, bucket=3, retry_init_mode="uniform",
    )
    assert built_inits == ["warm"]
    r0 = bare(batched, jax.random.key(0))
    r1 = build(pso)(batched, jax.random.key(0))
    np.testing.assert_array_equal(np.asarray(r0.angles), np.asarray(r1.angles))

    # Same init for retries -> no second build.
    built_inits.clear()
    wrap_with_topk_retries(
        build, pso, rounds=1, bucket=4, retry_init_mode="warm",
    )
    assert built_inits == ["warm"]


def test_wrap_with_topk_retries_deep_retry_budget():
    # retry_iterations deepens only the retry rounds' solver: the base
    # stays at the short budget, the retry solver gets the long one
    # (and drops a now-indivisible rekick interval).
    from ikpso.models import library
    from ikpso.ops.fitness import FitnessConfig
    from ikpso.pso.restarts import wrap_with_topk_retries
    from ikpso.pso.solver import make_solver

    spec, problem = library.planar_3dof()
    batched = library.batched_problem(
        problem, jnp.broadcast_to(problem.targets, (8,) + problem.targets.shape)
    )
    built = []

    def build(pso_cfg):
        built.append((pso_cfg.iterations, pso_cfg.init_mode,
                      pso_cfg.rekick_interval))
        return make_solver(
            spec, pso=pso_cfg, fit=FitnessConfig(angle_weight=0.0),
            num_particles=64,
        )

    pso = PSOConfig(iterations=4, rekick_interval=2, rekick_scale=0.5)
    solver = wrap_with_topk_retries(
        build, pso, rounds=1, bucket=4,
        retry_init_mode="uniform", retry_iterations=11,
    )
    assert built == [(4, "warm", 2), (11, "uniform", 0)]
    res = solver(batched, jax.random.key(0))
    assert np.isfinite(np.asarray(res.effector_error)).all()


def test_target_walk_solver_beats_single_shot():
    # The W-step warm target walk (the reference's own per-frame
    # protocol, Main.cpp:222-227, as one jitted scan) reaches far
    # targets a single warm solve of the same per-step budget misses.
    from ikpso.pso.restarts import wrap_solver_with_target_walk

    spec, batched = _setup(s=12)
    fit = FitnessConfig(angle_weight=0.0)
    solver = make_solver(spec, pso=PSOConfig(iterations=6), fit=fit,
                         num_particles=64)
    walk = wrap_solver_with_target_walk(solver, spec, steps=6)
    base = np.asarray(solver(batched, jax.random.key(0)).effector_error)
    res = walk(batched, jax.random.key(0))
    err = np.asarray(res.effector_error)
    assert np.isfinite(err).all()
    # 6 warm steps of small target jumps solve the easy regime each
    # step; the aggregate must clearly beat one 6-iteration jump.
    assert np.median(err) < np.median(base)
    assert err.max() < 0.05, err
    # Scored against the TRUE targets: pose is consistent with angles.
    # Deterministic: same key, same walk.
    res2 = walk(batched, jax.random.key(0))
    np.testing.assert_array_equal(
        np.asarray(res.angles), np.asarray(res2.angles)
    )


def test_wrap_with_topk_retries_walk_mode():
    # retry_walk_steps: the retry rounds run the warm target walk (and
    # the diverse retry init is ignored — the walk needs its warm
    # start), improving the failed bucket monotonically.
    from ikpso.pso.restarts import wrap_with_topk_retries

    spec, batched = _setup(s=8)
    fit = FitnessConfig(angle_weight=0.0)
    built_inits = []

    def build(pso_cfg):
        built_inits.append(pso_cfg.init_mode)
        return make_solver(spec, pso=pso_cfg, fit=fit, num_particles=64)

    pso = PSOConfig(iterations=4)
    solver = wrap_with_topk_retries(
        build, pso, rounds=2, bucket=4, retry_init_mode="uniform",
        spec=spec, retry_walk_steps=4,
    )
    # ONE build: the walk reuses the warm base solver; the uniform
    # retry init must NOT have produced a second solver.
    assert built_inits == ["warm"]
    base = build(pso)(batched, jax.random.key(3))
    base_err = np.asarray(base.effector_error)
    res = solver(batched, jax.random.key(3))
    err = np.asarray(res.effector_error)
    assert (err <= base_err + 1e-7).all()
    assert np.median(err) < np.median(base_err)

    # retry_iterations still deepens the walk's inner solver.
    built_inits.clear()
    wrap_with_topk_retries(
        build, pso, rounds=1, bucket=4, retry_iterations=9,
        spec=spec, retry_walk_steps=2,
    )
    assert built_inits == ["warm", "warm"]

    # Guard rails: walk without spec, or a degenerate step count.
    import pytest

    from ikpso.pso.restarts import wrap_solver_with_target_walk

    with pytest.raises(ValueError, match="spec"):
        wrap_with_topk_retries(
            build, pso, rounds=1, bucket=4, retry_walk_steps=3,
        )
    with pytest.raises(ValueError, match="steps"):
        wrap_solver_with_target_walk(build(pso), spec, steps=0)


def test_retry_bucket_decay_schedule():
    # bucket_decay shrinks the per-round bucket geometrically (floored
    # at min(bucket, 1024) and tile-aligned); behavior stays monotone
    # and rounds still rescue failures.
    from ikpso.pso.restarts import (
        make_topk_retry_solver,
        wrap_with_topk_retries,
    )

    spec, batched = _setup(s=12)
    fit = FitnessConfig(angle_weight=0.0)

    def build(pso_cfg):
        return make_solver(spec, pso=pso_cfg, fit=fit, num_particles=64)

    pso = PSOConfig(iterations=2)
    base_err = np.asarray(build(pso)(batched, jax.random.key(6)).effector_error)
    solver = wrap_with_topk_retries(
        build, pso, rounds=3, bucket=8, bucket_decay=2,
        retry_iterations=60,
    )
    res = solver(batched, jax.random.key(6))
    err = np.asarray(res.effector_error)
    assert (err <= base_err + 1e-7).all()
    assert (err < 0.05).mean() > (base_err < 0.05).mean()

    # Per-round sequences are honored by make_topk_retry_solver and
    # padded with the last entry when shorter than rounds.
    seq = make_topk_retry_solver(
        build(pso), bucket=[6, 3], rounds=3, err_threshold=0.05,
    )
    res2 = seq(batched, jax.random.key(6))
    assert np.isfinite(np.asarray(res2.effector_error)).all()


def test_topk_retry_starts_from_current_best_pose():
    # retry_start="best" (OPT-IN; measured-regression default is
    # "problem" — see restarts.py) must hand the retry round the
    # CURRENT best pose for the worst rows.
    from ikpso.pso.restarts import make_topk_retry_solver

    from ikpso.pso.solver import SolveResult

    spec, batched = _setup(s=6)
    fit = FitnessConfig(angle_weight=0.0)
    solver = make_solver(spec, pso=PSOConfig(iterations=12), fit=fit,
                         num_particles=64)

    def echo_solver(problem, key):
        # Echo the incoming warm-start pose back as the result pose
        # with error 0, so the merged output exposes what the retry
        # round was handed (the wrapper is jitted — a host-side probe
        # would capture tracers).
        r = solver(problem, key)
        return SolveResult(
            angles=r.angles, fitness=r.fitness, pose=problem.pose,
            effector_error=jnp.zeros_like(r.effector_error),
            trace=r.trace,
        )

    wrapped = make_topk_retry_solver(
        solver, bucket=3, err_threshold=0.0, rounds=1,
        retry_solver=echo_solver, retry_start="best",
    )
    res0 = solver(batched, jax.random.key(7))
    out = wrapped(batched, jax.random.key(7))
    worst = np.argsort(-np.asarray(res0.effector_error))[:3]
    # The echoed rows are the base solve's RESULT poses (current best),
    # not the original batched.pose warm start.
    np.testing.assert_allclose(
        np.asarray(out.pose)[worst], np.asarray(res0.pose)[worst],
        rtol=0, atol=1e-6,
    )
    assert not np.allclose(
        np.asarray(out.pose)[worst], np.asarray(batched.pose)[worst],
        atol=1e-6,
    )

    # DEFAULT ("problem"): the retry is handed the original warm pose.
    wrapped_def = make_topk_retry_solver(
        solver, bucket=3, err_threshold=0.0, rounds=1,
        retry_solver=echo_solver,
    )
    out_def = wrapped_def(batched, jax.random.key(7))
    np.testing.assert_allclose(
        np.asarray(out_def.pose)[worst], np.asarray(batched.pose)[worst],
        rtol=0, atol=1e-6,
    )


def test_walk_retry_keeps_original_pose_and_jitter_varies_path():
    # Walk retries must start from the ORIGINAL warm pose
    # (retry_start="problem"): from-best walks anchor inside the
    # failed basin. Jitter varies the path
    # per key while keeping the final step exact at the true targets.
    from ikpso.pso.restarts import (
        make_topk_retry_solver,
        wrap_solver_with_target_walk,
    )
    from ikpso.pso.solver import SolveResult

    spec, batched = _setup(s=6)
    fit = FitnessConfig(angle_weight=0.0)
    solver = make_solver(spec, pso=PSOConfig(iterations=12), fit=fit,
                         num_particles=64)

    def echo_solver(problem, key):
        r = solver(problem, key)
        return SolveResult(
            angles=r.angles, fitness=r.fitness, pose=problem.pose,
            effector_error=jnp.zeros_like(r.effector_error),
            trace=r.trace,
        )

    wrapped = make_topk_retry_solver(
        solver, bucket=3, err_threshold=0.0, rounds=1,
        retry_solver=echo_solver, retry_start="problem",
    )
    res0 = solver(batched, jax.random.key(7))
    out = wrapped(batched, jax.random.key(7))
    worst = np.argsort(-np.asarray(res0.effector_error))[:3]
    np.testing.assert_allclose(
        np.asarray(out.pose)[worst], np.asarray(batched.pose)[worst],
        rtol=0, atol=1e-6,
    )

    # Jittered walk: still finite and solves (final step exact), and
    # two keys walk different paths -> different results; same key is
    # deterministic.
    walk = wrap_solver_with_target_walk(solver, spec, steps=4, jitter=0.3)
    r1 = walk(batched, jax.random.key(11))
    r2 = walk(batched, jax.random.key(12))
    r1b = walk(batched, jax.random.key(11))
    assert np.isfinite(np.asarray(r1.effector_error)).all()
    # Smoke bound only (tiny 64-particle solver; one hard swarm can
    # land ~0.06): the curve still reaches the true targets overall.
    assert np.median(np.asarray(r1.effector_error)) < 0.01
    assert np.asarray(r1.effector_error).max() < 0.2
    np.testing.assert_array_equal(
        np.asarray(r1.angles), np.asarray(r1b.angles)
    )
    assert not np.array_equal(np.asarray(r1.angles), np.asarray(r2.angles))
