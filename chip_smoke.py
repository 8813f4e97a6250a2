#!/usr/bin/env python
"""Smoke test of the IK solver on one GPU, through its own entry points.

Runs, in one process on one card, each phase printing one JSON line:

  1. the device and the card's name and power limit;
  2. compile + ``memory_analysis`` of the headline program (arm_7dof,
     S = 1,048,576 swarms, the preset recipe);
  3. the megakernel against the plain references at real widths:
     its fitness against ``ops.fitness.fitness`` (65,536 swarms x 128
     particles; plain, orientation, 4-box scene), and an
     injected-uniform replay (S = 1,024, 8 iterations) against a jnp
     re-run of the same trajectory;
  4. the headline through ``bench.run``, with the exact count of
     targets left at or above 1 mm, beside the jnp solver's count at
     the same recipe;
  5. ``cli.main`` solve / track / sweep at small sizes;
  6. convergence with the hash RNG (with re-kick), uniform and hybrid
     init, box and capsule scenes against the jnp fitness, GJK, and the
     solver under a mesh;
  7. timing A/B in turns (kernel, jnp, jnp, kernel): the PSO stage
     alone and the full headline recipe, then the kernel's PSO stage
     with poly vs exact trig.

Any failing phase makes the script exit non-zero; the last line of a
passing run is ``{"ok": true, "device": {...}}``. Without a GPU it
exits non-zero unless ``--cpu`` asks for a host rehearsal (kernels in
interpret mode, small sizes).

  python chip_smoke.py                 # one card, phases 1-7
  python chip_smoke.py --deep-chain    # one card: the 129-DOF megakernel only
  python chip_smoke.py --multichip     # four cards: the mesh paths only
  python chip_smoke.py --ab-models     # per-model kernel vs jnp timing only

The 129-DOF case has its own option because its first compile alone
takes minutes (it ran 437 s on an H100), which would put the default run
near its 1,200 s budget on a machine with a cold compile cache.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

# One process drives the card; the jnp solver at the headline batch
# needs more than JAX's default three quarters of device memory.
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# One-frame source locations: the same kernel traced from two call sites
# (a phase and bench.run) then lowers to identical code and is compiled
# once, the second time read back from the compile cache.
jax.config.update("jax_include_full_tracebacks_in_locations", False)

HEADLINE_S = 1 << 20
FITNESS_S = 65536
REPLAY_S = 1024


class Smoke:
    """Phase runner: every phase runs; any failure fails the script."""

    def __init__(self, cpu: bool):
        self.cpu = cpu
        self.failed = []
        # Host rehearsal: the kernels run in the Pallas interpreter and
        # every batch shrinks.
        self.interpret = cpu
        self.scale = 1 / 1024 if cpu else 1

    def size(self, n: int, floor: int = 8) -> int:
        return max(floor, int(n * self.scale))

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            out = fn() or {}
            rec = {"phase": name, "ok": True, **out}
        except Exception as e:  # reported, and fails the run at the end
            traceback.print_exc()
            self.failed.append(name)
            rec = {"phase": name, "ok": False,
                   "error": f"{type(e).__name__}: {e}"[:2000]}
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(rec, default=float), flush=True)
        return rec


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _timed(fn, *args, warmup=1, iters=3, seed=0):
    """Median seconds of ``fn(problem, key)`` over fresh keys."""
    from ikpso.utils.profiling import measure

    _, t = measure(
        fn, *args, warmup=warmup, iters=iters,
        vary=lambda i, a: (a[0], jax.random.fold_in(a[1], seed + i)),
    )
    return t


def _random_angles(spec, s, p, seed):
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    return jax.random.uniform(jax.random.key(seed), (s, p, spec.dof),
                              minval=lo, maxval=hi, dtype=jnp.float32)


def _compare_fitness(spec, x, batched, fit, obstacles, interpret):
    """Kernel fitness vs ops.fitness at rtol = atol = 2e-4.

    2e-4 covers the kernel's polynomial sincos and its different
    operation order. Collision masks must agree except where a pose is
    tangent to a box: there the last-bit FK differences flip the test,
    so at most 1e-5 of the poses may disagree.
    """
    from ikpso.ops.fitness import COLLISION_PENALTY, fitness
    from ikpso.pso.fused import kernel_fitness

    got = np.asarray(jax.jit(lambda x, b: kernel_fitness(
        spec, x, b, fit, obstacles, interpret=interpret))(x, batched))
    ref = np.asarray(jax.jit(lambda x, b: fitness(
        spec, x, b, config=fit, obstacles=obstacles))(x, batched))
    hit_g, hit_r = got >= COLLISION_PENALTY, ref >= COLLISION_PENALTY
    flips = int((hit_g != hit_r).sum())
    check(flips <= 1e-5 * ref.size, f"{flips} collision flips")
    free = ~hit_g & ~hit_r
    err = np.abs(got[free] - ref[free])
    check(np.all(err <= 2e-4 + 2e-4 * np.abs(ref[free])),
          f"max |diff| {err.max()}")
    return {"n": int(ref.size), "max_abs_diff": float(err.max()),
            "hit_frac": float(hit_r.mean()), "collision_flips": flips}


def _replay_reference(spec, batched, pso, fit, U):
    """jnp re-run of the kernel's trajectory on the injected draws."""
    from ikpso.ops import fk as fk_ops
    from ikpso.ops.fitness import fitness
    from ikpso.pso.fused import draws_per_iteration

    n_init, dpi = draws_per_iteration(pso)
    Ut = jnp.swapaxes(U, -1, -2)  # (S, n_draws, P, D)
    anchor = fk_ops.pose_to_angles(spec, batched.pose)
    s, p = U.shape[0], U.shape[-1]
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    x = jnp.broadcast_to(anchor[:, None, :], (s, p, spec.dof))
    v = (Ut[:, n_init - 1] * 2.0 - 1.0) * pso.init_velocity_scale
    lval = fitness(spec, x, batched, config=fit)
    lbest = x
    w, c1, c2 = (np.float32(pso.inertia), np.float32(pso.cognitive),
                 np.float32(pso.social))

    def best(lbest, lval):
        idx = jnp.argmin(lval, axis=-1)
        return (jnp.take_along_axis(lbest, idx[:, None, None], axis=1),
                jnp.take_along_axis(lval, idx[:, None], axis=1)[:, 0])

    for it in range(pso.iterations):
        gb, _ = best(lbest, lval)
        base = n_init + dpi * it
        u_c, u_s, u_w = Ut[:, base], Ut[:, base + 1], Ut[:, base + 2]
        v = w * u_w * v + c1 * u_c * (lbest - x) + c2 * u_s * (gb - x)
        x = jnp.clip(x + v, lo, hi)
        f = fitness(spec, x, batched, config=fit)
        m = f < lval
        lval = jnp.where(m, f, lval)
        lbest = jnp.where(m[..., None], x, lbest)
    gb, gv = best(lbest, lval)
    return gb[:, 0], gv


def run_single(sm: Smoke):
    import bench
    from ikpso.harness import cli
    from ikpso.models import library
    from ikpso.models.chain import Obstacles
    from ikpso.ops import fk as fk_ops
    from ikpso.ops.fitness import FitnessConfig, fitness
    from ikpso.ops.tile_fitness import pack_swarm
    from ikpso.pso import fused
    from ikpso.pso.config import PSOConfig
    from ikpso.pso.fused import make_fused_solver

    spec, problem = library.arm_7dof()
    s_head = sm.size(HEADLINE_S, 1024)
    recipe = bench.preset_recipe("arm_7dof")
    batched_head, _ = bench.sample_targets(spec, problem, s_head)
    key = jax.random.key(1)

    def compile_headline():
        solver = bench.build_solver(spec, recipe, s_head)
        compiled = solver.lower(batched_head, key).compile()
        print(compiled.memory_analysis(), flush=True)
        return {"swarms": s_head, "impl": recipe.impl,
                **bench.memory_stats(compiled)}

    sm.phase("headline_compile_memory", compile_headline)

    def fitness_comparisons():
        s = sm.size(FITNESS_S)
        batched, _ = bench.sample_targets(spec, problem, s, orientation=True)
        x = _random_angles(spec, s, 128, seed=2)
        plain = batched.replace(target_rot=None)
        out = {"swarms": s, "particles": 128}
        out["plain"] = _compare_fitness(
            spec, x, plain, FitnessConfig(), None, sm.interpret)
        out["orientation"] = _compare_fitness(
            spec, x, batched, FitnessConfig(orientation_weight=1.0), None,
            sm.interpret)
        out["box4"] = _compare_fitness(
            spec, x, plain, FitnessConfig(), bench.obstacle_scene(spec, 4),
            sm.interpret)
        check(out["box4"]["hit_frac"] > 0.01, "the scene must reject poses")
        return out

    sm.phase("kernel_fitness_vs_jnp", fitness_comparisons)

    def replay():
        s, p = sm.size(REPLAY_S), 128
        pso = PSOConfig(iterations=8)
        fit = FitnessConfig(angle_weight=0.0)
        batched, _ = bench.sample_targets(spec, problem, s, seed=3)
        n_init, dpi = fused.draws_per_iteration(pso)
        U = jax.random.uniform(jax.random.key(4),
                               (s, n_init + dpi * pso.iterations, spec.dof, p))
        swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                           fk_ops.fk_points(spec, batched.pose, batched.origin))
        gk, vk = jax.jit(lambda sw, u: fused.fused_solve_raw(
            spec, pso, fit, sw, jnp.zeros((s, 2), jnp.uint32),
            num_particles=p, uniforms=u, interpret=sm.interpret))(swarm, U)
        gr, vr = jax.jit(lambda b, u: _replay_reference(spec, b, pso, fit, u))(
            batched, U)
        gk, vk, gr, vr = map(np.asarray, (gk, vk, gr, vr))
        d_ang = np.abs(gk - gr).max(axis=-1)
        d_val = np.abs(vk - vr) - 1e-3 * np.abs(vr)
        out = {"swarms": s, "iterations": pso.iterations,
               "max_angle_diff": float(d_ang.max()),
               "swarms_angle_over_5e-4": int((d_ang > 5e-4).sum()),
               "max_rel_fitness_diff": float(
                   (np.abs(vk - vr) / np.maximum(np.abs(vr), 1e-12)).max())}
        check(np.all(d_ang <= 5e-4), "gbest angles beyond atol 5e-4")
        check(np.all(d_val <= 1e-5), "gbest fitness beyond rtol 1e-3")
        return out

    sm.phase("kernel_replay_vs_jnp", replay)

    def headline():
        rec = bench.run(["--swarms", str(s_head)] + (["--cpu"] if sm.cpu else []))
        rec_jnp = bench.run(["--swarms", str(s_head), "--impl", "jnp"]
                            + (["--cpu"] if sm.cpu else []))
        out = {k: rec[k] for k in (
            "metric", "value", "unit", "impl", "swarms", "wall_ms_per_solve_batch",
            "frac_under_1mm", "n_fail_1mm", "n_scored", "p50_err_mm",
            "p90_err_mm", "platform", "device_kind", "gpu_name", "power_limit",
            "mem_temp_bytes", "compile_s")}
        out["jnp"] = {k: rec_jnp[k] for k in (
            "value", "wall_ms_per_solve_batch", "frac_under_1mm", "n_fail_1mm",
            "mem_temp_bytes", "compile_s")}
        check(rec["platform"] == ("cpu" if sm.cpu else "gpu"), rec["platform"])
        check(rec["frac_under_1mm"] >= 0.9999,
              f"frac_under_1mm {rec['frac_under_1mm']} < 0.9999")
        return out

    sm.phase("headline_bench", headline)

    def cli_commands():
        flags = ["--cpu"] if sm.cpu else []
        out = {}
        for name, argv in [
            ("solve", ["solve", "--model", "arm_7dof", "--preset"]),
            ("track", ["track", "--model", "arm_7dof", "--steps", "16",
                       "--paths", "64", "--particles", "256",
                       "--iterations", "15", "--inertia-mode", "canonical",
                       "--angle-weight", "0.3", "--radius", "0.15",
                       "--revolutions", "0.25"]),
            ("sweep", ["sweep", "--model", "arm_7dof", "--preset",
                       "--waypoints", "4096", "--batch", "1024"]),
        ]:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + flags)
            check(rc == 0, f"{name} rc={rc}")
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            out[name] = rec
        check(out["solve"]["effector_error"] < 5e-2, out["solve"])
        check(out["track"]["err_p50_settled"] < 5e-2, out["track"])
        check(out["sweep"]["err_p50"] < 1e-2, out["sweep"])
        return out

    sm.phase("cli_solve_track_sweep", cli_commands)

    def batched_same(problem_, s):
        return library.batched_problem(
            problem_, jnp.broadcast_to(problem_.targets, (s,) + problem_.targets.shape))

    def rng_convergence():
        out = {}
        for init in ("warm", "uniform", "hybrid"):
            # The warm case also exercises the in-kernel re-kick.
            kick = dict(rekick_interval=10, rekick_scale=0.5,
                        rekick_threshold=1e-6) if init == "warm" else {}
            solver = make_fused_solver(
                spec, pso=PSOConfig(iterations=30, init_mode=init, **kick),
                fit=FitnessConfig(angle_weight=0.0), num_particles=1024,
                interpret=sm.interpret)
            res = solver(batched_same(problem, 8), jax.random.key(5))
            med = float(np.median(np.asarray(res.effector_error)))
            spread = float(np.std(np.asarray(res.angles), axis=0).max())
            check(med < 0.1, f"{init}: median error {med}")
            check(spread > 1e-3, f"{init}: swarms did not spread")
            out[init] = {"median_err": med, "angle_spread": spread}
        return out

    sm.phase("selftest_rng_and_init_modes", rng_convergence)

    def scenes():
        s = sm.size(4096)
        batched, _ = bench.sample_targets(spec, problem, s, seed=6)
        x = _random_angles(spec, s, 128, seed=7)
        box = Obstacles.from_boxes([(1.2, 0.6, -0.4), (-0.8, -0.9, 0.3)],
                                   [(0.8, 0.8, 0.8), (0.7, 0.7, 0.7)])
        out = {
            "box": _compare_fitness(spec, x, batched, FitnessConfig(), box,
                                    sm.interpret),
            "capsule": _compare_fitness(
                spec, x, batched, FitnessConfig(collision_shape="capsule"),
                box, sm.interpret),
        }
        # GJK (fixed-iteration loop) compiled for the device agrees with
        # SAT; disagreement only at tangency.
        f_sat = jax.jit(lambda x, b: fitness(
            spec, x, b, config=FitnessConfig(collision_backend="sat"),
            obstacles=box))(x[:, :32], batched)
        f_gjk = jax.jit(lambda x, b: fitness(
            spec, x, b, config=FitnessConfig(collision_backend="gjk"),
            obstacles=box))(x[:, :32], batched)
        hs, hg = np.asarray(f_sat) >= 1e30, np.asarray(f_gjk) >= 1e30
        agree = float((hs == hg).mean())
        check(hs.any() and (~hs).any(), "scene must both hit and miss")
        check(agree > 0.995, f"GJK/SAT agreement {agree}")
        out["gjk_sat_agreement"] = agree
        return out

    sm.phase("selftest_scenes_gjk", scenes)

    def on_mesh():
        from ikpso.parallel.mesh import make_mesh
        from ikpso.parallel.sharded import solve_sharded

        mesh = make_mesh((1,), ("swarm",), devices=jax.devices()[:1])
        kw = dict(pso=PSOConfig(iterations=8), fit=FitnessConfig(angle_weight=0.0),
                  num_particles=128)
        b = batched_same(problem, 64)
        k = jax.random.key(2)
        r_mesh = solve_sharded(spec, b, k, mesh, impl="fused",
                               interpret=sm.interpret, **kw)
        r_local = make_fused_solver(spec, interpret=sm.interpret, **kw)(
            b, jax.random.fold_in(k, 0))
        np.testing.assert_array_equal(np.asarray(r_mesh.angles),
                                      np.asarray(r_local.angles))
        return {"swarms": 64, "bit_equal": True}

    sm.phase("selftest_solver_under_mesh", on_mesh)

    if sm.cpu:
        return  # timings only mean something on the card

    def timing_ab():
        out = {}
        stages = {}
        for impl in ("fused", "jnp"):
            r = bench.preset_recipe("arm_7dof", impl)
            stages[impl] = {
                "pso": bench.build_solver(spec, r, s_head, stage="pso"),
                "full": bench.build_solver(spec, r, s_head),
            }
        for stage in ("pso", "full"):
            turns = []
            for impl in ("fused", "jnp", "jnp", "fused"):
                turns.append((impl, _timed(stages[impl][stage], batched_head,
                                           key, seed=100 * len(turns))))
            out[stage] = {
                "turns_ms": [[i, t * 1e3] for i, t in turns],
                "fused_ms": float(np.mean([t for i, t in turns if i == "fused"]) * 1e3),
                "jnp_ms": float(np.mean([t for i, t in turns if i == "jnp"]) * 1e3),
            }
            out[stage]["speedup"] = out[stage]["jnp_ms"] / out[stage]["fused_ms"]
        del stages
        # The kernel's trig on the PSO stage (the default is poly).
        pso_ms = {}
        for t in ("poly", "exact"):
            r = bench.preset_recipe("arm_7dof", "fused", trig_impl=t)
            pso_ms[t] = bench.build_solver(spec, r, s_head, stage="pso")
        order = ("poly", "exact", "exact", "poly")
        turns = [(n, _timed(pso_ms[n], batched_head, key, seed=900 + j))
                 for j, n in enumerate(order)]
        out["pso_stage_variants_ms"] = {
            n: float(np.mean([t for m, t in turns if m == n]) * 1e3)
            for n in pso_ms}
        out["swarms"] = s_head
        return out

    sm.phase("timing_ab_headline", timing_ab)


def run_deep_chain(sm: Smoke):
    """The megakernel on a 129-DOF serial chain (snake:43)."""
    from ikpso.models import library
    from ikpso.ops import fk as fk_ops
    from ikpso.ops.fitness import FitnessConfig
    from ikpso.pso.config import PSOConfig
    from ikpso.pso.fused import make_fused_solver

    def deep_chain():
        # 129 DOF on the card; the rehearsal's interpreter takes a short
        # chain (its 129-DOF compile runs far too long on a CPU). One
        # compiled program (kernel + LM polish) serves both halves of
        # the batch: 8 swarms whose targets sit exactly at the anchor
        # pose's effectors (the warm-start particle has fitness ~0 and
        # must survive as gbest across all 129 DOF), and 8 whose targets
        # come from a slightly perturbed pose (a genuine solve).
        from ikpso.pso.polish import wrap_with_polish

        links = 4 if sm.cpu else 43
        spec_d, problem_d = library.snake(links)
        anchor = fk_ops.pose_to_angles(spec_d, problem_d.pose)
        d_angles = jax.random.uniform(jax.random.key(88), (8, spec_d.dof),
                                      minval=-0.002, maxval=0.002)
        angles = jnp.concatenate([jnp.broadcast_to(anchor, (8, spec_d.dof)),
                                  anchor[None] + d_angles])
        pose = fk_ops.angles_to_pose(
            spec_d, jnp.broadcast_to(problem_d.pose[0], (16, 3)), angles)
        tg = fk_ops.fk_points(spec_d, pose, problem_d.origin)[
            :, list(spec_d.effector_idx), :]
        solver = make_fused_solver(spec_d, pso=PSOConfig(iterations=2),
                                   fit=FitnessConfig(angle_weight=0.0),
                                   num_particles=128, interpret=sm.interpret)
        sv = wrap_with_polish(solver, spec_d, steps=16)
        res = sv(library.batched_problem(problem_d, tg), jax.random.key(9))
        check(res.angles.shape == (16, spec_d.dof), res.angles.shape)
        fit_exact = float(np.asarray(res.fitness)[:8].max())
        check(fit_exact < 1e-7, f"anchor-exact gbest fitness {fit_exact}")
        errs = np.asarray(res.effector_error)
        check(errs.max() < 1e-3, f"deep solve max error {errs.max()}")
        return {"dof": spec_d.dof, "anchor_exact_max_fitness": fit_exact,
                "solved_max_err": float(errs[8:].max())}

    sm.phase("deep_chain_129dof", deep_chain)


def run_ab_models(sm: Smoke):
    """Kernel vs jnp per preset model, in turns, at a batch both fit."""
    import bench
    from ikpso.pso.presets import FUSED_PRESETS

    s = 16384
    for model in FUSED_PRESETS:
        def ab(model=model):
            spec, problem = bench.load_model(model)
            batched, _ = bench.sample_targets(spec, problem, s)
            key = jax.random.key(3)
            out = {"swarms": s}
            for stage in ("pso", "full"):
                solvers = {i: bench.build_solver(
                    spec, bench.preset_recipe(model, i), s, stage=stage)
                    for i in ("fused", "jnp")}
                turns = [(i, _timed(solvers[i], batched, key, seed=10 * j))
                         for j, i in enumerate(("fused", "jnp", "jnp", "fused"))]
                f = float(np.mean([t for i, t in turns if i == "fused"]) * 1e3)
                j = float(np.mean([t for i, t in turns if i == "jnp"]) * 1e3)
                out[stage] = {"fused_ms": f, "jnp_ms": j, "speedup": j / f}
            res = solvers["fused"](batched, key)
            err = np.asarray(res.effector_error) * 1e3
            out["fused_full_n_fail_1mm"] = int((~(err < 1.0)).sum())
            return out

        sm.phase(f"ab_{model}", ab)


def run_multichip(sm: Smoke):
    """The mesh paths on four cards, each against its one-card twin."""
    import bench
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ikpso.models import library
    from ikpso.parallel.mesh import hybrid_mesh, make_mesh
    from ikpso.parallel.sharded import distributed_argmin, make_sharded_solver
    from ikpso.pso.polish import wrap_with_polish
    from ikpso.pso.restarts import make_topk_retry_solver

    n = len(jax.devices())
    check(n == 4, f"--multichip needs 4 devices, found {n}")
    spec, problem = library.arm_7dof()
    recipe = bench.preset_recipe("arm_7dof")
    s = sm.size(HEADLINE_S // 4, 1024)
    batched, _ = bench.sample_targets(spec, problem, s, seed=11)
    key = jax.random.key(12)

    def sharded_solve():
        pso, fit = bench.pso_config(recipe), bench.fitness_config(recipe)
        kw = dict(pso=pso, fit=fit, num_particles=recipe.particles,
                  impl=recipe.impl, interpret=sm.interpret)
        mesh = make_mesh((n,), ("swarm",))
        one = make_mesh((1,), ("swarm",), devices=jax.devices()[:1])
        out = {"swarms": s, "impl": recipe.impl, "devices": n}
        for name, m in (("mesh4", mesh), ("one_card", one)):
            sv = wrap_with_polish(make_sharded_solver(spec, m, **kw), spec,
                                  steps=recipe.polish)
            sv = jax.jit(make_topk_retry_solver(sv, bucket=max(1024, s // 32),
                                                rounds=1))
            err = np.asarray(sv(batched, key).effector_error) * 1e3
            out[name] = {"n_fail_1mm": int((~(err < 1.0)).sum()),
                         "frac_under_1mm": float((err < 1.0).mean()),
                         "ms": _timed(sv, batched, key) * 1e3}
        # Shards draw other RNG streams than the one-card solve, so the
        # failure counts are judged as two binomial samples: the mesh
        # may not exceed the one-card count by more than 3 sigma.
        n4, n1 = out["mesh4"]["n_fail_1mm"], out["one_card"]["n_fail_1mm"]
        check(n4 <= n1 + 3 * np.sqrt(n1 + n4 + 1) + 1, out)
        return out

    sm.phase("multichip_swarm_mesh_solve", sharded_solve)

    def hybrid_argmin():
        mesh = hybrid_mesh(2)  # (swarm 2, particle 2)
        s2, p, d = 64, 256, spec.dof
        rng = np.random.default_rng(13)
        vals = rng.uniform(0, 1, (s2, p)).astype(np.float32)
        vals[:8, 10] = vals[:8, 200] = -1.0  # exact ties across shards
        coords = rng.normal(size=(s2, p, d)).astype(np.float32)

        def local_then_global(v, c):
            idx = jnp.argmin(v, axis=-1)
            bv = jnp.take_along_axis(v, idx[:, None], axis=-1)[:, 0]
            bc = jnp.take_along_axis(c, idx[:, None, None], axis=1)[:, 0]
            return distributed_argmin(bv, bc, "particle")

        fn = jax.jit(jax.shard_map(
            local_then_global, mesh=mesh,
            in_specs=(P("swarm", "particle"), P("swarm", "particle", None)),
            out_specs=(P("swarm"), P("swarm", None)), check_vma=False))
        gv, gc = fn(
            jax.device_put(vals, NamedSharding(mesh, P("swarm", "particle"))),
            jax.device_put(coords, NamedSharding(mesh, P("swarm", "particle", None))))
        dev0 = jax.devices()[0]
        v0, c0 = jax.device_put(vals, dev0), jax.device_put(coords, dev0)
        idx = jnp.argmin(v0, axis=-1)
        rv = jnp.take_along_axis(v0, idx[:, None], axis=-1)[:, 0]
        rc = jnp.take_along_axis(c0, idx[:, None, None], axis=1)[:, 0]
        np.testing.assert_array_equal(np.asarray(gv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(rc))
        return {"mesh": dict(mesh.shape), "swarms": s2, "particles": p,
                "exact_match": True}

    sm.phase("multichip_hybrid_distributed_argmin", hybrid_argmin)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="four cards: the mesh solve and the hybrid mesh's "
                    "distributed argmin, nothing else")
    ap.add_argument("--ab-models", action="store_true",
                    help="per-model kernel vs jnp timing, nothing else")
    ap.add_argument("--deep-chain", action="store_true",
                    help="the 129-DOF megakernel case, nothing else")
    ap.add_argument("--cpu", action="store_true",
                    help="host rehearsal: interpret-mode kernels, small sizes")
    args = ap.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        print(f"error: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1

    import bench
    from ikpso.utils.cache import enable_compile_cache

    enable_compile_cache()
    sm = Smoke(args.cpu)
    card = bench.card_info()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if card["nvidia_smi"]:
        print(card["nvidia_smi"], flush=True)
    sm.phase("device", lambda: {**device, **card,
                                "jax": jax.__version__})
    if args.multichip:
        run_multichip(sm)
    elif args.ab_models:
        run_ab_models(sm)
    elif args.deep_chain:
        run_deep_chain(sm)
    else:
        run_single(sm)
    if sm.failed:
        print(f"failed phases: {sm.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
