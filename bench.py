#!/usr/bin/env python
"""Headline benchmark: batched 7-DOF IK solves/s on one GPU, to <1 mm.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., ...extras}

Protocol: S reachable targets are sampled by FK of random in-limit
joint angles (guaranteed solvable); one batched solve with the model's
recipe (pso/presets.py: a short PSO stage, LM polish, top-k retry
rounds) from the canonical pose must bring them under 1 mm. Wall time
is the median of timed calls of the compiled program; solves/s =
S / wall. ``frac_under_1mm`` comes with ``n_fail_1mm``, the exact
count of targets left at or above 1 mm.

Every record names the device it ran on (platform, device kind and
count, and the card's name and power limit from ``nvidia-smi``). The
benchmark needs a GPU: without one it exits non-zero, unless ``--cpu``
asks for a host run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_T0 = time.time()


def _progress(msg: str) -> None:
    """Stderr breadcrumb with elapsed seconds (compile vs run vs hang)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def card_info() -> dict:
    """The GPU's name and power limit, from an ``nvidia-smi`` child.

    The child does not import JAX, so it takes no device memory. A card
    may be set below its maximum power and then runs slower under load,
    so every number is kept beside this. Absent ``nvidia-smi`` (a host
    run) the fields are None.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {"gpu_name": None, "power_limit": None, "nvidia_smi": None}
    name, _, limit = out[0].partition(",") if out else ("", "", "")
    return {
        "gpu_name": name.strip() or None,
        "power_limit": limit.strip() or None,
        "nvidia_smi": out[0] if out else None,
    }


def device_info() -> dict:
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
    }


def select_platform(cpu: bool) -> None:
    """``--cpu`` pins the host backend; otherwise a GPU must be present."""
    if cpu:
        jax.config.update("jax_platforms", "cpu")
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"error: no GPU found (JAX platform {platform!r}); pass --cpu "
            "for a host run"
        )


def obstacle_scene(spec, n):
    """A deterministic n-box scene scaled to the chain's reach.

    Boxes ring the workspace at 0.55x reach, alternating above/below
    the XY plane, each 15% of reach on a side — close enough that a
    measurable fraction of random in-limit poses collide (so the SAT
    term genuinely constrains the solve), far enough that most targets
    keep a collision-free solution. The reference's analog is the 4
    hardcoded scene boxes of its initColliders (reference
    Main.cpp:537-559, disabled in its shipped config).
    """
    from ikpso.models.chain import Obstacles

    reach = float(np.abs(np.asarray(spec.length)).sum())
    ang = np.arange(n) * (2.0 * np.pi / max(n, 1)) + 0.4
    r = 0.55 * reach
    centers = np.stack(
        [
            r * np.cos(ang),
            r * np.sin(ang),
            0.3 * reach * np.where(np.arange(n) % 2 == 0, 1.0, -1.0),
        ],
        axis=-1,
    ).astype(np.float32)
    dims = np.full((n, 3), 0.15 * reach, np.float32)
    return Obstacles.from_boxes(jnp.asarray(centers), jnp.asarray(dims))


def load_model(model: str):
    from ikpso.models import library

    if model.startswith("snake:"):
        return library.snake(int(model.split(":", 1)[1]))
    return getattr(library, model)()


def sample_targets(spec, problem, s: int, *, orientation=False,
                   obstacles=None, seed: int = 0):
    """S reachable targets (FK of random in-limit poses).

    Returns ``(batched_problem, feasible)``: with a scene, ``feasible``
    marks targets whose GENERATING pose is collision-free (a known
    collision-free solution exists) — accuracy is scored on those only,
    since blocked targets would put an error floor under the
    percentiles that says nothing about the solver. Otherwise None.
    """
    from ikpso.models.library import batched_problem
    from ikpso.ops import fk as fk_ops

    key_t = jax.random.split(jax.random.key(seed))[0]
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    rand_angles = jax.random.uniform(
        key_t, (s, spec.dof), minval=lo, maxval=hi, dtype=jnp.float32
    )
    rand_pose = fk_ops.angles_to_pose(
        spec, jnp.broadcast_to(problem.pose[0], (s, 3)), rand_angles
    )
    pos, rot = fk_ops.fk(spec, rand_pose, problem.origin)
    targets = pos[:, list(spec.effector_idx), :]
    target_rot = None
    if orientation:
        # Orientation targets: the effector WORLD rotations of the same
        # sampled poses (as Euler XYZ), so position+orientation is
        # exactly satisfiable (BASELINE config 2).
        from ikpso.ops.rotations import (
            matrix_to_quaternion,
            quaternion_to_euler_xyz,
        )

        target_rot = quaternion_to_euler_xyz(
            matrix_to_quaternion(rot[:, list(spec.effector_idx)])
        )
    batched = batched_problem(problem, targets, target_rot=target_rot)
    feasible = None
    if obstacles is not None and obstacles.count:
        from ikpso.ops.collision import get_chain_collider

        hit = get_chain_collider("sat", "box")(
            pos[:, 1:, :], rot[:, 1:, :, :],
            pos[:, list(spec.parent[1:]), :], spec.length[1:],
            obstacles.center, obstacles.half_extent, obstacles.rot,
        )
        feasible = ~np.asarray(hit)
    return batched, feasible


@dataclasses.dataclass(frozen=True)
class Recipe:
    """Everything that defines one benchmarked solve besides the batch."""

    impl: str
    particles: int
    iterations: int
    inertia_mode: str = "canonical"
    init_mode: str = "warm"
    retry_init_mode: Optional[str] = None
    retries: int = 0
    retry_iterations: Optional[int] = None
    retry_bucket: Optional[int] = None
    retry_walk: int = 0
    retry_walk_jitter: float = 0.0
    retry_bucket_decay: int = 1
    rekick_interval: int = 0
    rekick_scale: float = 0.5
    rekick_threshold: float = 1e-6
    polish: int = 0
    walk: int = 0
    orientation: bool = False
    collision_shape: str = "box"
    fk_impl: str = "unrolled"
    trig_impl: str = "poly"


def preset_recipe(model: str, impl: str = "auto", **overrides) -> Recipe:
    """The model's preset recipe, for whichever PSO solver runs it.

    ``impl="auto"`` takes the solver the preset names (chosen per
    model by timing both on the GPU); on the host it is ``jnp`` (the
    megakernel is a GPU kernel). Keyword overrides replace fields.
    """
    from ikpso.pso.presets import FUSED_PRESETS, fused_preset

    pre = fused_preset(model)
    if pre is None:
        raise SystemExit(
            f"error: unknown model {model!r}; expected one of "
            f"{sorted(FUSED_PRESETS)} or 'snake:<links>'"
        )
    if impl == "auto":
        impl = pre.impl if jax.devices()[0].platform == "gpu" else "jnp"
    recipe = Recipe(
        impl=impl,
        particles=pre.particles,
        iterations=pre.iterations,
        retry_init_mode=pre.retry_init_mode if pre.retries else None,
        retries=pre.retries,
        retry_iterations=pre.retry_iterations if pre.retries else None,
        retry_bucket=pre.retry_bucket if pre.retries else None,
        retry_walk=(pre.retry_walk or 0) if pre.retries else 0,
        retry_walk_jitter=pre.retry_walk_jitter,
        retry_bucket_decay=pre.retry_bucket_decay,
        rekick_interval=pre.rekick_interval,
        rekick_scale=pre.rekick_scale,
        rekick_threshold=pre.rekick_threshold,
        polish=pre.polish,
    )
    overrides = {k: v for k, v in overrides.items() if v is not None}
    if "iterations" in overrides and recipe.rekick_interval and (
        overrides["iterations"] % recipe.rekick_interval
    ):
        recipe = dataclasses.replace(recipe, rekick_interval=0)
    return dataclasses.replace(recipe, **overrides)


def pso_config(recipe: Recipe):
    from ikpso.pso.config import PSOConfig

    kw = dict(
        iterations=recipe.iterations,
        inertia_mode=recipe.inertia_mode,
        init_mode=recipe.init_mode,
        rekick_interval=recipe.rekick_interval,
        rekick_scale=recipe.rekick_scale,
        rekick_threshold=recipe.rekick_threshold,
    )
    if recipe.inertia_mode == "canonical":
        # Canonical inertia decaying 0.5 -> 0.2 (explore, then exploit).
        kw.update(inertia=0.5, inertia_end=0.2)
    return PSOConfig(**kw)


def fitness_config(recipe: Recipe):
    from ikpso.ops.fitness import FitnessConfig

    return FitnessConfig(
        angle_weight=0.0, distance_weight=0.0,
        orientation_weight=1.0 if recipe.orientation else 0.0,
        collision_shape=recipe.collision_shape,
        fk_impl=recipe.fk_impl,
        trig_impl=recipe.trig_impl,
    )


def build_solver(spec, recipe: Recipe, s: int, obstacles=None, *,
                 stage: str = "full"):
    """One jitted ``(problem, key) -> SolveResult`` for the recipe.

    ``stage="pso"`` is the PSO solve alone (no walk, polish or
    retries); ``"full"`` is the whole recipe.
    """
    from ikpso.pso.restarts import wrap_with_topk_retries
    from ikpso.pso.solver import make_solver

    pso = pso_config(recipe)
    fit = fitness_config(recipe)

    def build(pso_cfg):
        if recipe.impl == "fused":
            from ikpso.pso.fused import make_fused_solver

            sv = make_fused_solver(
                spec, pso=pso_cfg, fit=fit, obstacles=obstacles,
                num_particles=recipe.particles,
            )
        elif recipe.impl == "jnp":
            sv = make_solver(
                spec, pso=pso_cfg, fit=fit, obstacles=obstacles,
                num_particles=recipe.particles,
            )
        else:
            raise ValueError(f"unknown impl {recipe.impl!r}")
        if stage == "pso":
            return sv
        if recipe.polish:
            # Differentiable-FK LM refinement of each swarm's gbest,
            # accept-if-better per swarm (pso/polish.py).
            from ikpso.pso.polish import wrap_with_polish

            sv = wrap_with_polish(
                sv, spec, steps=recipe.polish,
                use_orientation=recipe.orientation,
                obstacles=obstacles,
                collision_backend=fit.collision_backend,
                collision_shape=fit.collision_shape,
                gizmo_size=fit.gizmo_size,
            )
        if recipe.walk:
            # The base solve as a W-step warm target walk (the
            # reference's own per-frame loop, batched).
            from ikpso.pso.restarts import wrap_solver_with_target_walk

            sv = wrap_solver_with_target_walk(sv, spec, recipe.walk)
        return sv

    if stage == "pso":
        return jax.jit(build(pso))
    # Retry bucket: S/16 of the batch (floor 1024, cap S/8); big
    # batches with decaying buckets start at S/32, since the first
    # round only has to cover the pre-retry failure set.
    div = 32 if recipe.retry_bucket_decay > 1 and s >= 262144 else 16
    solver = wrap_with_topk_retries(
        build, pso, rounds=recipe.retries,
        bucket=recipe.retry_bucket or min(max(1024, s // div), max(s // 8, 1)),
        retry_init_mode=recipe.retry_init_mode,
        retry_iterations=recipe.retry_iterations,
        spec=spec, retry_walk_steps=recipe.retry_walk,
        retry_walk_jitter=recipe.retry_walk_jitter,
        bucket_decay=recipe.retry_bucket_decay,
    )
    return jax.jit(solver)


def memory_stats(compiled) -> dict:
    """Bytes XLA planned for the compiled program (``memory_analysis``)."""
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {
        "mem_argument_bytes": int(ma.argument_size_in_bytes),
        "mem_output_bytes": int(ma.output_size_in_bytes),
        "mem_temp_bytes": int(ma.temp_size_in_bytes),
        "mem_generated_code_bytes": int(ma.generated_code_size_in_bytes),
    }


def score(spec, res, batched, feasible=None, orientation=False) -> dict:
    """Accuracy of a solve: percentiles and the exact <1 mm count."""
    err_mm = np.asarray(res.effector_error) * 1000.0
    scored = err_mm if feasible is None else err_mm[feasible]
    n_fail = int((~(scored < 1.0)).sum())
    out = dict(
        p50_err_mm=float(np.percentile(scored, 50)),
        p90_err_mm=float(np.percentile(scored, 90)),
        n_scored=int(scored.size),
        n_fail_1mm=n_fail,
        frac_under_1mm=(scored.size - n_fail) / scored.size,
    )
    if feasible is not None:
        out["frac_targets_feasible"] = float(feasible.mean())
    if orientation:
        from ikpso.ops import fk as fk_ops
        from ikpso.ops.rotations import euler_xyz_to_matrix

        solved_rot = fk_ops.fk(spec, res.pose, batched.origin)[1][
            :, list(spec.effector_idx)
        ]
        tgt = euler_xyz_to_matrix(batched.target_rot)
        # Geodesic angle: acos((tr(Ra^T Rb) - 1) / 2), worst effector.
        tr = jnp.einsum("...ij,...ij->...", solved_rot, tgt)
        ang = np.degrees(
            np.asarray(jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)))
        ).max(axis=-1)
        out["p50_orient_err_deg"] = float(np.percentile(ang, 50))
        out["p90_orient_err_deg"] = float(np.percentile(ang, 90))
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--model", default="arm_7dof", metavar="MODEL",
        help="model to benchmark (headline: arm_7dof); model-zoo name "
        "or 'snake:<links>' for arbitrary chain depth",
    )
    parser.add_argument(
        "--impl", choices=("auto", "jnp", "fused"), default="auto",
        help="PSO solver: the Triton megakernel (fused, GPU only), the "
        "lax.scan solver (jnp), or the model preset's choice (auto)",
    )
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host CPU (otherwise a GPU is required)")
    parser.add_argument("--swarms", type=int, default=None,
                        help="batch size S (default: the preset's)")
    parser.add_argument("--particles", type=int, default=None)
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--inertia-mode", choices=("canonical", "randomized"),
                        default=None, help="default: canonical (the preset's)")
    parser.add_argument(
        "--init-mode", choices=("warm", "uniform", "hybrid"), default=None,
        help="swarm init: warm (reference default), uniform joint-range "
        "draws, or hybrid (particle 0 warm, rest uniform)",
    )
    parser.add_argument(
        "--retry-init-mode", choices=("warm", "uniform", "hybrid"),
        default=None, help="swarm init for the top-k retry rounds only",
    )
    parser.add_argument(
        "--orientation", action="store_true",
        help="position+orientation targets (BASELINE config 2 task); "
        "adds p50/p90 geodesic orientation error to the record",
    )
    parser.add_argument("--retries", type=int, default=None,
                        help="top-k retry rounds (default: the preset's)")
    parser.add_argument("--retry-iterations", type=int, default=None,
                        metavar="N", help="PSO iterations of the retry rounds")
    parser.add_argument("--retry-bucket", type=int, default=None, metavar="N",
                        help="worst-N swarms re-solved per retry round")
    parser.add_argument(
        "--walk", type=int, default=None, metavar="W",
        help="run the BASE solve as a W-step warm target walk (the "
        "reference's per-frame protocol, Main.cpp:222-227, batched)",
    )
    parser.add_argument("--retry-bucket-decay", type=int, default=None,
                        metavar="K", help="shrink the retry bucket K-fold per round")
    parser.add_argument("--retry-walk", type=int, default=None, metavar="W",
                        help="retry rounds re-solve via a W-step target walk")
    parser.add_argument("--retry-walk-jitter", type=float, default=None,
                        metavar="J", help="curved-path variation of walk retries")
    parser.add_argument("--rekick-interval", type=int, default=None,
                        help="velocity re-kick every N iterations (0 = off)")
    parser.add_argument("--rekick-scale", type=float, default=None)
    parser.add_argument("--rekick-threshold", type=float, default=None)
    parser.add_argument("--polish", type=int, default=None, metavar="K",
                        help="LM polish steps on each swarm's gbest (0 = off)")
    parser.add_argument(
        "--obstacles", type=int, default=0, metavar="N",
        help="add an N-box scene; accuracy scored on targets whose "
        "generating pose is collision-free",
    )
    parser.add_argument("--fk-impl", choices=("unrolled", "scan"), default=None,
                        help="jnp-path FK strategy")
    parser.add_argument("--collision-shape", choices=("box", "capsule"),
                        default=None)
    parser.add_argument(
        "--latency", action="store_true",
        help="latency protocol (BASELINE: 10k simultaneous solves in "
        "<10 ms per run): wall of ONE S=10000 batch plus chained_ms, "
        "the wall of one jitted 64-run chain divided by 64",
    )
    parser.add_argument("--profile", default=None, metavar="LOGDIR",
                        help="capture a jax.profiler trace of the timed solves")
    parser.add_argument("--record", default=None, metavar="FILE",
                        help="append the JSON record to FILE")
    parser.add_argument("--session", default=None,
                        help="session tag stamped into --record lines")
    return parser.parse_args(argv)


def recipe_from_args(args) -> Recipe:
    """The preset recipe with the command line's explicit overrides."""
    recipe = preset_recipe(
        args.model, args.impl,
        particles=args.particles, iterations=args.iterations,
        inertia_mode=args.inertia_mode, init_mode=args.init_mode,
        retry_init_mode=args.retry_init_mode, retries=args.retries,
        retry_iterations=args.retry_iterations, retry_bucket=args.retry_bucket,
        retry_walk=args.retry_walk, retry_walk_jitter=args.retry_walk_jitter,
        retry_bucket_decay=args.retry_bucket_decay,
        rekick_interval=args.rekick_interval, rekick_scale=args.rekick_scale,
        rekick_threshold=args.rekick_threshold, polish=args.polish,
        walk=args.walk, orientation=args.orientation or None,
        collision_shape=args.collision_shape, fk_impl=args.fk_impl,
    )
    if args.obstacles and args.retry_bucket_decay is None:
        # Obstacle scenes keep CONSTANT retry buckets: their failures
        # are wrong-basin (blocked approaches) and do not shrink
        # geometrically round over round.
        recipe = dataclasses.replace(recipe, retry_bucket_decay=1)
    return recipe


def run(argv=None) -> dict:
    """Parse, build, compile, time and score; return the JSON record."""
    from ikpso.pso.presets import fused_preset
    from ikpso.utils.cache import enable_compile_cache
    from ikpso.utils.flops import fused_solve_count
    from ikpso.utils.profiling import measure, trace

    args = parse_args(argv)
    select_platform(args.cpu)
    cache_dir = enable_compile_cache()
    dev = device_info()
    _progress(f"devices: {dev}; compile cache: {cache_dir}")
    recipe = recipe_from_args(args)
    s = args.swarms or (10_000 if args.latency else fused_preset(args.model).swarms)
    spec, problem = load_model(args.model)
    obstacles = obstacle_scene(spec, args.obstacles) if args.obstacles else None
    batched, feasible = sample_targets(
        spec, problem, s, orientation=recipe.orientation, obstacles=obstacles,
    )
    key = jax.random.split(jax.random.key(0))[1]
    solver = build_solver(spec, recipe, s, obstacles)

    _progress(f"compiling (S={s}, recipe={recipe})")
    t0 = time.perf_counter()
    compiled = solver.lower(batched, key).compile()
    compile_s = time.perf_counter() - t0
    mem = memory_stats(compiled)
    _progress(f"compiled in {compile_s:.1f}s; memory_analysis: "
              f"{compiled.memory_analysis()}")

    # A distinct key per timed call: every call is a fresh solve.
    with trace(args.profile):
        res, wall = measure(
            compiled, batched, key, warmup=2, iters=5,
            vary=lambda i, a: (a[0], jax.random.fold_in(a[1], i)),
        )
    _progress(f"measured wall {wall * 1e3:.3f} ms per batch")
    stats = score(spec, res, batched, feasible, recipe.orientation)
    count = fused_solve_count(
        spec, pso_config(recipe), fitness_config(recipe),
        num_particles=recipe.particles, num_swarms=s,
        num_obstacles=0 if obstacles is None else obstacles.count,
        use_orientation=recipe.orientation,
    )
    model_tag = args.model.replace(":", "")
    if args.latency:
        # The DIRECT per-run device time: K back-to-back full solver
        # runs (fresh keys, static targets) chained in ONE jitted scan,
        # wall / K — no per-dispatch host cost in it.
        k_runs = 64

        @jax.jit
        def run_k(problem, key):
            def body(carry, kk):
                r = solver(problem, kk)
                return carry + r.effector_error.sum(), None

            return jax.lax.scan(body, jnp.float32(0.0),
                                jax.random.split(key, k_runs))[0]

        _, chained = measure(
            run_k, batched, key, warmup=1, iters=5,
            vary=lambda i, a: (a[0], jax.random.fold_in(a[1], 500 + i)),
        )
        record = {
            "metric": f"{model_tag}_latency_ms_per_{s}solve_run",
            "value": wall * 1e3,
            "unit": "ms",
            "chained_ms": chained / k_runs * 1e3,
            "chained_runs": k_runs,
        }
    else:
        metric = ("7dof_ik_solves_per_s_per_chip" if args.model == "arm_7dof"
                  else f"{model_tag}_ik_solves_per_s_per_chip")
        record = {"metric": metric, "value": s / wall, "unit": "solves/s/chip"}
    record.update(dev)
    record.update(card_info())
    record.update({
        "model": args.model,
        "impl": recipe.impl,
        "swarms": s,
        "wall_ms_per_solve_batch": wall * 1e3,
        "compile_s": compile_s,
        **stats,
        # Counted ops of the PSO stage (utils.flops traces the kernel's
        # tile code) over the whole wall: a floor on delivered ops.
        "pso_stage_gflops_counted": count.flops / wall / 1e9,
        **mem,
        "recipe": dataclasses.asdict(recipe),
        "obstacles": args.obstacles,
    })
    if args.record:
        logged = {"session": args.session, **record} if args.session else record
        with open(args.record, "a") as fh:
            fh.write(json.dumps(logged) + "\n")
    return record


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
