"""Command-line driver: solve / experiment / sweep / viz.

Replaces the reference's interactive GLFW app + single CLI arg
(reference Main.cpp:58-63 takes only a particle count). Subcommands:

  solve       one batched solve from a JSON config, print results
  experiment  the reset->solve->frames-to-converge protocol (§4)
  sweep       trajectory sweep over many waypoints, checkpointable
  track       follow moving targets: scan-chained per-frame re-solves
  viz         render the configured scene to HTML / PNG

Run as ``python -m ikpso.harness.cli <cmd> ...``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--config", default=None, help="JSON config path or literal")
    p.add_argument("--model", default="reference_arm")
    p.add_argument("--particles", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--cpu", action="store_true",
        help="run on the host CPU (without it a GPU is required)",
    )
    p.add_argument(
        "--preset", action="store_true",
        help="apply the model's solve recipe (particles, iterations, "
        "inertia schedule, re-kick, polish, retries where supported — "
        "ikpso/pso/presets.py; what bench.py runs). Explicit flags "
        "still win. Off by default: the bare defaults stay at "
        "reference parity",
    )
    p.add_argument(
        "--inertia-mode",
        choices=("randomized", "canonical"),
        default=None,
        help="PSO inertia policy (default: the config's — 'randomized' "
        "for reference parity; 'canonical' converges tighter, and "
        "supports an inertia_end decay via JSON config)",
    )
    p.add_argument(
        "--init-mode", choices=("warm", "uniform", "hybrid"), default=None,
        help="swarm init: 'warm' (reference default) starts every "
        "particle at the current pose; 'uniform' spreads them over the "
        "joint range (the reference's Iteration_1 protocol — combine "
        "with --angle-weight 0, its fitness predates the locality "
        "term); 'hybrid' "
        "keeps particle 0 warm and spreads the rest (basin coverage "
        "for single-shot far targets)",
    )
    p.add_argument(
        "--rekick-interval", type=int, default=None,
        help="re-randomize particle velocities every N iterations "
        "(0 = off; rescues prematurely-converged swarms)",
    )
    p.add_argument(
        "--rekick-scale", type=float, default=None,
        help="half-width of the re-kick velocity draw (default 1.0)",
    )
    p.add_argument(
        "--rekick-threshold", type=float, default=None,
        help="only kick swarms with gbest fitness above this "
        "(default: kick all)",
    )
    p.add_argument(
        "--angle-weight", type=float, default=None,
        help="override the angular-locality weight (0.0 = the "
        "reference's Iteration_1/2 fitness; lower = tighter reaching, "
        "less motion smoothing)",
    )
    p.add_argument(
        "--polish", type=int, default=None, metavar="K",
        help="K Levenberg-Marquardt polish steps on the solution "
        "through the differentiable FK (accept-if-better; 0 = off)",
    )
    p.add_argument(
        "--impl",
        choices=("auto", "jnp", "fused"),
        default="auto",
        help="PSO solver: lax.scan (jnp) or the Triton megakernel "
        "(fused, GPU only); auto runs the model preset's solver on a "
        "GPU and jnp with --cpu",
    )


def _select_platform(cpu: bool) -> None:
    """--cpu pins the host backend; otherwise a GPU must be present."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"error: no GPU found (JAX platform {platform!r}); pass --cpu "
            "to run on the host"
        )


def _pick_impl(args) -> str:
    import jax

    on_gpu = jax.devices()[0].platform == "gpu"
    if args.impl == "fused" and not on_gpu:
        raise SystemExit(
            "error: --impl fused is a GPU kernel; use --impl jnp (or "
            "auto) with --cpu"
        )
    if args.impl != "auto":
        return args.impl
    if not on_gpu:
        return "jnp"
    from ikpso.pso.presets import fused_preset

    pre = fused_preset(args.model)
    return pre.impl if pre is not None else "jnp"


def _load(args):
    import dataclasses

    from ikpso.utils.cache import enable_compile_cache

    _select_platform(args.cpu)
    enable_compile_cache()

    # --preset: fill every knob the user left unset from the model's
    # measured frontier recipe (pso/presets.py). Filled into `args` so
    # the ordinary flag-override machinery below applies them; explicit
    # flags therefore always win.
    pre = None
    if getattr(args, "preset", False):
        if args.config:
            raise SystemExit(
                "--preset and --config are mutually exclusive (a JSON "
                "config is already an explicit full configuration)"
            )
        from ikpso.pso.presets import fused_preset

        pre = fused_preset(args.model)
        if pre is None:
            raise SystemExit(f"no preset for model {args.model!r}")
        if args.particles is None:
            args.particles = pre.particles
        if args.iterations is None:
            args.iterations = pre.iterations
        if args.inertia_mode is None:
            args.inertia_mode = "canonical"
        if args.rekick_interval is None:
            args.rekick_interval = pre.rekick_interval
        if args.rekick_scale is None:
            args.rekick_scale = pre.rekick_scale
        if args.rekick_threshold is None:
            args.rekick_threshold = pre.rekick_threshold
        if args.polish is None:
            args.polish = pre.polish
        if hasattr(args, "retries") and args.retries is None:
            args.retries = pre.retries
        if (
            hasattr(args, "retry_init_mode")
            and args.retry_init_mode is None
        ):
            args.retry_init_mode = pre.retry_init_mode
    from ikpso.utils.configio import load_config

    src = args.config if args.config else {"model": args.model}
    cfg = load_config(src)
    if args.particles is not None:
        cfg = dataclasses.replace(cfg, num_particles=args.particles)
    if args.iterations is not None:
        cfg = dataclasses.replace(
            cfg, pso=dataclasses.replace(cfg.pso, iterations=args.iterations)
        )
    if getattr(args, "init_mode", None):
        cfg = dataclasses.replace(
            cfg, pso=dataclasses.replace(cfg.pso, init_mode=args.init_mode)
        )
    if getattr(args, "inertia_mode", None):
        cfg = dataclasses.replace(
            cfg, pso=dataclasses.replace(cfg.pso,
                                         inertia_mode=args.inertia_mode)
        )
    if getattr(args, "rekick_interval", None) is not None:
        cfg = dataclasses.replace(
            cfg, pso=dataclasses.replace(cfg.pso,
                                         rekick_interval=args.rekick_interval)
        )
    if getattr(args, "rekick_scale", None) is not None:
        cfg = dataclasses.replace(
            cfg, pso=dataclasses.replace(cfg.pso, rekick_scale=args.rekick_scale)
        )
    if getattr(args, "rekick_threshold", None) is not None:
        cfg = dataclasses.replace(
            cfg, pso=dataclasses.replace(cfg.pso,
                                         rekick_threshold=args.rekick_threshold)
        )
    if getattr(args, "angle_weight", None) is not None:
        cfg = dataclasses.replace(
            cfg, fitness=dataclasses.replace(cfg.fitness,
                                             angle_weight=args.angle_weight)
        )
    if pre is not None and cfg.pso.inertia_mode == "canonical":
        # The frontier recipes were measured with the canonical
        # explore-then-exploit decay (no CLI flag for inertia_end).
        cfg = dataclasses.replace(
            cfg, pso=dataclasses.replace(
                cfg.pso, inertia=pre.inertia, inertia_end=pre.inertia_end
            )
        )
    # Normalize the preset-aware optional flags for downstream code.
    args.polish = args.polish or 0
    if hasattr(args, "retries"):
        args.retries = args.retries or 0
    return cfg


def cmd_solve(args) -> int:
    import jax

    cfg = _load(args)
    impl = _pick_impl(args)
    if impl == "fused":
        from ikpso.pso.fused import make_fused_solver

        solver = make_fused_solver(
            cfg.spec,
            pso=cfg.pso,
            fit=cfg.fitness,
            obstacles=cfg.obstacles,
            num_particles=cfg.num_particles,
        )
    else:
        from ikpso.pso.solver import make_solver

        solver = make_solver(
            cfg.spec,
            pso=cfg.pso,
            fit=cfg.fitness,
            obstacles=cfg.obstacles,
            num_particles=cfg.num_particles,
        )
    if args.polish:
        from ikpso.pso.polish import wrap_with_polish

        use_orient = (
            cfg.problem.target_rot is not None
            and float(np.asarray(cfg.fitness.orientation_weight)) != 0.0
        )
        solver = wrap_with_polish(
            solver,
            cfg.spec,
            steps=args.polish,
            use_orientation=use_orient,
            orientation_weight=(
                float(np.asarray(cfg.fitness.orientation_weight))
                if use_orient
                else 1.0
            ),
            obstacles=cfg.obstacles,
            collision_backend=cfg.fitness.collision_backend,
            collision_shape=cfg.fitness.collision_shape,
            gizmo_size=cfg.fitness.gizmo_size,
        )
    batched = jax.tree.map(lambda x: x[None], cfg.problem)
    res = solver(batched, jax.random.key(args.seed))
    # Strip the swarm axis (trace carries it second: (iters+1, S)).
    res = jax.tree.map(
        lambda x: x[0] if x.ndim > 0 and x.shape[0] == 1 else x[:, 0], res
    )
    print(
        json.dumps(
            dict(
                angles=np.asarray(res.angles).tolist(),
                fitness=float(res.fitness),
                effector_error=float(res.effector_error),
                trace=np.asarray(res.trace).tolist(),
            )
        )
    )
    return 0


def cmd_experiment(args) -> int:
    import jax

    from ikpso.harness.experiment import frames_to_converge
    from ikpso.models.library import reference_reset_targets
    from ikpso.native import make_diagnostics_writer

    cfg = _load(args)
    diag = make_diagnostics_writer(args.outdir) if args.outdir else None
    reset = (
        reference_reset_targets()
        if args.model == "reference_arm" and not args.config
        else np.asarray(cfg.problem.targets)
    )
    result = frames_to_converge(
        cfg.spec,
        cfg.problem,
        reset,
        jax.random.key(args.seed),
        pso=cfg.pso,
        fit=cfg.fitness,
        obstacles=cfg.obstacles,
        num_particles=cfg.num_particles,
        eps_dist=args.eps,
        max_frames=args.max_frames,
        trials=args.trials,
        diagnostics=diag,
        impl=_pick_impl(args),
        trial_batch=args.trial_batch,
        progress=args.progress,
        polish=args.polish,
    )
    if diag:
        diag.close()
    print(json.dumps(result.summary()))
    return 0


def cmd_parity(args) -> int:
    """Distribution-level convergence parity vs the reference's raw data.

    Runs the reference's reset->target-jump protocol (Main.cpp:171-337)
    for each of its three development iterations, then compares the
    frames-to-converge DISTRIBUTION against the raw per-trial sheets
    of Documentation/results.xlsx with a KS test + bootstrap CI.
    """
    import jax

    from ikpso.harness.experiment import frames_to_converge
    from ikpso.harness.parity import (
        compare_distributions,
        load_reference_frames,
    )
    from ikpso.models.library import (
        reference_arm,
        reference_reset_targets,
    )
    from ikpso.ops.fitness import FitnessConfig
    from ikpso.pso.config import PSOConfig

    from ikpso.utils.cache import enable_compile_cache

    _select_platform(args.cpu)
    enable_compile_cache()

    # The three published protocols (Documentation/Iteration_{1,2,3};
    # identical PSO config, differing init + fitness):
    protocols = {
        "iter1": dict(init_mode="uniform", angle_weight=0.0),
        "iter2": dict(init_mode="warm", angle_weight=0.0),
        "iter3": dict(init_mode="warm", angle_weight=3.0),
    }
    # The reports never state the PSO coefficients; the repository
    # documents exactly two candidate configs (SURVEY.md §2.4.7):
    # the shipped Main.cpp:130 hardcode (0.5/0.5/1.25, 15 iterations)
    # and the Particle.h:70-78 struct defaults (0.2/0.5/0.7, 10
    # iterations). `--pso-variant struct` runs the historical-config
    # hypothesis for the iteration-1/2 reports, whose measuring code
    # predates the shipped source.
    pso_variants = {
        "shipped": dict(inertia=0.5, cognitive=0.5, social=1.25,
                        iterations=15),
        "struct": dict(inertia=0.2, cognitive=0.5, social=0.7,
                       iterations=10),
    }
    variant = pso_variants[args.pso_variant]
    ref = load_reference_frames()
    spec, problem = reference_arm()
    reset = reference_reset_targets()
    wanted = args.protocols.split(",") if args.protocols else list(protocols)
    out = {}
    for name in wanted:
        p = protocols[name]
        res = frames_to_converge(
            spec,
            problem,
            reset,
            jax.random.key(args.seed),
            pso=PSOConfig(inertia_mode="randomized",
                          init_mode=p["init_mode"], **variant),
            fit=FitnessConfig(angle_weight=p["angle_weight"]),
            num_particles=args.particles,
            eps_dist=0.025,
            max_frames=args.max_frames,
            trials=args.trials,
            trial_batch=args.trial_batch,
            impl="jnp",
            rng_mode=args.rng_stream,
        )
        frames = np.asarray(res.frames, float)
        converged = frames[frames >= 0]
        if converged.size == 0:
            rec = {"error": "no trials converged", "unconverged": int(frames.size)}
            out[name] = rec
            print(json.dumps({name: rec}), flush=True)
            continue
        rec = compare_distributions(ref[name], converged)
        rec["unconverged"] = int((frames < 0).sum())
        out[name] = rec
        print(json.dumps({name: rec}), flush=True)
    print(json.dumps(dict(metric="parity", trials=args.trials,
                          pso_variant=args.pso_variant,
                          rng_stream=args.rng_stream, results=out)))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(dict(trials=args.trials,
                                     pso_variant=args.pso_variant,
                                     rng_stream=args.rng_stream,
                                     results=out)) + "\n")
    return 0


def cmd_sweep(args) -> int:
    import jax

    from ikpso.harness.trajectory import solve_waypoints

    multihost = getattr(args, "multihost", False)
    if multihost:
        # Must run before the backend initializes (and before _load
        # touches jax arrays) — including the platform choice, which
        # is ordinarily applied inside _load.
        if args.cpu:
            jax.config.update("jax_platforms", "cpu")
        from ikpso.parallel import distributed

        distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    cfg = _load(args)
    rng = np.random.default_rng(args.seed)
    # Sample reachable waypoints around the configured targets. Every
    # process draws the identical global set (same seed); the multihost
    # path slices it per process.
    base = np.asarray(cfg.problem.targets)
    waypoints = base[None] + rng.normal(scale=args.jitter, size=(args.waypoints,) + base.shape).astype(np.float32)
    kw = dict(
        pso=cfg.pso,
        fit=cfg.fitness,
        obstacles=cfg.obstacles,
        num_particles=cfg.num_particles,
        impl=_pick_impl(args),
        retries=args.retries,
        retry_init_mode=args.retry_init_mode,
        retry_iterations=getattr(args, "retry_iterations", None),
        polish=args.polish,
    )
    extra = {}
    if multihost:
        from ikpso.parallel.distributed import sweep_waypoints_multihost

        result, sl = sweep_waypoints_multihost(
            cfg.spec, cfg.problem, waypoints, jax.random.key(args.seed),
            batch_size=args.batch, **kw,
        )
        extra = dict(
            process=jax.process_index(),
            num_processes=jax.process_count(),
            local_slice=[int(sl.start), int(sl.stop)],
        )
    else:
        result = solve_waypoints(
            cfg.spec, cfg.problem, waypoints, jax.random.key(args.seed),
            batch_size=args.batch, checkpoint_path=args.checkpoint, **kw,
        )
    print(
        json.dumps(
            dict(
                waypoints=int(result.errors.size),
                err_mean=float(result.errors.mean()),
                err_p50=float(np.percentile(result.errors, 50)),
                err_p95=float(np.percentile(result.errors, 95)),
                solves_per_second=result.solves_per_second,
                **extra,
            )
        )
    )
    return 0


def _follow_updates(stream):
    """Parse a target/origin-update stream: one update per line.

    Accepted line forms (blank lines and ``#`` comments skipped):

    * a JSON array ``[[x,y,z], ...]`` of E effector targets;
    * 3*E whitespace-separated floats (same meaning);
    * ``origin x y z`` — move the arm base only (the reference's
      arrow-key base drag, Main.cpp:401-453's origin-node move);
    * a JSON object ``{"targets": [[x,y,z],...], "origin": [x,y,z]}``
      with either or both keys — one atomic mixed update.

    This is the wire format for driving ``track --follow`` from a UI,
    a file tail, or another process — the reference's interactive
    manipulation loop as a stream. Malformed lines raise ValueError
    naming the line number (instead of an opaque reshape error deep in
    the solve loop); the effector count is pinned by the first
    targets-bearing line.
    """
    expected = [None]  # effector count, fixed by the first targets line

    def _targets(arr, lineno):
        arr = np.asarray(arr, np.float32)
        if arr.size == 0 or arr.size % 3:
            raise ValueError(
                f"follow stream line {lineno}: targets need 3*E floats, "
                f"got {arr.size}"
            )
        arr = arr.reshape(-1, 3)
        if expected[0] is None:
            expected[0] = arr.shape[0]
        elif arr.shape[0] != expected[0]:
            raise ValueError(
                f"follow stream line {lineno}: {arr.shape[0]} effector "
                f"targets, but the first update had {expected[0]}"
            )
        return arr

    def _origin(arr, lineno):
        arr = np.asarray(arr, np.float32)
        if arr.shape != (3,):
            raise ValueError(
                f"follow stream line {lineno}: origin needs exactly 3 "
                f"floats, got shape {arr.shape}"
            )
        return arr

    for lineno, line in enumerate(stream, start=1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("{"):
            obj = json.loads(line)
            unknown = sorted(set(obj) - {"targets", "origin"})
            if unknown or not obj:
                raise ValueError(
                    f"follow stream line {lineno}: expected keys "
                    f"'targets'/'origin', got {sorted(obj) or 'none'}"
                )
            upd = {}
            if "targets" in obj:
                upd["targets"] = _targets(obj["targets"], lineno)
            if "origin" in obj:
                upd["origin"] = _origin(obj["origin"], lineno)
            yield upd
        elif line.startswith("["):
            yield _targets(json.loads(line), lineno)
        else:
            toks = line.split()
            if toks[0] == "origin":
                yield {"origin": _origin([float(v) for v in toks[1:]], lineno)}
            else:
                try:
                    vals = [float(v) for v in toks]
                except ValueError:
                    raise ValueError(
                        f"follow stream line {lineno}: not a number: "
                        f"{line!r}"
                    ) from None
                yield _targets(vals, lineno)


def cmd_track(args) -> int:
    import jax

    from ikpso.harness.trajectory import (
        circle_paths,
        follow_targets,
        track_trajectories,
    )

    cfg = _load(args)
    if args.follow is not None:
        stream = sys.stdin if args.follow == "-" else open(args.follow)
        try:
            records = []
            for rec in follow_targets(
                cfg.spec,
                cfg.problem,
                _follow_updates(stream),
                jax.random.key(args.seed),
                pso=cfg.pso,
                fit=cfg.fitness,
                obstacles=cfg.obstacles,
                num_particles=cfg.num_particles,
                impl=_pick_impl(args),
                polish=args.polish,
            ):
                err = float(rec["effector_error"].max())
                line = dict(
                    step=rec["step"],
                    err=err,
                    wall_ms=round(rec["wall_ms"], 3),
                )
                if "angle_delta_max" in rec:
                    line["angle_delta_max"] = round(
                        rec["angle_delta_max"], 6
                    )
                print(json.dumps(line), flush=True)
                records.append(err)
        finally:
            if stream is not sys.stdin:
                stream.close()
        if not records:
            print(json.dumps(dict(steps=0)))
            return 0
        settle = args.settle if args.settle is not None else min(
            3, len(records) - 1
        )
        ss = np.asarray(records[settle:])
        print(
            json.dumps(
                dict(
                    steps=len(records),
                    settle=settle,
                    err_p50_settled=float(np.percentile(ss, 50)),
                    err_max_settled=float(ss.max()),
                )
            )
        )
        return 0
    path = circle_paths(
        np.asarray(cfg.problem.targets),
        steps=args.steps,
        num_paths=args.paths,
        radius=args.radius,
        revolutions=args.revolutions,
        seed=args.seed,
    )
    result = track_trajectories(
        cfg.spec,
        cfg.problem,
        path,
        jax.random.key(args.seed),
        pso=cfg.pso,
        fit=cfg.fitness,
        obstacles=cfg.obstacles,
        num_particles=cfg.num_particles,
        impl=_pick_impl(args),
        polish=args.polish,
        timeit=args.timeit,
    )
    # Per-step joint motion: continuity metric of the tracked animation
    # (the reference's degStream angle-delta analysis, per frame).
    step_delta = np.abs(np.diff(result.angles, axis=0))
    # The run starts from the model's canonical pose, so the first
    # steps are the convergence transient (the experiment protocol's
    # frames-to-converge); steady-state tracking quality is judged
    # after a settle prefix.
    settle = args.settle if args.settle is not None else args.steps // 4
    settle = max(0, min(settle, args.steps - 1))
    ss = result.errors[settle:]
    print(
        json.dumps(
            dict(
                steps=int(result.errors.shape[0]),
                paths=int(result.errors.shape[1]),
                err_p50=float(np.percentile(result.errors, 50)),
                err_p95=float(np.percentile(result.errors, 95)),
                settle=settle,
                err_p50_settled=float(np.percentile(ss, 50)),
                err_p95_settled=float(np.percentile(ss, 95)),
                err_max_settled=float(ss.max()),
                angle_delta_avg=float(step_delta.mean()),
                angle_delta_max=float(step_delta.max()),
                solves_per_second=result.solves_per_second,
                wall_time_s=result.wall_time_s,
            )
        )
    )
    return 0


def cmd_viz(args) -> int:
    from ikpso.viz.render import export_html, plot_scene

    cfg = _load(args)
    out = args.out or "out/scene.html"
    if out.endswith(".html"):
        export_html(cfg.spec, cfg.problem, out, obstacles=cfg.obstacles)
    else:
        plot_scene(cfg.spec, cfg.problem, obstacles=cfg.obstacles, path=out)
    print(json.dumps(dict(written=out)))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ikpso")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve", help="one solve from config")
    _add_common(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("experiment", help="frames-to-converge protocol")
    _add_common(p)
    p.add_argument("--trials", type=int, default=32)
    p.add_argument(
        "--trial-batch", type=int, default=32,
        help="max trials solved as one parallel batch (memory cap)",
    )
    p.add_argument("--eps", type=float, default=0.025)
    p.add_argument("--max-frames", type=int, default=300)
    p.add_argument("--outdir", default=None, help="diagnostics directory")
    p.add_argument(
        "--progress", action="store_true",
        help="per-frame convergence progress on stderr",
    )
    p.set_defaults(fn=cmd_experiment)

    p = sub.add_parser(
        "parity",
        help="frames-to-converge distribution vs the reference's raw "
        "results.xlsx (KS test + bootstrap CI per protocol)",
    )
    p.add_argument("--trials", type=int, default=512)
    p.add_argument("--trial-batch", type=int, default=128)
    p.add_argument("--particles", type=int, default=16384)
    p.add_argument("--max-frames", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument(
        "--protocols", default=None,
        help="comma list of iter1,iter2,iter3 (default: all)",
    )
    p.add_argument(
        "--pso-variant", choices=("shipped", "struct"), default="shipped",
        help="PSO coefficients: the shipped Main.cpp hardcode "
        "(0.5/0.5/1.25, 15 it) or the Particle.h struct defaults "
        "(0.2/0.5/0.7, 10 it) — the historical-config hypothesis for "
        "the iteration-1/2 reports",
    )
    p.add_argument(
        "--rng-stream", choices=("independent", "session"),
        default="independent",
        help="RNG protocol: fresh per-frame key splits (independent "
        "trials) or 'session' — one stream advancing across all "
        "frames and trials, the reference's curand_init-once "
        "semantics (utility_kernels.cuh:28; the stream-continuation "
        "hypothesis for the iteration-2 delta)",
    )
    p.add_argument("--out", default=None, help="append JSON record to FILE")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("sweep", help="trajectory waypoint sweep")
    _add_common(p)
    p.add_argument("--waypoints", type=int, default=1024)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--jitter", type=float, default=0.25)
    p.add_argument("--checkpoint", default=None)
    p.add_argument(
        "--retries", type=int, default=None,
        help="top-k retry rounds per batch (re-solve the worst eighth; "
        "default 0, or the model preset's with --preset)",
    )
    p.add_argument(
        "--retry-init-mode", choices=("warm", "uniform", "hybrid"),
        default=None,
        help="swarm init for the retry rounds only (default: same as "
        "--init-mode); uniform/hybrid de-correlates wrong-basin "
        "retries from the failed warm basin",
    )
    p.add_argument(
        "--retry-iterations", type=int, default=None,
        help="PSO iterations for the retry rounds only (deep retries "
        "on the failed bucket; default: same as the base config)",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="shard the sweep across jax.distributed processes: each "
        "process solves its contiguous waypoint block on its local "
        "devices, results merge across processes (BASELINE config 5)",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="jax.distributed coordinator address (required: nothing "
        "auto-detects a cluster)",
    )
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser(
        "track",
        help="track moving targets: scan-chained per-frame re-solves",
    )
    _add_common(p)
    p.add_argument("--steps", type=int, default=120, help="path length T")
    p.add_argument(
        "--paths", type=int, default=256,
        help="S independent trajectories tracked in parallel",
    )
    p.add_argument("--radius", type=float, default=0.25)
    p.add_argument("--revolutions", type=float, default=1.0)
    p.add_argument(
        "--settle", type=int, default=None,
        help="steps to exclude from steady-state error stats "
        "(default steps//4; the initial convergence transient)",
    )
    p.add_argument(
        "--timeit", action="store_true",
        help="run twice and report steady-state wall time",
    )
    p.add_argument(
        "--follow", default=None, metavar="FILE|-",
        help="STREAMING mode: consume target updates line-by-line "
        "from FILE (or stdin with '-') and re-solve warm per update, "
        "printing one JSON record per step — the reference's "
        "interactive target-drag loop (Main.cpp:401-453) fed by a "
        "pipe instead of a mouse. Line format: JSON [[x,y,z],...] or "
        "3*E whitespace-separated floats",
    )
    p.set_defaults(fn=cmd_track)

    p = sub.add_parser("viz", help="render scene to html/png")
    _add_common(p)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_viz)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
