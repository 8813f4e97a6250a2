"""Experiment harness, trajectory sweep, diagnostics, checkpoint, CLI."""

import json
import os

import jax
import numpy as np
import pytest

from ikpso.harness.experiment import frames_to_converge
from ikpso.harness.trajectory import solve_waypoints
from ikpso.models import library
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig
from ikpso.utils import checkpoint as ckpt
from ikpso.utils.diagnostics import DiagnosticsWriter, SolveLogger


def test_frames_to_converge_planar(tmp_path):
    # Small, CPU-friendly version of the reference protocol.
    spec, problem = library.planar_3dof(target=(2.9, 0.3, 0.0))
    reset_targets = np.asarray([[1.5, 1.5, 0.0]], np.float32)
    diag = DiagnosticsWriter(str(tmp_path))
    result = frames_to_converge(
        spec,
        problem,
        reset_targets,
        jax.random.key(0),
        pso=PSOConfig(iterations=25),
        fit=FitnessConfig(angle_weight=0.5),
        num_particles=256,
        eps_dist=0.05,
        max_frames=60,
        trials=4,
        diagnostics=diag,
    )
    diag.close()
    s = result.summary()
    assert s["converged"] >= 3, s
    assert s["frames_avg"] >= 1
    # Diagnostics files written with the reference's schema.
    deg = (tmp_path / "IK-diagnostics-degrees.txt").read_text().strip().splitlines()
    assert len(deg) >= 1
    assert len(deg[0].split(";")) == spec.dof + 1  # trailing ';'
    frames_log = (tmp_path / "IK-diagnostics-frames.txt").read_text().strip()
    assert int(frames_log.splitlines()[0]) >= 1
    dist = (tmp_path / "IK-diagnostics-distance.txt").read_text().strip().splitlines()
    assert float(dist[0]) > 0


def test_frames_counts_are_plausible():
    # With a target jump and warm start, convergence should take >= 1
    # frame and improve monotonically-ish; all trials converge.
    spec, problem = library.planar_3dof(target=(2.9, 0.3, 0.0))
    result = frames_to_converge(
        spec,
        problem,
        np.asarray([[1.0, 2.0, 0.0]], np.float32),
        jax.random.key(1),
        pso=PSOConfig(iterations=30),
        fit=FitnessConfig(angle_weight=0.5),
        num_particles=512,
        eps_dist=0.05,
        max_frames=80,
        trials=4,
    )
    assert result.converged.all(), result.frames
    assert (result.frames[result.converged] >= 1).all()


def test_trial_batching_merges_independent_chunks():
    # trial_batch splits trials into sequential solver batches; the
    # merged result must cover all trials and preserve per-trial
    # independence (all converge, frames sane) — the mechanism that
    # lets 128+ reference-scale trials run without OOMing one chip.
    spec, problem = library.planar_3dof(target=(2.9, 0.3, 0.0))
    result = frames_to_converge(
        spec,
        problem,
        np.asarray([[1.5, 1.5, 0.0]], np.float32),
        jax.random.key(7),
        pso=PSOConfig(iterations=25),
        fit=FitnessConfig(angle_weight=0.5),
        num_particles=256,
        eps_dist=0.05,
        max_frames=60,
        trials=6,
        trial_batch=2,
    )
    assert result.frames.shape == (6,)
    assert result.converged.sum() >= 5, result.frames
    assert (result.frames[result.converged] >= 1).all()
    # Motion-delta statistics merge across chunks (reference report
    # tables: angle delta per DOF / node position delta).
    s = result.summary()
    for k in ("angle_delta", "pos_delta"):
        st = s[k]
        assert st["n"] > 0 and st["max"] >= st["min"] >= 0.0
        assert 0.0 < st["avg"] <= st["max"]


def test_trajectory_sweep_and_checkpoint(tmp_path):
    spec, problem = library.planar_3dof()
    rng = np.random.default_rng(0)
    base = np.asarray(problem.targets)
    waypoints = base[None] + rng.normal(scale=0.2, size=(10,) + base.shape).astype(
        np.float32
    )
    path = str(tmp_path / "sweep.npz")
    res = solve_waypoints(
        spec,
        problem,
        waypoints,
        jax.random.key(0),
        pso=PSOConfig(iterations=30),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=128,
        batch_size=4,
        checkpoint_path=path,
    )
    assert res.angles.shape == (10, spec.dof)
    assert np.isfinite(res.errors).all()
    assert (res.errors < 0.25).mean() > 0.7

    # Checkpoint recorded completion; resuming does no work and
    # returns identical results.
    state = ckpt.load(path)
    assert state.cursor == 10
    res2 = solve_waypoints(
        spec,
        problem,
        waypoints,
        jax.random.key(0),
        num_particles=128,
        batch_size=4,
        checkpoint_path=path,
    )
    np.testing.assert_array_equal(res.angles, res2.angles)


def test_sweep_retry_init_mode_improves_far_waypoints():
    # Warm-start solves from the canonical pose cannot reach far
    # waypoints in few iterations; uniform-init retry rounds re-explore
    # globally and must strictly improve the error tail.
    spec, problem = library.planar_3dof()
    rng = np.random.default_rng(1)
    # Far reachable waypoints: FK of random in-limit poses.
    import jax.numpy as jnp

    from ikpso.ops import fk as fk_ops

    lo = np.asarray(spec.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec.max_rotation[1:]).reshape(-1)
    angles = rng.uniform(lo, hi, size=(8, spec.dof)).astype(np.float32)
    pose = fk_ops.angles_to_pose(
        spec, jnp.broadcast_to(problem.pose[0], (8, 3)), jnp.asarray(angles)
    )
    waypoints = np.asarray(
        fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
    )
    kw = dict(
        pso=PSOConfig(iterations=8),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=64,
        batch_size=8,
    )
    base = solve_waypoints(
        spec, problem, waypoints, jax.random.key(0), **kw
    )
    retried = solve_waypoints(
        spec, problem, waypoints, jax.random.key(0),
        retries=2, retry_init_mode="uniform", **kw
    )
    assert float(np.mean(retried.errors)) < float(np.mean(base.errors))
    # The retry wrapper never makes any waypoint worse.
    assert (retried.errors <= base.errors + 1e-6).all()


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "s.npz")
    st = ckpt.fresh_state(5, 9, jax.random.key(3))
    st.angles[2] = 1.5
    st = __import__("dataclasses").replace(st, cursor=3)
    ckpt.save(path, st)
    loaded = ckpt.load(path)
    assert loaded.cursor == 3
    np.testing.assert_array_equal(loaded.angles, st.angles)
    # Key round-trips through raw data.
    assert loaded.key is not None


def test_solve_logger(tmp_path):
    path = str(tmp_path / "solves.jsonl")
    with SolveLogger(path) as log:
        log.log(target=[1, 2, 3], iterations=15, final_error=0.01, wall_time_s=0.5)
        log.log(final_error=0.02, extra_field="x")
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["target"] == [1, 2, 3]
    assert json.loads(lines[1])["extra_field"] == "x"


def test_cli_solve_and_viz(tmp_path, capsys):
    from ikpso.harness.cli import main

    rc = main(
        [
            "solve",
            "--model",
            "planar_3dof",
            "--particles",
            "64",
            "--iterations",
            "5",
            "--cpu",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert "effector_error" in out

    html = str(tmp_path / "scene.html")
    rc = main(["viz", "--model", "reference_arm", "--out", html, "--cpu"])
    assert rc == 0
    capsys.readouterr()
    content = open(html).read()
    assert "SCENE" in content and "nodes" in content


def test_cli_preset_applies_frontier_recipe(capsys):
    # --preset fills unset knobs from pso/presets.py (canonical decay,
    # iterations, polish) while explicit flags still win.
    from ikpso.harness.cli import main
    from ikpso.pso.presets import fused_preset

    pre = fused_preset("arm_7dof")
    rc = main(["solve", "--model", "arm_7dof", "--preset", "--cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    # trace has one entry per iteration plus init.
    assert len(out["trace"]) == pre.iterations + 1
    assert out["effector_error"] < 0.05  # polish ran (PSO alone ~0.1+)

    # Explicit --iterations overrides the preset's.
    rc = main(
        ["solve", "--model", "arm_7dof", "--preset", "--iterations", "3",
         "--cpu"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["trace"]) == 4

    # snake:<links> shares the snake_30dof preset.
    assert fused_preset("snake:25") is fused_preset("snake_30dof")


def test_configio_roundtrip():
    from ikpso.utils.configio import dump_config, load_config

    cfg = load_config({"model": "reference_arm", "pso": {"iterations": 7}})
    assert cfg.pso.iterations == 7
    assert cfg.spec.dof == 21
    doc = dump_config(cfg)
    cfg2 = load_config(doc)
    assert cfg2.spec.parent == cfg.spec.parent
    assert cfg2.pso.iterations == 7
    np.testing.assert_allclose(
        np.asarray(cfg2.problem.targets), np.asarray(cfg.problem.targets)
    )


def test_configio_rejects_unknown_keys():
    from ikpso.utils.configio import load_config

    with pytest.raises(ValueError):
        load_config({"model": "planar_3dof", "pso": {"bogus": 1}})
    with pytest.raises(ValueError):
        load_config({"model": "nope"})


def test_configio_roundtrips_new_pso_fields():
    from ikpso.utils.configio import dump_config, load_config

    cfg = load_config(
        {
            "model": "planar_3dof",
            "pso": {
                "inertia_mode": "canonical",
                "inertia": 0.6,
                "inertia_end": 0.25,
                "gbest_interval": 2,
                "iterations": 10,
            },
        }
    )
    cfg2 = load_config(dump_config(cfg))
    assert cfg2.pso.inertia_end == 0.25
    assert cfg2.pso.gbest_interval == 2
    assert cfg2.pso.inertia_mode == "canonical"


def test_track_trajectories_follows_moving_targets():
    # Scan-chained tracking (reference Main.cpp frame loop, jitted
    # whole): after the convergence transient, a slowly-orbiting
    # target is followed to small error with smooth per-step motion,
    # and the pose chain is consistent (final_pose matches the last
    # step's angles).
    import jax.numpy as jnp

    from ikpso.harness.trajectory import circle_paths, track_trajectories
    from ikpso.ops import fk as fk_ops

    spec, problem = library.arm_7dof()
    path = circle_paths(
        np.asarray(problem.targets), steps=30, num_paths=4,
        radius=0.2, revolutions=0.5, seed=1,
    )
    assert path.shape == (30, 4, 1, 3)
    np.testing.assert_allclose(
        path[0], np.broadcast_to(np.asarray(problem.targets), (4, 1, 3)),
        atol=1e-6,
    )
    res = track_trajectories(
        spec, problem, path, jax.random.key(0),
        pso=PSOConfig(iterations=20, inertia_mode="canonical"),
        fit=FitnessConfig(angle_weight=0.3),
        num_particles=256, polish=3,
    )
    assert res.errors.shape == (30, 4)
    assert res.angles.shape == (30, 4, spec.dof)
    # Steady state: every path tracks to < 2cm from step 10 on.
    assert res.errors[10:].max() < 2e-2
    # Continuity: no step teleports a joint.
    step_delta = np.abs(np.diff(res.angles, axis=0))
    assert step_delta.max() < 1.0
    # final_pose is the scan carry: consistent with the last angles.
    expect = np.asarray(
        fk_ops.angles_to_pose(
            spec, jnp.asarray(res.final_pose)[..., 0, :],
            jnp.asarray(res.angles[-1]),
        )
    )
    np.testing.assert_allclose(res.final_pose, expect, atol=1e-6)


def test_follow_targets_streaming_resolves(tmp_path, capsys):
    # The ONLINE analog of the reference's interactive target drag
    # (Main.cpp:401-453): updates arrive one at a time from a stream,
    # each re-solved warm from the previous pose. End-to-end through
    # the CLI: 10 updates along an orbit of the home target, settled
    # error small, one JSON record per step.
    from ikpso.harness.cli import main
    from ikpso.harness.trajectory import circle_paths

    spec, problem = library.arm_7dof()
    path = circle_paths(
        np.asarray(problem.targets), steps=10, num_paths=1,
        radius=0.15, revolutions=0.5, seed=3,
    )  # (10, 1, E, 3) — same reachable orbit the batch tests use
    feed = tmp_path / "targets.txt"
    lines = ["# streamed target updates"]
    for t in range(10):
        lines.append(json.dumps(np.asarray(path[t, 0]).tolist()))
    feed.write_text("\n".join(lines) + "\n")

    rc = main(
        [
            "track", "--model", "arm_7dof", "--cpu",
            "--particles", "256", "--iterations", "20",
            "--inertia-mode", "canonical",
            "--polish", "3", "--angle-weight", "0.3",
            "--follow", str(feed),
        ]
    )
    assert rc == 0
    out_lines = [
        json.loads(s) for s in capsys.readouterr().out.splitlines() if s
    ]
    steps, summary = out_lines[:-1], out_lines[-1]
    assert len(steps) == 10
    assert [s["step"] for s in steps] == list(range(10))
    assert summary["steps"] == 10
    # Settled: after the initial convergence transient the stream
    # tracks to <2 cm (same bound as the scan-chained test).
    assert summary["err_max_settled"] < 2e-2
    # Warm continuity: later steps move joints smoothly.
    assert all(s["angle_delta_max"] < 1.0 for s in steps[1:])


def test_track_trajectories_deterministic():
    from ikpso.harness.trajectory import circle_paths, track_trajectories

    spec, problem = library.arm_7dof()
    path = circle_paths(
        np.asarray(problem.targets), steps=6, num_paths=2, seed=2,
    )
    kw = dict(pso=PSOConfig(iterations=10), num_particles=128)
    r1 = track_trajectories(spec, problem, path, jax.random.key(7), **kw)
    r2 = track_trajectories(spec, problem, path, jax.random.key(7), **kw)
    np.testing.assert_array_equal(r1.angles, r2.angles)
    np.testing.assert_array_equal(r1.errors, r2.errors)


def test_configio_parameterized_snake_model():
    # "snake:<links>" builds any chain depth at runtime — the
    # reference's compile-time DOF (ik_constants.h:3) as data.
    from ikpso.utils.configio import load_config

    cfg = load_config({"model": "snake:7"})
    assert cfg.spec.dof == 21
    assert cfg.spec.num_nodes == 8
    cfg30 = load_config({"model": "snake:10"})
    spec30, _ = library.snake_30dof()
    assert cfg30.spec.dof == spec30.dof == 30
    with pytest.raises(ValueError, match="snake"):
        load_config({"model": "nonexistent_model"})


def test_session_rng_stream_mode():
    # rng_mode="session": one logical stream advances across frames AND
    # trial chunks (the reference's curand_init-once semantics,
    # utility_kernels.cuh:28) — deterministic, distinct from the
    # independent-splits default, same statistics contract.
    spec, problem = library.planar_3dof(target=(2.9, 0.3, 0.0))
    kw = dict(
        pso=PSOConfig(iterations=25),
        fit=FitnessConfig(angle_weight=0.5),
        num_particles=256,
        eps_dist=0.05,
        max_frames=60,
        trials=4,
        trial_batch=2,
    )
    reset = np.asarray([[1.5, 1.5, 0.0]], np.float32)
    a = frames_to_converge(
        spec, problem, reset, jax.random.key(0), rng_mode="session", **kw
    )
    b = frames_to_converge(
        spec, problem, reset, jax.random.key(0), rng_mode="session", **kw
    )
    np.testing.assert_array_equal(a.frames, b.frames)
    np.testing.assert_array_equal(a.final_error, b.final_error)
    assert a.converged.sum() >= 3
    # The session stream is a different protocol than independent
    # splits: the per-frame keys differ, so the solve traces differ.
    c = frames_to_converge(
        spec, problem, reset, jax.random.key(0), rng_mode="independent",
        **kw
    )
    assert (a.final_error != c.final_error).any() or (
        a.frames != c.frames
    ).any()
    with pytest.raises(ValueError, match="rng_mode"):
        frames_to_converge(
            spec, problem, reset, jax.random.key(0), rng_mode="xorwow",
            **kw
        )


def test_follow_stream_origin_updates(tmp_path, capsys):
    # Mixed target + origin updates through the streaming CLI — the
    # reference's arrow-key arm-base drag (Main.cpp:401-453) alongside
    # target drags. After each base move the
    # warm re-solve must still settle on the (unchanged) target.
    from ikpso.harness.cli import main

    spec, problem = library.arm_7dof()
    tgt = np.asarray(problem.targets)[0]  # (3,)
    lines = ["# mixed stream: targets, base moves, one JSON object"]
    lines.append(json.dumps([tgt.tolist()]))
    lines.append(json.dumps([(tgt + [0.0, 0.1, 0.0]).tolist()]))
    # Arrow-key base drags: origin-only updates, targets held.
    lines.append("origin 0.05 0 0")
    lines.append("origin 0.1 0 0")
    # One atomic mixed update (both keys).
    lines.append(json.dumps({
        "targets": [(tgt + [0.0, 0.05, 0.0]).tolist()],
        "origin": [0.0, 0.0, 0.05],
    }))
    lines.append("origin 0 0 0")
    feed = tmp_path / "mixed.txt"
    feed.write_text("\n".join(lines) + "\n")

    rc = main(
        [
            "track", "--model", "arm_7dof", "--cpu",
            "--particles", "256", "--iterations", "20",
            "--inertia-mode", "canonical",
            "--polish", "3", "--angle-weight", "0.3",
            "--follow", str(feed),
        ]
    )
    assert rc == 0
    out_lines = [
        json.loads(s) for s in capsys.readouterr().out.splitlines() if s
    ]
    steps, summary = out_lines[:-1], out_lines[-1]
    assert len(steps) == 6
    assert summary["steps"] == 6
    # Base moves are small reachable shifts: the warm loop re-settles
    # each one to the tracking bound.
    assert summary["err_max_settled"] < 2e-2
    assert all(s["angle_delta_max"] < 1.0 for s in steps[1:])


def test_follow_updates_validation():
    # Malformed stream lines fail loudly with the line number, not as
    # an opaque reshape error mid-solve.
    from ikpso.harness.cli import _follow_updates

    def run(*lines):
        return list(_follow_updates(list(lines)))

    ok = run("1 2 3", "[[4, 5, 6]]", "origin 0 0 1",
             '{"origin": [1, 0, 0], "targets": [[1, 2, 3]]}')
    assert isinstance(ok[0], np.ndarray) and ok[0].shape == (1, 3)
    assert set(ok[2]) == {"origin"} and set(ok[3]) == {"origin", "targets"}

    with pytest.raises(ValueError, match="line 1.*3\\*E"):
        run("1 2 3 4")
    with pytest.raises(ValueError, match="line 2.*first update"):
        run("1 2 3", "[[1,2,3],[4,5,6]]")
    with pytest.raises(ValueError, match="line 1.*origin"):
        run("origin 1 2")
    with pytest.raises(ValueError, match="line 1"):
        run('{"target": [[1,2,3]]}')
    with pytest.raises(ValueError, match="line 1.*not a number"):
        run("one two three")
