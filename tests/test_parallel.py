"""Sharded solves on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models import library
from ikpso.ops.fitness import FitnessConfig
from ikpso.parallel.mesh import hybrid_mesh, make_mesh, swarm_mesh
from ikpso.parallel.sharded import distributed_argmin, solve_sharded
from ikpso.pso.config import PSOConfig
from ikpso.pso.solver import solve


def _batched(problem, s):
    targets = jnp.broadcast_to(problem.targets, (s,) + problem.targets.shape)
    return library.batched_problem(problem, targets)


def test_swarm_sharded_matches_shapes_and_converges():
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 16)
    mesh = swarm_mesh()
    res = solve_sharded(
        spec, batched, jax.random.key(0), mesh,
        pso=PSOConfig(iterations=40),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=128,
    )
    assert res.angles.shape == (16, spec.dof)
    err = np.asarray(res.effector_error)
    assert err.shape == (16,)
    assert float(err.mean()) < 0.1


def test_particle_sharded_equals_quality_of_unsharded():
    # An 8-way particle-sharded solve with 256 global particles should
    # converge comparably to a single-device 256-particle solve.
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 2)
    mesh = make_mesh((8,), ("particle",))
    res = solve_sharded(
        spec, batched, jax.random.key(0), mesh,
        pso=PSOConfig(iterations=60),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=256,
    )
    err = np.asarray(res.effector_error)
    assert np.all(err < 0.1), err


def test_hybrid_mesh_2d():
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 8)
    mesh = hybrid_mesh(2)  # 4 swarm shards x 2 particle shards
    res = solve_sharded(
        spec, batched, jax.random.key(1), mesh,
        pso=PSOConfig(iterations=30),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=64,
    )
    assert res.angles.shape == (8, spec.dof)
    assert np.isfinite(np.asarray(res.fitness)).all()


def test_distributed_argmin_correctness():
    # Verify the min+owner-select all-reduce against a local argmin.
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh((8,), ("particle",))
    s, d = 4, 3
    key = jax.random.key(0)
    vals = jax.random.uniform(key, (8, s))  # one row per device
    coords = jax.random.normal(jax.random.fold_in(key, 1), (8, s, d))

    def body(v, c):
        # v: (1, S) local shard; c: (1, S, D)
        return distributed_argmin(v[0], c[0], "particle")

    gval, gcoords = jax.jit(
        jax.shard_map(
            body, mesh=mesh, in_specs=(P("particle"), P("particle")),
            out_specs=(P(), P()),
        )
    )(vals, coords)

    expect_idx = np.argmin(np.asarray(vals), axis=0)
    expect_val = np.min(np.asarray(vals), axis=0)
    np.testing.assert_allclose(np.asarray(gval), expect_val, rtol=1e-6)
    for i in range(s):
        np.testing.assert_allclose(
            np.asarray(gcoords)[i], np.asarray(coords)[expect_idx[i], i], rtol=1e-6
        )


def test_sharded_matches_single_device_with_same_stream():
    # Swarm sharding only re-keys per shard; a 1-device mesh must
    # reproduce the unsharded result exactly (same fold_in sequence).
    spec, problem = library.planar_3dof()
    batched = _batched(problem, 4)
    mesh = make_mesh((1,), ("swarm",))
    res_sharded = solve_sharded(
        spec, batched, jax.random.key(5), mesh,
        pso=PSOConfig(iterations=10), num_particles=32,
    )
    key = jax.random.fold_in(jax.random.key(5), 0)
    res_local = solve(
        spec, batched, key, pso=PSOConfig(iterations=10), num_particles=32
    )
    np.testing.assert_allclose(
        np.asarray(res_sharded.angles), np.asarray(res_local.angles), atol=1e-6
    )


def test_sharded_solver_composes_with_polish():
    # wrap_with_polish over the swarm-sharded solver: the polish math
    # is batched over the swarm axis, so under jit it inherits the
    # sharding with zero cross-device communication and must not
    # regress any swarm (the accept gate).
    from ikpso.parallel.sharded import make_sharded_solver
    from ikpso.pso.polish import wrap_with_polish

    spec, problem = library.arm_7dof()
    s = 16
    key = jax.random.key(0)
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    rand = jax.random.uniform(
        key, (s, spec.dof), minval=0.8 * lo, maxval=0.8 * hi,
        dtype=jnp.float32,
    )
    from ikpso.ops import fk as fk_ops

    pose = fk_ops.angles_to_pose(
        spec, jnp.broadcast_to(problem.pose[0], (s, 3)), rand
    )
    targets = fk_ops.fk_points(spec, pose, problem.origin)[
        :, list(spec.effector_idx), :
    ]
    batched = library.batched_problem(problem, targets)
    mesh = swarm_mesh()
    base = make_sharded_solver(
        spec, mesh,
        pso=PSOConfig(iterations=10, inertia_mode="canonical",
                      inertia=0.5, inertia_end=0.2),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=128,
    )
    polished = wrap_with_polish(base, spec, steps=4)
    rb = base(batched, key)
    rp = polished(batched, key)
    eb = np.asarray(rb.effector_error)
    ep = np.asarray(rp.effector_error)
    assert (ep <= eb + 1e-6).all()
    assert np.median(ep) < 1e-4


def test_fused_solver_on_swarm_mesh_matches_unsharded():
    # The megakernel under shard_map: the pallas_call runs inside each
    # shard's program (interpret mode here). Each shard folds its
    # index into the key (solve_sharded), so the sharded solve must
    # equal, bit for bit, the unsharded solves of each shard's slice
    # with that shard's key — the seam (packing, grid split, result
    # unpacking) is shard-invariant.
    import pytest

    from ikpso.pso.fused import make_fused_solver

    spec, problem = library.arm_7dof()
    s = 16
    # Distinct targets per swarm so shard placement actually matters.
    key = jax.random.key(7)
    offs = 0.1 * jax.random.normal(key, (s,) + problem.targets.shape)
    targets = jnp.broadcast_to(problem.targets, (s,) + problem.targets.shape) + offs
    batched = library.batched_problem(problem, targets)
    mesh = swarm_mesh()
    n = mesh.shape["swarm"]

    kw = dict(
        pso=PSOConfig(iterations=8),
        fit=FitnessConfig(angle_weight=0.0),
        num_particles=128,
    )
    res_mesh = solve_sharded(
        spec, batched, key, mesh, impl="fused", interpret=True, **kw
    )
    assert res_mesh.angles.shape == (s, spec.dof)
    local = make_fused_solver(spec, interpret=True, **kw)
    per = s // n
    for i in range(n):
        part = jax.tree.map(lambda x: x[i * per:(i + 1) * per], batched)
        r = local(part, jax.random.fold_in(key, i))
        np.testing.assert_array_equal(
            np.asarray(res_mesh.angles)[i * per:(i + 1) * per],
            np.asarray(r.angles),
        )
        np.testing.assert_array_equal(
            np.asarray(res_mesh.fitness)[i * per:(i + 1) * per],
            np.asarray(r.fitness),
        )

    # Particle-axis sharding is jnp-only; the fused path must refuse it
    # loudly rather than silently mis-reduce.
    with pytest.raises(ValueError, match="fused"):
        solve_sharded(
            spec, batched, key, make_mesh((8,), ("particle",)),
            impl="fused", interpret=True, **kw
        )


def test_fused_solver_on_hybrid_swarm_mesh_with_obstacles():
    # Megakernel + mesh + obstacles + orientation in one program: the
    # widest kernel configuration under shard_map.
    from ikpso.models.chain import Obstacles
    from ikpso.ops import fk as fk_ops

    spec, problem = library.arm_7dof()
    s = 8
    targets = jnp.broadcast_to(problem.targets, (s,) + problem.targets.shape)
    world_rot = fk_ops.fk(spec, problem.pose, problem.origin)[1][
        np.array(spec.effector_idx)
    ]
    from ikpso.ops.rotations import matrix_to_quaternion, quaternion_to_euler_xyz

    target_rot = jnp.broadcast_to(
        quaternion_to_euler_xyz(matrix_to_quaternion(world_rot)),
        (s, len(spec.effector_idx), 3),
    )
    batched = library.batched_problem(problem, targets, target_rot=target_rot)
    obstacles = Obstacles.from_boxes(
        jnp.asarray([[3.0, 3.0, 3.0]]), jnp.asarray([[0.5, 0.5, 0.5]])
    )
    res = solve_sharded(
        spec, batched, jax.random.key(0), swarm_mesh(),
        impl="fused", interpret=True,
        pso=PSOConfig(iterations=8),
        fit=FitnessConfig(angle_weight=0.0, orientation_weight=1.0),
        obstacles=obstacles, num_particles=256,
    )
    assert res.angles.shape == (s, spec.dof)
    assert np.isfinite(np.asarray(res.fitness)).all()
    # Far-away obstacle: the warm-started anchor stays feasible, so no
    # swarm may end at the collision penalty.
    assert (np.asarray(res.fitness) < 1e30).all()


def test_track_trajectories_on_swarm_mesh():
    # Tracking with the S (trajectory) axis sharded over the 8-device
    # mesh. RNG is re-keyed per shard (fold_in of the shard index, see
    # solve_sharded), so trajectories differ from the unsharded run
    # stream-wise — the contract is equal tracking QUALITY with the
    # scan chain intact per shard.
    from ikpso.harness.trajectory import circle_paths, track_trajectories

    spec, problem = library.arm_7dof()
    path = circle_paths(
        np.asarray(problem.targets), steps=16, num_paths=8, seed=3,
        radius=0.15, revolutions=0.25,
    )
    kw = dict(
        pso=PSOConfig(iterations=15, inertia_mode="canonical"),
        fit=FitnessConfig(angle_weight=0.3),
        num_particles=256,
    )
    key = jax.random.key(5)
    r_local = track_trajectories(spec, problem, path, key, **kw)
    r_mesh = track_trajectories(
        spec, problem, path, key, mesh=swarm_mesh(), **kw
    )
    assert r_mesh.errors.shape == r_local.errors.shape == (16, 8)
    # Both settle to the same tracking quality.
    assert r_mesh.errors[6:].max() < 5e-2
    assert abs(
        np.median(r_mesh.errors[6:]) - np.median(r_local.errors[6:])
    ) < 2e-2
