"""LM polish: quadratic local refinement of PSO solutions.

The polish stage is pure local optimization through the differentiable
FK (a capability the reference's opaque CUDA fitness cannot offer);
these tests pin down (a) convergence to float32 rounding from
near-solution starts, (b) joint-limit feasibility, (c) the per-swarm
accept-if-better gate that makes ``wrap_with_polish`` monotonic.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.models import library
from ikpso.models.chain import IKProblem
from ikpso.ops import fk as fk_ops
from ikpso.ops.fitness import FitnessConfig, true_effector_error
from ikpso.ops.rotations import euler_xyz_to_matrix
from ikpso.pso.config import PSOConfig
from ikpso.pso.polish import polish_angles, wrap_with_polish
from ikpso.pso.solver import make_solver


def _perturbed_batch(spec, problem, key, s, scale):
    """S reachable targets + starts perturbed `scale` rad off the truth."""
    k1, k2 = jax.random.split(key)
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    true_angles = jax.random.uniform(
        k1, (s, spec.dof), minval=0.8 * lo, maxval=0.8 * hi, dtype=jnp.float32
    )
    pose = fk_ops.angles_to_pose(
        spec, jnp.broadcast_to(problem.pose[0], (s, 3)), true_angles
    )
    targets = fk_ops.fk_points(spec, pose, problem.origin)[
        :, list(spec.effector_idx), :
    ]
    batched = library.batched_problem(problem, targets)
    start = jnp.clip(
        true_angles
        + scale * jax.random.normal(k2, true_angles.shape, jnp.float32),
        lo,
        hi,
    )
    return batched, start


def test_polish_converges_from_near_solution():
    spec, problem = library.arm_7dof()
    batched, start = _perturbed_batch(
        spec, problem, jax.random.key(0), s=64, scale=0.05
    )
    out = polish_angles(spec, batched, start, steps=6)
    pose = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], out)
    err = np.asarray(true_effector_error(spec, pose, batched))
    # Quadratic convergence: 0.05 rad off -> float32 rounding floor.
    assert np.percentile(err, 50) < 1e-6
    assert np.percentile(err, 95) < 1e-4


def test_polish_respects_joint_limits():
    spec, problem = library.arm_7dof()
    batched, start = _perturbed_batch(
        spec, problem, jax.random.key(1), s=32, scale=0.3
    )
    out = np.asarray(polish_angles(spec, batched, start, steps=5))
    lo = np.asarray(spec.min_rotation[1:].reshape(-1))
    hi = np.asarray(spec.max_rotation[1:].reshape(-1))
    assert (out >= lo - 1e-6).all() and (out <= hi + 1e-6).all()


def test_polish_monotonic_per_swarm():
    # LM steps are accept-if-better on the residual norm: even from far
    # starts (some outside the convergence basin) no swarm's error may
    # regress past its starting point by more than float noise.
    spec, problem = library.arm_7dof()
    batched, start = _perturbed_batch(
        spec, problem, jax.random.key(2), s=64, scale=1.5
    )
    pose0 = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], start)
    err0 = np.asarray(true_effector_error(spec, pose0, batched))
    out = polish_angles(spec, batched, start, steps=5)
    pose1 = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], out)
    err1 = np.asarray(true_effector_error(spec, pose1, batched))
    # Residual-norm gating is in weighted-squared space == true error
    # monotonic for the pure position task.
    assert (err1 <= err0 + 1e-5).all()
    assert np.median(err1) < np.median(err0)


def test_polish_far_start_damping_race():
    # The per-step 0.1/1/10x damping race must converge from FAR
    # starts too (a single-lambda LM wastes its first steps climbing
    # lambda after the GN step overshoots; measured stall at 0.7-unit
    # error before the race was added).
    spec, problem = library.arm_7dof()
    batched, start = _perturbed_batch(
        spec, problem, jax.random.key(7), s=128, scale=1.0
    )
    out = polish_angles(spec, batched, start, steps=8)
    pose = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], out)
    err = np.asarray(true_effector_error(spec, pose, batched))
    assert np.percentile(err, 50) < 1e-5
    assert (err < 1e-4).mean() > 0.85


def test_polish_multi_effector_tree():
    # 21-DOF tree with 3 effectors (the reference arm): M=9 residuals,
    # D=21 — the underdetermined branch of the normal equations.
    spec, problem = library.reference_arm()
    batched, start = _perturbed_batch(
        spec, problem, jax.random.key(3), s=32, scale=0.03
    )
    out = polish_angles(spec, batched, start, steps=6)
    pose = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], out)
    err = np.asarray(true_effector_error(spec, pose, batched))
    assert np.percentile(err, 50) < 1e-5


def test_polish_orientation_targets():
    spec, problem = library.arm_7dof()
    s = 32
    k1, k2 = jax.random.split(jax.random.key(4))
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    true_angles = jax.random.uniform(
        k1, (s, spec.dof), minval=0.8 * lo, maxval=0.8 * hi, dtype=jnp.float32
    )
    pose = fk_ops.angles_to_pose(
        spec, jnp.broadcast_to(problem.pose[0], (s, 3)), true_angles
    )
    pos, rot = fk_ops.fk(spec, pose, problem.origin)
    eff = list(spec.effector_idx)
    from ikpso.ops.rotations import matrix_to_quaternion, quaternion_to_euler_xyz

    batched = library.batched_problem(
        problem,
        pos[:, eff, :],
        target_rot=quaternion_to_euler_xyz(matrix_to_quaternion(rot[:, eff])),
    )
    start = jnp.clip(
        true_angles + 0.05 * jax.random.normal(k2, true_angles.shape), lo, hi
    )
    out = polish_angles(
        spec, batched, start, steps=8, use_orientation=True
    )
    pose1 = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], out)
    perr = np.asarray(true_effector_error(spec, pose1, batched))
    rot1 = fk_ops.fk(spec, pose1, batched.origin)[1][:, eff]
    rt = euler_xyz_to_matrix(batched.target_rot)
    tr = np.asarray(jnp.einsum("seij,seij->se", rot1, rt))
    geo = np.degrees(np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0)))
    assert np.percentile(perr, 50) < 1e-4
    assert np.percentile(geo.max(axis=-1), 50) < 0.1  # degrees


def test_wrap_with_polish_improves_solver():
    # A deliberately under-iterated PSO run: polish must close the gap
    # and never regress any swarm (the accept gate).
    spec, problem = library.arm_7dof()
    batched, _ = _perturbed_batch(
        spec, problem, jax.random.key(5), s=48, scale=0.0
    )
    pso = PSOConfig(
        iterations=12, inertia_mode="canonical", inertia=0.5, inertia_end=0.2
    )
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    base = make_solver(spec, pso=pso, fit=fit, num_particles=128)
    polished = wrap_with_polish(base, spec, steps=4)
    key = jax.random.key(6)
    rb = base(batched, key)
    rp = polished(batched, key)
    eb = np.asarray(rb.effector_error)
    ep = np.asarray(rp.effector_error)
    assert (ep <= eb + 1e-6).all()
    assert np.median(ep) < np.median(eb) * 0.1
    # Result pose stays consistent with the angles field.
    pose = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], rp.angles)
    np.testing.assert_allclose(np.asarray(pose), np.asarray(rp.pose), atol=1e-6)


def test_polish_locality_rows_keep_motion_small():
    # Tikhonov locality rows mirror the reference's angular-locality
    # fitness term: the polished point stays near the anchor pose at
    # some cost in position error, and the combined residual cost
    # never regresses.
    from ikpso.pso.polish import residual_cost

    spec, problem = library.arm_7dof()
    batched, _ = _perturbed_batch(
        spec, problem, jax.random.key(8), s=32, scale=0.0
    )
    anchor = fk_ops.pose_to_angles(spec, batched.pose)
    x_pure = polish_angles(spec, batched, anchor, steps=6)
    x_loc = polish_angles(
        spec, batched, anchor, steps=6, locality_weight=1.0
    )
    d_pure = np.abs(np.asarray(x_pure - anchor)).mean()
    d_loc = np.abs(np.asarray(x_loc - anchor)).mean()
    assert d_loc < d_pure
    cost0 = np.asarray(residual_cost(spec, batched, anchor, locality_weight=1.0))
    cost1 = np.asarray(residual_cost(spec, batched, x_loc, locality_weight=1.0))
    assert (cost1 <= cost0 + 1e-6).all()
    assert cost1.mean() < cost0.mean()


def test_soa_path_matches_general_path():
    # polish_angles dispatches position-only polish to the SoA core;
    # it must match the general tensor path (forced via a degenerate
    # locality weight of 0 through the internal API) to float rounding.
    import ikpso.pso.polish as polish_mod
    from ikpso.pso.polish_soa import polish_angles_soa

    for model in ("arm_7dof", "reference_arm", "dual_arm_14dof"):
        spec, problem = getattr(library, model)()
        batched, start = _perturbed_batch(
            spec, problem, jax.random.key(11), s=32, scale=0.2
        )
        x_soa = polish_angles_soa(
            spec, batched, start, steps=6, init_damping=1e-3
        )
        x_gen = polish_mod.polish_angles(
            spec, batched, start, steps=6, soa=False
        )
        pose_s = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], x_soa)
        pose_g = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], x_gen)
        err_s = np.asarray(true_effector_error(spec, pose_s, batched))
        err_g = np.asarray(true_effector_error(spec, pose_g, batched))
        # Same convergence quality (trajectories may split at FP ties).
        assert abs(np.median(err_s) - np.median(err_g)) < 1e-4, model
        assert np.percentile(err_s, 50) < 1e-4, model


def test_polish_gate_rejects_colliding_refinement():
    # The LM objective is blind to obstacles; with obstacles passed to
    # wrap_with_polish the accept gate must reject a polished pose
    # that enters a collider, keeping the feasible PSO answer.
    from ikpso.models.chain import Obstacles
    from ikpso.pso.solver import SolveResult

    spec, problem = library.planar_3dof(target=(2.5, 0.0, 0.0))
    # A box sitting on the target: reaching closer collides the
    # effector-node gizmo.
    obs = Obstacles.from_boxes(
        centers=np.array([[2.5, 0.0, 0.0]], np.float32),
        full_dims=np.array([[0.8, 0.8, 0.8]], np.float32),
    )
    s = 4
    batched = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (s,) + a.shape), problem
    )
    # Feasible start: arm bent well away from the box (DOF vector is
    # node-major 3-per-node; only the Z axes are articulated).
    one = np.zeros((spec.dof,), np.float32)
    one[[2, 5, 8]] = (0.9, 0.6, 0.3)
    start = jnp.broadcast_to(jnp.asarray(one), (s, spec.dof))
    pose0 = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], start)
    batched = batched.replace(pose=pose0)

    def fake_solver(prob, key):
        angles = fk_ops.pose_to_angles(spec, prob.pose)
        err = true_effector_error(spec, prob.pose, prob)
        return SolveResult(
            angles=angles, fitness=err, pose=prob.pose,
            effector_error=err, trace=err[None],
        )

    from ikpso.pso.polish import wrap_with_polish

    free = wrap_with_polish(fake_solver, spec, steps=5)(
        batched, jax.random.key(0)
    )
    gated = wrap_with_polish(fake_solver, spec, steps=5, obstacles=obs)(
        batched, jax.random.key(0)
    )
    base_err = np.asarray(true_effector_error(spec, pose0, batched))
    # Ungated polish would chase the target (improves error)...
    assert (np.asarray(free.effector_error) < base_err - 0.05).all()
    # ...but the polished pose collides, so the gate keeps the base.
    np.testing.assert_array_equal(np.asarray(gated.angles), np.asarray(start))
    np.testing.assert_allclose(
        np.asarray(gated.effector_error), base_err, rtol=1e-6
    )


def test_soa_locality_matches_general_path():
    # With locality rows the SoA core switches to the primal (D, D)
    # normal equations; it must match the general tensor path (both
    # use the unprojected gradient + clip). One step from identical
    # starts agrees to float rounding; multi-step runs agree on the
    # combined cost they minimize.
    import ikpso.pso.polish as polish_mod
    from ikpso.pso.polish import residual_cost
    from ikpso.pso.polish_soa import polish_angles_soa

    for model in ("arm_7dof", "reference_arm"):
        spec, problem = getattr(library, model)()
        batched, start = _perturbed_batch(
            spec, problem, jax.random.key(13), s=32, scale=0.2
        )
        w = 0.4
        x1s = polish_angles_soa(
            spec, batched, start, steps=1, init_damping=1e-3,
            locality_weight=w,
        )
        x1g = polish_mod.polish_angles(
            spec, batched, start, steps=1, soa=False, locality_weight=w
        )
        np.testing.assert_allclose(
            np.asarray(x1s), np.asarray(x1g), atol=2e-4, err_msg=model
        )
        xs = polish_angles_soa(
            spec, batched, start, steps=6, init_damping=1e-3,
            locality_weight=w,
        )
        xg = polish_mod.polish_angles(
            spec, batched, start, steps=6, soa=False, locality_weight=w
        )
        cs = np.asarray(residual_cost(spec, batched, xs, locality_weight=w))
        cg = np.asarray(residual_cost(spec, batched, xg, locality_weight=w))
        c0 = np.asarray(
            residual_cost(spec, batched, start, locality_weight=w)
        )
        assert (cs <= c0 + 1e-6).all(), model
        # Multi-step trajectories may split at FP ties; medians of the
        # minimized cost stay equivalent.
        assert abs(np.median(cs) - np.median(cg)) < 1e-3, model


def test_soa_orientation_matches_general_path():
    # Orientation rows in the SoA core (world rotation-vector residual
    # + joint-axis Jacobian rows) vs the general tensor path.
    import ikpso.pso.polish as polish_mod
    from ikpso.pso.polish_soa import polish_angles_soa
    from ikpso.ops.rotations import (
        matrix_to_quaternion, quaternion_to_euler_xyz,
    )

    spec, problem = library.arm_7dof()
    s = 32
    k1, k2 = jax.random.split(jax.random.key(17))
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    true_angles = jax.random.uniform(
        k1, (s, spec.dof), minval=0.8 * lo, maxval=0.8 * hi,
        dtype=jnp.float32,
    )
    pose = fk_ops.angles_to_pose(
        spec, jnp.broadcast_to(problem.pose[0], (s, 3)), true_angles
    )
    pos, rot = fk_ops.fk(spec, pose, problem.origin)
    eff = list(spec.effector_idx)
    batched = library.batched_problem(
        problem,
        pos[:, eff, :],
        target_rot=quaternion_to_euler_xyz(
            matrix_to_quaternion(rot[:, eff])
        ),
    )
    start = jnp.clip(
        true_angles + 0.1 * jax.random.normal(k2, true_angles.shape),
        lo, hi,
    )
    x1s = polish_angles_soa(
        spec, batched, start, steps=1, init_damping=1e-3,
        use_orientation=True, orientation_weight=0.5,
    )
    x1g = polish_mod.polish_angles(
        spec, batched, start, steps=1, soa=False,
        use_orientation=True, orientation_weight=0.5,
    )
    np.testing.assert_allclose(np.asarray(x1s), np.asarray(x1g), atol=2e-4)
    # Multi-step: both reach sub-0.1mm position + sub-degree rotation.
    xs = polish_angles_soa(
        spec, batched, start, steps=8, init_damping=1e-3,
        use_orientation=True, orientation_weight=0.5,
    )
    pose1 = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], xs)
    perr = np.asarray(true_effector_error(spec, pose1, batched))
    rot1 = fk_ops.fk(spec, pose1, batched.origin)[1][:, eff]
    rt = euler_xyz_to_matrix(batched.target_rot)
    tr = np.asarray(jnp.einsum("seij,seij->se", rot1, rt))
    geo = np.degrees(np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0)))
    assert np.percentile(perr, 50) < 1e-4
    assert np.percentile(geo.max(axis=-1), 50) < 0.1


def test_soa_routing_gate():
    # Every zoo model must land on the measured-correct LM path:
    # snakes at ANY depth stay SoA, while the wide
    # multi-effector humanoid must NOT trace the SoA core (>22 GB of
    # tracer state). Pins the m^2*D gate against future re-tuning.
    from ikpso.models import library
    from ikpso.pso.polish import soa_traceable

    for name, orient, want_soa in [
        ("arm_7dof", False, True),
        ("planar_3dof", False, True),
        ("arm_6dof", True, True),
        ("dual_arm_14dof", False, True),
        ("reference_arm", False, True),
        ("humanoid_45dof", False, False),
    ]:
        spec, _ = getattr(library, name)()
        assert soa_traceable(spec, spec.dof, orient) == want_soa, name
    for links in (30, 50, 100, 150, 170):
        spec, _ = library.snake(links)
        assert soa_traceable(spec, spec.dof, False), f"snake:{links}"
