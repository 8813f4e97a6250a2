"""Analytic geometric Jacobian vs the jacfwd oracle.

ops/jacobian.py computes effector-pose Jacobians in closed form (one
FK pass of cross products); these tests pin it against forward-mode
autodiff through the same FK (the ground truth by construction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ikpso.models import library
from ikpso.ops import fk as fk_ops
from ikpso.ops.jacobian import ancestry_mask, fk_with_jacobian
from ikpso.pso.polish import _residual_fn


def _random_setup(spec, problem, key, s):
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    angles = jax.random.uniform(
        key, (s, spec.dof), minval=0.9 * lo, maxval=0.9 * hi,
        dtype=jnp.float32,
    )
    batched = library.batched_problem(
        problem, jnp.zeros((s,) + problem.targets.shape[-2:], jnp.float32)
    )
    return batched, angles


@pytest.mark.parametrize(
    "model", ["arm_7dof", "reference_arm", "dual_arm_14dof", "planar_3dof"]
)
def test_position_jacobian_matches_jacfwd(model):
    spec, problem = getattr(library, model)()
    batched, angles = _random_setup(spec, problem, jax.random.key(0), s=8)
    single = _residual_fn(spec, False, 1.0)
    tr = jnp.zeros_like(batched.targets)
    j_ad = jax.vmap(jax.jacfwd(single))(
        angles, batched.pose[:, 0, :], batched.origin, batched.targets, tr
    )
    pose = fk_ops.angles_to_pose(spec, batched.pose[..., 0, :], angles)
    _, _, j_an = fk_with_jacobian(spec, pose, batched.origin)
    # _residual_fn weights rows by sqrt(effector_weight); mirror it.
    w = jnp.repeat(
        jnp.sqrt(spec.effector_weight[jnp.array(list(spec.effector_idx))]), 3
    )
    np.testing.assert_allclose(
        np.asarray(j_an * w[:, None]), np.asarray(j_ad), atol=2e-5
    )


def test_orientation_jacobian_matches_jacfwd_at_alignment():
    # The orientation rows are the world joint axes — exact where
    # R_fk == R_target (the rotation-vector residual's zero), which is
    # where quadratic convergence needs them.
    spec, problem = library.arm_6dof()
    s = 8
    key = jax.random.key(1)
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    angles = jax.random.uniform(
        key, (s, spec.dof), minval=0.9 * lo, maxval=0.9 * hi,
        dtype=jnp.float32,
    )
    pose = fk_ops.angles_to_pose(
        spec, jnp.broadcast_to(problem.pose[0], (s, 3)), angles
    )
    pos, rot = fk_ops.fk(spec, pose, problem.origin)
    eff = list(spec.effector_idx)
    from ikpso.ops.rotations import matrix_to_quaternion, quaternion_to_euler_xyz

    batched = library.batched_problem(
        problem,
        pos[:, eff, :],
        target_rot=quaternion_to_euler_xyz(matrix_to_quaternion(rot[:, eff])),
    )
    single = _residual_fn(spec, True, 1.0)
    j_ad = jax.vmap(jax.jacfwd(single))(
        angles, batched.pose[:, 0, :], batched.origin, batched.targets,
        batched.target_rot,
    )
    _, _, j_an = fk_with_jacobian(spec, pose, batched.origin, orientation=True)
    np.testing.assert_allclose(np.asarray(j_an), np.asarray(j_ad), atol=1e-4)


def test_ancestry_mask_tree():
    spec, _ = library.reference_arm()
    mask = ancestry_mask(spec)
    # 3 effectors, each path passes through the 4 serial elbows plus
    # its own effector node only (SURVEY.md §2.3 arm topology).
    assert mask.shape == (3, spec.num_nodes - 1)
    for ei, node in enumerate(spec.effector_idx):
        assert mask[ei, node - 1] == 1.0
    # Elbow chain nodes (1..4) are shared ancestors of all effectors.
    assert (mask[:, :4] == 1.0).all()
    # No effector is an ancestor of another.
    for ei, node in enumerate(spec.effector_idx):
        for ej in range(mask.shape[0]):
            if ej != ei:
                assert mask[ej, node - 1] == 0.0


def test_jacobian_batch_shapes():
    spec, problem = library.arm_7dof()
    pose = jnp.broadcast_to(problem.pose, (5, 2) + problem.pose.shape)
    origin = jnp.broadcast_to(problem.origin, (5, 2, 3))
    pe, re, j = fk_with_jacobian(spec, pose, origin)
    assert pe.shape == (5, 2, 1, 3)
    assert re.shape == (5, 2, 1, 3, 3)
    assert j.shape == (5, 2, 3, spec.dof)
