"""Forward kinematics vs the 4x4-matrix oracle and analytic poses."""

import numpy as np

from ikpso.models import library
from ikpso.models.chain import make_chain_spec
from ikpso.ops import fk as fk_ops

from oracle import fk_positions_oracle


def test_straight_chain_analytic():
    # All angles zero: links extend along +X, one unit apart.
    spec, problem = library.serial_chain(4, link_length=1.0)
    pos = np.asarray(fk_ops.fk_points(spec, problem.pose, problem.origin))
    expected = np.stack(
        [np.array([k, 0.0, 0.0]) for k in range(5)]
    )
    np.testing.assert_allclose(pos, expected, atol=1e-6)


def test_planar_elbow_analytic():
    # 2-link planar arm, 90-degree bend at the second joint.
    spec, problem = library.serial_chain(2, link_length=1.0, free_axes=(2,))
    pose = np.zeros((3, 3), np.float32)
    pose[2, 2] = np.pi / 2
    pos = np.asarray(fk_ops.fk_points(spec, pose, problem.origin))
    np.testing.assert_allclose(pos[1], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(pos[2], [1.0, 1.0, 0.0], atol=1e-6)


def test_root_rotation_and_origin():
    # Rotate the whole arm 90 degrees about Z at a shifted origin.
    spec, problem = library.serial_chain(1, link_length=2.0)
    pose = np.zeros((2, 3), np.float32)
    pose[0, 2] = np.pi / 2
    origin = np.array([5.0, -1.0, 0.5], np.float32)
    pos = np.asarray(fk_ops.fk_points(spec, pose, origin))
    np.testing.assert_allclose(pos[0], origin, atol=1e-6)
    np.testing.assert_allclose(pos[1], origin + [0.0, 2.0, 0.0], atol=1e-5)


def test_tree_matches_oracle(rng):
    spec, problem = library.reference_arm()
    for _ in range(10):
        pose = rng.uniform(0, 2 * np.pi, size=(8, 3)).astype(np.float32)
        origin = rng.uniform(-1, 1, size=3).astype(np.float32)
        ours = np.asarray(fk_ops.fk_points(spec, pose, origin))
        ref = fk_positions_oracle(
            spec.parent, np.asarray(spec.length), pose.astype(np.float64), origin
        )
        np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_tree_branches_share_parent():
    # The reference arm's three effectors all hang off elbow 4.
    spec, problem = library.reference_arm()
    pos = np.asarray(fk_ops.fk_points(spec, problem.pose, problem.origin))
    parent_pos = pos[4]
    for e in spec.effector_idx:
        d = np.linalg.norm(pos[e] - parent_pos)
        np.testing.assert_allclose(d, 1.0, atol=1e-5)  # link length 1


def test_fk_batched_consistency(rng):
    spec, _ = library.reference_arm()
    poses = rng.uniform(0, 2 * np.pi, size=(6, 8, 3)).astype(np.float32)
    origins = rng.uniform(-1, 1, size=(6, 3)).astype(np.float32)
    batched = np.asarray(fk_ops.fk_points(spec, poses, origins))
    for i in range(6):
        single = np.asarray(fk_ops.fk_points(spec, poses[i], origins[i]))
        np.testing.assert_allclose(batched[i], single, atol=1e-6)


def test_fk_serial_scan_matches_unrolled(rng):
    spec, problem = library.serial_chain(12, link_length=0.5)
    pose = rng.uniform(-np.pi, np.pi, size=(13, 3)).astype(np.float32)
    p1, r1 = fk_ops.fk(spec, pose, problem.origin)
    p2, r2 = fk_ops.fk_serial_scan(spec, pose, problem.origin)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-4)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), atol=1e-4)


def test_angles_pose_roundtrip(rng):
    spec, problem = library.reference_arm()
    angles = rng.uniform(0, 2 * np.pi, size=(spec.dof,)).astype(np.float32)
    pose = fk_ops.angles_to_pose(spec, problem.pose[0], angles)
    assert pose.shape == (8, 3)
    back = np.asarray(fk_ops.pose_to_angles(spec, pose))
    np.testing.assert_allclose(back, angles, atol=0)
    np.testing.assert_allclose(np.asarray(pose)[0], np.asarray(problem.pose)[0])


def test_effector_positions_shape():
    spec, problem = library.reference_arm()
    eff = fk_ops.effector_positions(spec, problem.pose, problem.origin)
    assert eff.shape == (3, 3)
