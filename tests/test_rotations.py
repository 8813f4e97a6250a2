"""Rotation math vs the numpy oracle and algebraic identities."""

import numpy as np
import pytest

from ikpso.ops import rotations as rot

from oracle import mat_identity, mat_rotate_euler


def random_angles(rng, shape=()):
    return rng.uniform(-np.pi, np.pi, size=shape + (3,)).astype(np.float32)


def test_euler_matches_oracle(rng):
    for _ in range(20):
        a = random_angles(rng)
        ours = np.asarray(rot.euler_xyz_to_matrix(a))
        ref = mat_rotate_euler(mat_identity(), a.astype(np.float64))[:3, :3]
        np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_euler_batched(rng):
    a = random_angles(rng, (4, 5))
    batched = np.asarray(rot.euler_xyz_to_matrix(a))
    for i in range(4):
        for j in range(5):
            single = np.asarray(rot.euler_xyz_to_matrix(a[i, j]))
            np.testing.assert_allclose(batched[i, j], single, atol=1e-7)


def test_euler_matrix_is_orthonormal(rng):
    a = random_angles(rng, (64,))
    r = np.asarray(rot.euler_xyz_to_matrix(a))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), r.shape)
    np.testing.assert_allclose(r @ np.swapaxes(r, -1, -2), eye, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)


def test_quaternion_matrix_roundtrip(rng):
    a = random_angles(rng, (32,))
    m = rot.euler_xyz_to_matrix(a)
    q = rot.matrix_to_quaternion(m)
    m2 = np.asarray(rot.quaternion_to_matrix(q))
    np.testing.assert_allclose(np.asarray(m), m2, atol=1e-5)


def test_matrix_to_quaternion_covers_all_branches():
    # Rotations whose trace / diagonal dominance hit each of the four
    # extraction branches (reference matrix_operations.cuh:78-112).
    cases = [
        (0.1, 0.2, 0.3),            # tr > 0
        (np.pi - 0.01, 0.0, 0.0),   # m00 dominant
        (0.0, np.pi - 0.01, 0.0),   # m11 dominant
        (0.0, 0.0, np.pi - 0.01),   # m22 dominant
    ]
    for a in cases:
        a = np.asarray(a, np.float32)
        m = rot.euler_xyz_to_matrix(a)
        q = np.asarray(rot.matrix_to_quaternion(m))
        assert abs(np.linalg.norm(q) - 1.0) < 1e-4, a
        m2 = np.asarray(rot.quaternion_to_matrix(q))
        np.testing.assert_allclose(np.asarray(m), m2, atol=1e-4)


def test_euler_quaternion_consistency(rng):
    a = random_angles(rng, (16,))
    q = rot.euler_xyz_to_quaternion(a)
    m_from_q = np.asarray(rot.quaternion_to_matrix(q))
    m_direct = np.asarray(rot.euler_xyz_to_matrix(a))
    np.testing.assert_allclose(m_from_q, m_direct, atol=1e-5)


def test_quaternion_to_euler_roundtrip(rng):
    # Restrict y to avoid the gimbal ambiguity; x/z full range.
    a = np.stack(
        [
            rng.uniform(-np.pi, np.pi, 16),
            rng.uniform(-1.4, 1.4, 16),
            rng.uniform(-np.pi, np.pi, 16),
        ],
        axis=-1,
    ).astype(np.float32)
    q = rot.euler_xyz_to_quaternion(a)
    a2 = np.asarray(rot.quaternion_to_euler_xyz(q))
    np.testing.assert_allclose(a, a2, atol=1e-4)


def test_quaternion_rotate_vector_matches_matrix(rng):
    a = random_angles(rng, (8,))
    v = rng.uniform(-2, 2, size=(8, 3)).astype(np.float32)
    q = rot.euler_xyz_to_quaternion(a)
    m = np.asarray(rot.euler_xyz_to_matrix(a))
    rotated_q = np.asarray(rot.quaternion_rotate_vector(q, v))
    rotated_m = np.einsum("bij,bj->bi", m, v)
    np.testing.assert_allclose(rotated_q, rotated_m, atol=1e-5)


def test_quaternion_invert_multiply(rng):
    a = random_angles(rng, (8,))
    q = rot.euler_xyz_to_quaternion(a)
    qi = rot.quaternion_invert(q)
    prod = np.asarray(rot.quaternion_multiply(q, qi))
    expected = np.tile(np.array([0, 0, 0, 1.0], np.float32), (8, 1))
    np.testing.assert_allclose(prod, expected, atol=1e-5)
