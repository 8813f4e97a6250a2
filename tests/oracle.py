"""Independent numpy oracle mirroring the reference's 4x4 matrix math.

This is a from-formulas reimplementation of the reference's FK and
fitness semantics (reference matrix_operations.cuh:123-180,
kernel.cu:31-151) used ONLY as a test oracle: row-major 4x4 matrices
with translation in cells (0,3),(1,3),(2,3), sequential Rx/Ry/Rz
multiplies, full homogeneous products. The production code
(ikpso.ops.fk) must agree with it to float tolerance.
"""

from __future__ import annotations

import numpy as np


def mat_identity():
    return np.eye(4, dtype=np.float64)


def mat_translate(m, t):
    tm = np.eye(4)
    tm[0, 3], tm[1, 3], tm[2, 3] = t
    return m @ tm


def mat_rot_x(m, a):
    rm = np.eye(4)
    rm[1, 1], rm[1, 2] = np.cos(a), -np.sin(a)
    rm[2, 1], rm[2, 2] = np.sin(a), np.cos(a)
    return m @ rm


def mat_rot_y(m, a):
    rm = np.eye(4)
    rm[0, 0], rm[0, 2] = np.cos(a), np.sin(a)
    rm[2, 0], rm[2, 2] = -np.sin(a), np.cos(a)
    return m @ rm


def mat_rot_z(m, a):
    rm = np.eye(4)
    rm[0, 0], rm[0, 1] = np.cos(a), -np.sin(a)
    rm[1, 0], rm[1, 1] = np.sin(a), np.cos(a)
    return m @ rm


def mat_rotate_euler(m, angles):
    m = mat_rot_x(m, angles[0])
    m = mat_rot_y(m, angles[1])
    return mat_rot_z(m, angles[2])


def fk_oracle(parent, lengths, pose, origin):
    """Node world 4x4 matrices per the reference FK (kernel.cu:31-62)."""
    n = len(parent)
    mats = [None] * n
    root = mat_identity()
    root = mat_translate(root, origin)
    root = mat_rotate_euler(root, pose[0])
    mats[0] = root
    for k in range(1, n):
        local = mat_identity()
        local = mat_rotate_euler(local, pose[k])
        local = mat_translate(local, (lengths[k], 0.0, 0.0))
        mats[k] = mats[parent[k]] @ local
    return mats


def fk_positions_oracle(parent, lengths, pose, origin):
    mats = fk_oracle(parent, lengths, pose, origin)
    return np.stack([(m @ np.array([0.0, 0.0, 0.0, 1.0]))[:3] for m in mats])


def fitness_oracle(
    parent,
    lengths,
    pose_anchor,
    origin,
    angles,
    effector_idx,
    effector_weight,
    targets,
    angle_weight=3.0,
    distance_weight=0.0,
):
    """Scalar fitness per the reference calculateDistance (kernel.cu:64-151),
    with the *intended* position-locality indexing (SURVEY.md §2.4.1)."""
    n = len(parent)
    pose = np.array(pose_anchor, dtype=np.float64)
    pose[1:] = np.asarray(angles, np.float64).reshape(n - 1, 3)
    pos = fk_positions_oracle(parent, lengths, pose, origin)
    anchor_pos = fk_positions_oracle(parent, lengths, pose_anchor, origin)

    rotation_difference = float(
        np.sum((pose[1:] - np.asarray(pose_anchor)[1:]) ** 2)
    )
    position_difference = float(np.sum((pos[1:] - anchor_pos[1:]) ** 2))
    distance = 0.0
    for w, e, t in zip(effector_weight, effector_idx, targets):
        distance += w * float(np.sum((pos[e] - np.asarray(t)) ** 2))
    j = n - 1
    return (
        distance
        + distance_weight / j * position_difference
        + angle_weight / j * rotation_difference
    )
