"""Rotation math: Euler-XYZ matrices and quaternion conversions.

Conventions match the reference device math exactly (SURVEY.md C8/C9):

  * ``euler_xyz_to_matrix(a)`` builds ``Rx(a_x) @ Ry(a_y) @ Rz(a_z)``
    — the composition order of the reference's ``rotateEuler``
    (reference matrix_operations.cuh:166-180 multiplies the running
    matrix by Rx, then Ry, then Rz on the right), which also matches
    the host glm path (reference Node.h:6-12).
  * Quaternions are ``(x, y, z, w)`` like the reference's ``float4``.
  * ``matrix_to_quaternion`` implements the same 4-branch
    Shepperd-style extraction as reference matrix_operations.cuh:78-112
    but with branch-free ``jnp.where`` selection (no divergent control
    flow).

All functions broadcast over arbitrary leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp


def euler_xyz_to_matrix(angles: jnp.ndarray) -> jnp.ndarray:
    """Euler XYZ angles ``(..., 3)`` -> rotation matrices ``(..., 3, 3)``.

    Closed form of ``Rx @ Ry @ Rz`` (one trig evaluation per axis, no
    intermediate matmuls — the reference performs three sequential 4x4
    multiplies per node; we emit nine fused elementwise expressions).
    """
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = jnp.cos(x), jnp.sin(x)
    cy, sy = jnp.cos(y), jnp.sin(y)
    cz, sz = jnp.cos(z), jnp.sin(z)
    r00 = cy * cz
    r01 = -cy * sz
    r02 = sy
    r10 = cx * sz + sx * sy * cz
    r11 = cx * cz - sx * sy * sz
    r12 = -sx * cy
    r20 = sx * sz - cx * sy * cz
    r21 = sx * cz + cx * sy * sz
    r22 = cx * cy
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def quaternion_to_matrix(quat: jnp.ndarray) -> jnp.ndarray:
    """Quaternion ``(..., 4)`` (x, y, z, w) -> rotation matrix ``(..., 3, 3)``.

    Same element formulas as reference matrix_operations.cuh:51-76.
    """
    qx, qy, qz, qw = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    r00 = 1 - 2 * qy * qy - 2 * qz * qz
    r01 = 2 * qx * qy - 2 * qz * qw
    r02 = 2 * qx * qz + 2 * qy * qw
    r10 = 2 * qx * qy + 2 * qz * qw
    r11 = 1 - 2 * qx * qx - 2 * qz * qz
    r12 = 2 * qy * qz - 2 * qx * qw
    r20 = 2 * qx * qz - 2 * qy * qw
    r21 = 2 * qy * qz + 2 * qx * qw
    r22 = 1 - 2 * qx * qx - 2 * qy * qy
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quaternion(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix ``(..., 3, 3)`` -> quaternion ``(..., 4)`` (x, y, z, w).

    Branch-free equivalent of the reference's trace-based 4-case
    extraction (reference matrix_operations.cuh:78-112): all four
    candidate quaternions are computed and the numerically-stable one
    is selected with ``jnp.where`` masks.
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    # Guard each sqrt argument: only the selected branch's value is
    # used, but all are computed, so clamp to keep NaNs out.
    def _safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, 1e-12))

    s0 = _safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], axis=-1)

    s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], axis=-1)

    s2 = _safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], axis=-1)

    s3 = _safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], axis=-1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    return jnp.where(use0, q0, jnp.where(use1, q1, jnp.where(use2, q2, q3)))


def euler_xyz_to_quaternion(angles: jnp.ndarray) -> jnp.ndarray:
    """Euler XYZ ``(..., 3)`` -> quaternion ``(..., 4)`` (x, y, z, w).

    Composition q = qx * qy * qz, consistent with
    ``euler_xyz_to_matrix`` (API parity with reference
    quaternion_operations.cuh:5-38, which is latent in the reference's
    active fitness path).
    """
    half = angles * 0.5
    cx, sx = jnp.cos(half[..., 0]), jnp.sin(half[..., 0])
    cy, sy = jnp.cos(half[..., 1]), jnp.sin(half[..., 1])
    cz, sz = jnp.cos(half[..., 2]), jnp.sin(half[..., 2])
    # qx*qy*qz with q = (x, y, z, w)
    qx = sx * cy * cz + cx * sy * sz
    qy = cx * sy * cz - sx * cy * sz
    qz = cx * cy * sz + sx * sy * cz
    qw = cx * cy * cz - sx * sy * sz
    return jnp.stack([qx, qy, qz, qw], axis=-1)


def quaternion_to_euler_xyz(quat: jnp.ndarray) -> jnp.ndarray:
    """Quaternion ``(..., 4)`` -> Euler XYZ ``(..., 3)``.

    Inverse of ``euler_xyz_to_quaternion`` (extracts angles from the
    equivalent rotation matrix; gimbal-safe via clamped asin).
    """
    rot = quaternion_to_matrix(quat)
    # R = Rx@Ry@Rz with r02 = sin(y); r01/r00 = -tan(z); r12/r22 = -tan(x)
    y = jnp.arcsin(jnp.clip(rot[..., 0, 2], -1.0, 1.0))
    x = jnp.arctan2(-rot[..., 1, 2], rot[..., 2, 2])
    z = jnp.arctan2(-rot[..., 0, 1], rot[..., 0, 0])
    return jnp.stack([x, y, z], axis=-1)


def quaternion_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of quaternions stored as (x, y, z, w)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quaternion_invert(quat: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a (not necessarily unit) quaternion (x, y, z, w).

    Same semantics as the reference's ``quatInvert2``
    (reference kernel.cu GJK support path): conjugate / |q|^2.
    """
    norm_sq = jnp.sum(quat * quat, axis=-1, keepdims=True)
    conj = quat * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=quat.dtype)
    return conj / jnp.maximum(norm_sq, 1e-30)


def quaternion_rotate_vector(quat: jnp.ndarray, vec: jnp.ndarray) -> jnp.ndarray:
    """Rotate ``vec`` (..., 3) by unit quaternion ``quat`` (..., 4)."""
    qv = quat[..., :3]
    qw = quat[..., 3:4]
    t = 2.0 * jnp.cross(qv, vec)
    return vec + qw * t + jnp.cross(qv, t)
