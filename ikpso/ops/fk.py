"""Forward kinematics for parent-indexed kinematic trees.

Semantics match the reference device FK exactly
(reference kernel.cu:31-62, host mirror Node.h:92-102):

  * root (node 0):   ``M_0 = T(origin) @ Rxyz(pose_0)``
  * child (node k):  ``M_k = M_parent @ Rxyz(pose_k) @ T_x(length_k)``
  * Euler order:     rotate X, then Y, then Z
    (reference matrix_operations.cuh:166-180).

Instead of 4x4 homogeneous matrices we carry the rotation block
``R (..., 3, 3)`` and translation ``p (..., 3)`` directly — a 4x4
product against ``T_x(L)`` reduces to ``p_k = p_parent + L * R_k[:, 0]``
(first column of the world rotation), saving ~4x the FLOPs of the
reference's five naive 4x4 matmuls per node (SURVEY.md §3.4).

Because ``ChainSpec.parent`` is trace-time static, the tree walk
unrolls into straight-line XLA: no dynamic gathers, no host control
flow, fully fusable. For very long *serial* chains there is a
log-depth ``fk_serial_scan`` built on ``lax.associative_scan`` over
affine composition.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ikpso.models.chain import ChainSpec
from ikpso.ops.rotations import euler_xyz_to_matrix


def fk(
    spec: ChainSpec, pose: jnp.ndarray, origin: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """World placements of every node.

    Args:
      spec: chain topology.
      pose: ``(..., N, 3)`` per-node Euler-XYZ rotations (row 0 = origin
        rotation).
      origin: ``(..., 3)`` world translation of the origin node.

    Returns:
      ``(positions, rotations)`` with shapes ``(..., N, 3)`` and
      ``(..., N, 3, 3)``.
    """
    n = spec.num_nodes
    local = euler_xyz_to_matrix(pose)  # (..., N, 3, 3) — one fused trig pass
    rots = [local[..., 0, :, :]]
    poss = [jnp.broadcast_to(origin, local.shape[:-3] + (3,))]
    lengths = spec.length
    for k in range(1, n):
        p = spec.parent[k]
        # precision="highest": at default precision even a 3x3 f32
        # matmul may run at reduced precision (TF32 on a GPU's tensor
        # cores), which injects ~1e-3 absolute FK error — fatal for
        # sub-mm IK. The megakernel composes elementwise in exact f32.
        rk = jnp.matmul(rots[p], local[..., k, :, :], precision="highest")
        # T_x(L): offset L along the node's world X axis (column 0).
        pk = poss[p] + lengths[k] * rk[..., :, 0]
        rots.append(rk)
        poss.append(pk)
    return jnp.stack(poss, axis=-2), jnp.stack(rots, axis=-3)


def fk_points(spec: ChainSpec, pose: jnp.ndarray, origin: jnp.ndarray) -> jnp.ndarray:
    """World positions only, ``(..., N, 3)``."""
    return fk(spec, pose, origin)[0]


def effector_positions(
    spec: ChainSpec, pose: jnp.ndarray, origin: jnp.ndarray
) -> jnp.ndarray:
    """World positions of the effector nodes, ``(..., E, 3)``."""
    pos = fk_points(spec, pose, origin)
    return pos[..., list(spec.effector_idx), :]


def angles_to_pose(spec: ChainSpec, root_rotation: jnp.ndarray, angles: jnp.ndarray) -> jnp.ndarray:
    """Assemble a full ``(..., N, 3)`` pose from a flat DOF vector.

    ``angles`` is ``(..., D)`` with ``D = (N-1)*3``, laid out node-major
    (node k occupies angles[3(k-1):3k]) — the reference's
    ``Coordinates`` layout (reference Particle.h:42-45, Node.h:175-194).
    The origin row is taken from ``root_rotation`` ``(..., 3)``; the
    origin is not a PSO degree of freedom (reference kernel.cu:44-46).
    """
    n = spec.num_nodes
    joints = angles.reshape(angles.shape[:-1] + (n - 1, 3))
    root = jnp.broadcast_to(root_rotation[..., None, :], joints.shape[:-2] + (1, 3))
    return jnp.concatenate([root, joints], axis=-2)


def pose_to_angles(spec: ChainSpec, pose: jnp.ndarray) -> jnp.ndarray:
    """Flatten a ``(..., N, 3)`` pose to the ``(..., D)`` DOF vector."""
    del spec
    joints = pose[..., 1:, :]
    return joints.reshape(joints.shape[:-2] + (-1,))


def _affine_compose(a, b):
    """(Ra, ta) . (Rb, tb) = (Ra@Rb, ta + Ra@tb) — associative."""
    ra, ta = a
    rb, tb = b
    return (
        jnp.matmul(ra, rb, precision="highest"),
        ta + jnp.einsum("...ij,...j->...i", ra, tb, precision="highest"),
    )


def fk_serial_scan(
    spec: ChainSpec, pose: jnp.ndarray, origin: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Log-depth FK for a *serial* chain via ``lax.associative_scan``.

    FK along a chain is a prefix product of affine transforms; the
    associative scan evaluates all N prefixes in O(log N) depth — the
    long-kinematic-chain analog of sequence parallelism (SURVEY.md §5,
    "long-context" row). Requires ``parent == (k-1)`` for every node.
    """
    if any(spec.parent[k] != k - 1 for k in range(1, spec.num_nodes)):
        raise ValueError("fk_serial_scan requires a serial chain")
    local_r = euler_xyz_to_matrix(pose)  # (..., N, 3, 3)
    # Local affine of node k: (R_k, R_k @ (L_k, 0, 0)) = (R_k, L_k * col0).
    local_t = spec.length[..., :, None] * local_r[..., :, :, 0]
    local_t = local_t.at[..., 0, :].set(0.0)  # root carries no link offset
    rot_w, t_w = jax.lax.associative_scan(_affine_compose, (local_r, local_t), axis=-3)
    return t_w + origin[..., None, :], rot_w
