"""Analytic geometric Jacobian of effector pose w.r.t. joint angles.

The classic robotics closed form, specialized to this FK convention
(reference kernel.cu:31-62: node k's frame = parent @ Rx@Ry@Rz @ T_x):

  * node k's three Euler rotations pivot at the PARENT's world
    position ``p_parent(k)`` and rotate everything downstream;
  * their world rotation axes are
      - theta_x: column 0 of ``R_parent``
      - theta_y: ``R_parent @ Rx @ e_y`` = cx*col1(Rp) + sx*col2(Rp)
      - theta_z: column 2 of ``R_k``        (since ``Rz @ e_z = e_z``)
  * position rows:    ``J = axis x (p_eff - p_parent(k))`` (zero unless
    node k is on the root->effector path);
  * orientation rows: ``J = axis`` (same ancestry mask), exact at the
    world-frame rotation-vector residual's zero.

One FK pass plus cross products — ~D times cheaper than ``jacfwd``'s
D-tangent FK, and every op is elementwise over the swarm axis (no
tiny batched matmuls). ``jacfwd`` through
:func:`ikpso.ops.fk.fk` remains the oracle in tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from ikpso.models.chain import ChainSpec
from ikpso.ops import fk as fk_ops


def ancestry_mask(spec: ChainSpec) -> np.ndarray:
    """(E, N-1) float mask: 1 where node k is on the path to effector e.

    Static (trace-time) — topology lives in ``spec.parent``
    (the reference's ``NodeCUDA.parentIndex``, Particle.h:28).
    """
    e_count = spec.num_effectors
    mask = np.zeros((e_count, spec.num_nodes - 1), np.float32)
    for ei, node in enumerate(spec.effector_idx):
        k = node
        while k > 0:
            mask[ei, k - 1] = 1.0
            k = spec.parent[k]
    return mask


def fk_with_jacobian(
    spec: ChainSpec,
    pose: jnp.ndarray,
    origin: jnp.ndarray,
    *,
    orientation: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """FK plus the effector Jacobian in one pass.

    Args:
      pose: ``(..., N, 3)`` per-node Euler angles (row 0 = origin).
      origin: ``(..., 3)`` origin translation.

    Returns:
      ``(eff_pos, eff_rot, jac)`` with shapes ``(..., E, 3)``,
      ``(..., E, 3, 3)`` and ``(..., E*3, D)`` — position rows only —
      or ``(..., E*6, D)`` with ``orientation=True`` (position rows
      first, then the three rotation-vector rows per effector, matching
      the residual layout of ``pso.polish``).
    """
    eff = list(spec.effector_idx)
    parents = list(spec.parent[1:])
    pos, rot = fk_ops.fk(spec, pose, origin)

    rp = rot[..., parents, :, :]  # (..., K, 3, 3) parent world rotations
    cx = jnp.cos(pose[..., 1:, 0])
    sx = jnp.sin(pose[..., 1:, 0])
    ax = rp[..., :, :, 0]
    ay = cx[..., None] * rp[..., :, :, 1] + sx[..., None] * rp[..., :, :, 2]
    az = rot[..., 1:, :, 2]
    axes = jnp.stack([ax, ay, az], axis=-2)  # (..., K, 3 axes, 3)

    pivot = pos[..., parents, :]  # (..., K, 3) joint pivots
    pe = pos[..., eff, :]  # (..., E, 3)
    mask = jnp.asarray(ancestry_mask(spec))  # (E, K) static

    # J_pos[e, k, a, :] = axis_(k,a) x (p_e - pivot_k), masked by path.
    diff = pe[..., :, None, None, :] - pivot[..., None, :, None, :]
    jpos = jnp.cross(axes[..., None, :, :, :], diff)
    jpos = jpos * mask[..., :, :, None, None]  # (..., E, K, A, 3)

    # Flatten to residual layout: rows = (e, xyz), cols = (k, axis).
    def rows(j):
        j = jnp.moveaxis(j, -1, -3)  # (..., E, 3comp, K, A)
        shape = j.shape[:-4] + (j.shape[-4] * 3, spec.dof)
        return j.reshape(shape)

    jac = rows(jpos)
    if orientation:
        jrot = jnp.broadcast_to(
            axes[..., None, :, :, :], jpos.shape
        ) * mask[..., :, :, None, None]
        jac = jnp.concatenate([jac, rows(jrot)], axis=-2)
    return pe, rot[..., eff, :, :], jac
