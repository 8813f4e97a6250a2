"""PSO fitness: effector error + locality regularizers + collision rejection.

Behavioral spec from the reference's ``calculateDistance``
(reference kernel.cu:64-151), for a candidate joint-angle vector:

  cost = sum_e  w_e * |p_e - target_e|^2                 (effectors)
       + (distance_weight / J) * sum_k |p_k - anchor_p_k|^2
       + (angle_weight / J)    * sum_k |theta_k - anchor_theta_k|^2
  cost = FLT_MAX  if any node/link box hits a scene obstacle

with J = number of non-root nodes (DOF/3), squared distances
throughout, and the anchor being the *current* pose (re-marshaled every
frame — the anti-jitter locality design, SURVEY.md §2.3).

Two deliberate deviations, both flagged in SURVEY.md §2.4:
  * The node-position locality term compares node k against node k's
    own current position (the reference's ``CopyPositions`` off-by-one
    compares against node k-2 and reads out of bounds; harmless there
    only because distance_weight == 0).
  * ``orientation_weight`` adds a real effector-orientation cost (the
    reference marshals ``targetRotation`` but never uses it,
    Node.h:445-447).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso.ops import fk as fk_ops
from ikpso.ops.rotations import euler_xyz_to_matrix

# The reference returns FLT_MAX for colliding poses (kernel.cu:129,134).
# A numpy scalar (not a jnp array) so kernels can close over it.
import numpy as _np

COLLISION_PENALTY = _np.float32(3.4028235e38)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FitnessConfig:
    """Cost weights (reference FitnessConfig, Particle.h:54-67).

    Defaults are the values the reference actually runs with
    (Main.cpp:131: angleWeight=3.0, distanceWeight=0.0), not the
    struct defaults — SURVEY.md §2.4.7.

    ``error_threshold`` is carried for schema parity; like the
    reference, the solver itself never reads it (the convergence check
    lives in the experiment harness).
    """

    angle_weight: float = 3.0
    distance_weight: float = 0.0
    orientation_weight: float = 0.0
    error_threshold: float = 0.1
    gizmo_size: float = dataclasses.field(default=0.2, metadata=dict(static=True))
    # "sat" (closed-form, exact — the default) or "gjk" (the
    # reference's iterative algorithm, masked fixed-iteration form;
    # ikpso.ops.gjk). Both reject with COLLISION_PENALTY.
    # NOTE: the megakernel (pso.fused) fuses only the closed-form
    # backend and raises on "gjk" — a 50-round support-point loop per
    # (node x link x obstacle) pair has no place in a register-resident
    # kernel; the jnp path runs either.
    collision_backend: str = dataclasses.field(default="sat", metadata=dict(static=True))
    # "box" — the reference's cube-gizmo + link-box construction
    # (kernel.cu:104-136). "capsule" — node spheres + link capsules
    # (rounded, rotation-free, exact closed form; the more physical
    # link model). See ops.collision.get_chain_collider.
    collision_shape: str = dataclasses.field(default="box", metadata=dict(static=True))
    # Megakernel trig: "poly" (range-reduced minimax polynomials; fit
    # err 3.1e-7 sin / 3.6e-8 cos in exact arithmetic, 1.2e-6 / 5.3e-7
    # end-to-end in f32 over [-4pi, 4pi] where the one-step range
    # reduction's round-off dominates) or "exact" (the stock sin/cos
    # lowering). "poly" is the default: on an H100 (700 W) it ran the
    # headline PSO stage (S=1,048,576) in 39.6 ms against 84.9 ms for
    # the stock lowering (PERF.md). Kernel path only; the jnp path
    # always uses stock trig and is the accuracy oracle.
    trig_impl: str = dataclasses.field(default="poly", metadata=dict(static=True))
    # FK evaluation strategy for the jnp path: "unrolled" (the
    # straight-line tree walk, works for any topology) or "scan"
    # (log-depth lax.associative_scan over affine composition — serial
    # chains only; the sequence-parallel analog for very deep chains,
    # SURVEY.md §5 long-context row). The megakernel always unrolls.
    fk_impl: str = dataclasses.field(default="unrolled", metadata=dict(static=True))


def fitness(
    spec: ChainSpec,
    angles: jnp.ndarray,
    problem: IKProblem,
    config: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    anchor_angles: Optional[jnp.ndarray] = None,
    anchor_positions: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Evaluate the PSO cost for candidate joint angles.

    Args:
      spec: chain topology.
      angles: ``(..., D)`` candidate joint angles. Leading dims may
        include swarm and particle axes; they must broadcast against
        the problem's batch shape extended with a particle axis.
      problem: targets / current pose / origin. For a batched problem
        of shape ``(S,)``, pass angles shaped ``(S, P, D)``.
      config: cost weights.
      obstacles: optional scene boxes; poses intersecting them get
        ``COLLISION_PENALTY``.
      anchor_angles / anchor_positions: precomputed locality anchors
        (flat current-pose angles ``(..., D)``; current-pose node world
        positions ``(..., N, 3)``). Computed from the problem when
        omitted; the solver hoists them out of its iteration loop, the
        same way the reference computes host-FK positions once per
        frame (Main.cpp:223).

    Returns:
      ``(...,)`` fitness, smaller is better.
    """
    n = spec.num_nodes
    num_joints = n - 1
    is_batched_particles = angles.ndim > problem.pose.ndim - 1

    if anchor_angles is None:
        anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
    if anchor_positions is None:
        anchor_positions = fk_ops.fk_points(spec, problem.pose, problem.origin)
    if is_batched_particles:
        # Insert the particle axis into per-swarm anchors/targets.
        anchor_angles = anchor_angles[..., None, :]
        anchor_positions = anchor_positions[..., None, :, :]

    root_rot = problem.pose[..., 0, :]
    origin = problem.origin
    targets = problem.targets
    target_rot = problem.target_rot
    if is_batched_particles:
        root_rot = root_rot[..., None, :]
        origin = origin[..., None, :]
        targets = targets[..., None, :, :]
        if target_rot is not None:
            target_rot = target_rot[..., None, :, :]

    pose = fk_ops.angles_to_pose(spec, root_rot, angles)
    if config.fk_impl == "scan":
        positions, rotations = fk_ops.fk_serial_scan(spec, pose, origin)
    elif config.fk_impl == "unrolled":
        positions, rotations = fk_ops.fk(spec, pose, origin)
    else:
        raise ValueError(
            f"unknown fk_impl {config.fk_impl!r}; expected 'unrolled' or 'scan'"
        )

    # Angular locality: sum over joints of squared Euler deltas
    # (reference kernel.cu:78-84).
    d_angles = angles - anchor_angles
    rotation_difference = jnp.sum(d_angles * d_angles, axis=-1)

    # Node-position locality with the *intended* indexing (§2.4.1).
    d_pos = positions[..., 1:, :] - anchor_positions[..., 1:, :]
    position_difference = jnp.sum(d_pos * d_pos, axis=(-2, -1))

    # Weighted squared effector->target distances (kernel.cu:139-146).
    eff = list(spec.effector_idx)
    eff_pos = positions[..., eff, :]
    d_eff = eff_pos - targets
    eff_w = spec.effector_weight[jnp.array(eff)]
    cost = jnp.sum(eff_w * jnp.sum(d_eff * d_eff, axis=-1), axis=-1)

    if target_rot is not None:
        # Squared Frobenius distance between effector world rotation and
        # target rotation — a smooth orientation cost the reference
        # lacks (its targetRotation is marshaled but unused).
        eff_rot = rotations[..., eff, :, :]
        tgt_rot = euler_xyz_to_matrix(target_rot)
        d_rot = eff_rot - tgt_rot
        orient = jnp.sum(eff_w * jnp.sum(d_rot * d_rot, axis=(-2, -1)), axis=-1)
        cost = cost + config.orientation_weight * orient

    cost = (
        cost
        + (config.distance_weight / num_joints) * position_difference
        + (config.angle_weight / num_joints) * rotation_difference
    )

    if obstacles is not None and obstacles.count > 0:
        from ikpso.ops.collision import get_chain_collider

        _collides = get_chain_collider(
            config.collision_backend, config.collision_shape
        )
        parent_pos = positions[..., list(spec.parent[1:]), :]
        hit = _collides(
            positions[..., 1:, :],
            rotations[..., 1:, :, :],
            parent_pos,
            spec.length[1:],
            obstacles.center,
            obstacles.half_extent,
            obstacles.rot,
            gizmo_size=config.gizmo_size,
        )
        cost = jnp.where(hit, COLLISION_PENALTY, cost)

    return cost


def true_effector_error(
    spec: ChainSpec, pose: jnp.ndarray, problem: IKProblem
) -> jnp.ndarray:
    """Host-oracle convergence metric: sum of *Euclidean* distances.

    This is the reference's ground truth ``checkDistance``
    (Main.cpp:290-298 / Node.h:421-429) — deliberately a different
    space than the squared-distance fitness (SURVEY.md §2.4.3).
    """
    positions = fk_ops.fk_points(spec, pose, problem.origin)
    eff_pos = positions[..., list(spec.effector_idx), :]
    d = eff_pos - problem.targets
    return jnp.sum(jnp.sqrt(jnp.sum(d * d, axis=-1)), axis=-1)
