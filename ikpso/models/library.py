"""Prebuilt kinematic models: the reference arm and benchmark configs.

Where the reference hardcodes its arm in ``main()``
(reference Main.cpp:76-117) and requires recompilation to change DOF
(ik_constants.h), these are runtime builders returning
``(ChainSpec, IKProblem)`` pairs. The extra configs are the BASELINE.md
benchmark set: 3-DOF planar (CPU-runnable), 6-DOF
position+orientation, 7-DOF redundant, and dual-arm 14-DOF.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ikpso.models.chain import ChainSpec, IKProblem, make_chain_spec

TWO_PI = 2.0 * math.pi
PI = math.pi

# The reference's canonical elbow bend (Main.cpp:81-85).
_REF_BEND = 1.57


def _problem(pose, targets, origin=(0.0, 0.0, 0.0), target_rot=None) -> IKProblem:
    return IKProblem(
        pose=jnp.asarray(pose, jnp.float32),
        origin=jnp.asarray(origin, jnp.float32),
        targets=jnp.asarray(targets, jnp.float32),
        target_rot=None if target_rot is None else jnp.asarray(target_rot, jnp.float32),
    )


def reference_arm() -> Tuple[ChainSpec, IKProblem]:
    """The reference's 21-DOF experiment arm (Main.cpp:76-117).

    Origin at (0,0,0) -> 4 serial elbow links (length 1, initial
    rotation (0, 1.57, 0)) -> 3 effector children of the last elbow
    (length 1, weight 1.0, initial rotations (0,1.57,0) / (0,0,1.57) /
    (0,0,1.57)). All joint limits are [0, 2*pi] (Main.cpp passes
    min=vec3(0), max=vec3(2*PI)). Targets: (0.5,1,-2), (-0.5,1,-2),
    (0,0,-2) (Main.cpp:86-88).
    """
    parent = [-1, 0, 1, 2, 3, 4, 4, 4]
    spec = make_chain_spec(
        parent=parent,
        length=[0.0] + [1.0] * 7,
        min_rotation=np.zeros((8, 3), np.float32),
        max_rotation=np.full((8, 3), TWO_PI, np.float32),
        effector_idx=[5, 6, 7],
        effector_weight=[1.0, 1.0, 1.0],
    )
    pose = np.zeros((8, 3), np.float32)
    for k in range(1, 6):  # elbows 1-4 and first wrist
        pose[k] = (0.0, _REF_BEND, 0.0)
    pose[6] = (0.0, 0.0, _REF_BEND)
    pose[7] = (0.0, 0.0, _REF_BEND)
    targets = [(0.5, 1.0, -2.0), (-0.5, 1.0, -2.0), (0.0, 0.0, -2.0)]
    return spec, _problem(pose, targets)


def reference_reset_targets() -> jnp.ndarray:
    """Targets after the experiment harness reset (Main.cpp:330-337)."""
    return jnp.asarray(
        [(0.75, 1.0, -2.5), (-0.75, 1.0, -2.5), (0.0, 0.0, -2.5)], jnp.float32
    )


def serial_chain(
    num_links: int,
    link_length: float = 1.0,
    free_axes: Sequence[int] = (0, 1, 2),
    limit: float = PI,
    effector_weight: float = 1.0,
    target=None,
    initial_bend: float = 0.0,
) -> Tuple[ChainSpec, IKProblem]:
    """A generic serial chain; the last node is the single effector.

    ``free_axes`` selects which Euler axes of every joint are
    articulated; the others are clamped to 0 via degenerate limits
    (the joint-limit clamp then freezes them, reference
    kernel.cu:183-185 semantics).
    """
    n = num_links + 1
    min_rot = np.zeros((n, 3), np.float32)
    max_rot = np.zeros((n, 3), np.float32)
    for ax in free_axes:
        min_rot[1:, ax] = -limit
        max_rot[1:, ax] = limit
    spec = make_chain_spec(
        parent=[-1] + list(range(num_links)),
        length=[0.0] + [link_length] * num_links,
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=[n - 1],
        effector_weight=[effector_weight],
    )
    pose = np.zeros((n, 3), np.float32)
    if initial_bend:
        ax = free_axes[0]
        pose[1:, ax] = initial_bend
    if target is None:
        target = (num_links * link_length * 0.6, num_links * link_length * 0.3, 0.0)
    return spec, _problem(pose, [target])


def planar_3dof(target=(1.5, 1.5, 0.0)) -> Tuple[ChainSpec, IKProblem]:
    """BASELINE config 1: 3-DOF planar arm (rotation about Z only)."""
    return serial_chain(3, link_length=1.0, free_axes=(2,), target=target)


def arm_6dof(
    target=(1.2, 0.8, 0.5), target_rot=(0.0, 0.3, 0.2)
) -> Tuple[ChainSpec, IKProblem]:
    """BASELINE config 2: 6-DOF arm with position+orientation cost."""
    spec, problem = serial_chain(2, link_length=1.0, free_axes=(0, 1, 2), target=target)
    return spec, problem.replace(
        target_rot=jnp.asarray([target_rot], jnp.float32)
    )


def arm_7dof(target=(1.0, 1.2, -0.8)) -> Tuple[ChainSpec, IKProblem]:
    """BASELINE config 3: 7-DOF redundant arm.

    Three links: two spherical (3 axes) joints plus one revolute
    (Z-only) wrist = 7 articulated DOF.
    """
    n = 4
    min_rot = np.zeros((n, 3), np.float32)
    max_rot = np.zeros((n, 3), np.float32)
    min_rot[1:3, :] = -PI
    max_rot[1:3, :] = PI
    min_rot[3, 2] = -PI
    max_rot[3, 2] = PI
    spec = make_chain_spec(
        parent=[-1, 0, 1, 2],
        length=[0.0, 1.0, 1.0, 0.5],
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=[3],
    )
    pose = np.zeros((n, 3), np.float32)
    return spec, _problem(pose, [target])


def snake(num_links: int) -> Tuple[ChainSpec, IKProblem]:
    """Long-chain family: ``num_links`` spherical links (3 DOF each).

    The reference's stated goal is "arbitrarily large kinematic
    chains" (reference Documentation/Iteration_1/Raport.tex:36), but
    its DOF is a compile-time constant (reference ik_constants.h:3) —
    changing it means recompiling. Here topology is runtime data: any
    depth runs through the same solvers (``snake:<links>`` in configs
    and bench), and deep chains are the natural consumer of the
    log-depth ``ops.fk.fk_serial_scan`` path.
    +-pi/2 per-axis limits keep the redundant chain well-conditioned;
    a small initial bend avoids the straight-line singular start; the
    target sits at half reach so every depth is solvable.
    """
    reach = float(num_links)
    return serial_chain(
        num_links, link_length=1.0, free_axes=(0, 1, 2),
        limit=PI / 2,
        target=(0.4 * reach, 0.3 * reach, 0.2 * reach),
        initial_bend=0.1,
    )


def snake_30dof() -> Tuple[ChainSpec, IKProblem]:
    """10-link instance of :func:`snake` (30 articulated DOF)."""
    return snake(10)


def dual_arm_14dof(
    target_a=(1.0, 1.0, 0.5), target_b=(-1.0, 1.0, 0.5)
) -> Tuple[ChainSpec, IKProblem]:
    """BASELINE config 4: two 7-DOF arms branching from one origin.

    Demonstrates tree topology (the reference's 3-effector branch,
    Node.h parentIndex flat form) at a larger DOF count.
    """
    # Nodes: 0 origin; 1,2,3 arm A; 4,5,6 arm B.
    parent = [-1, 0, 1, 2, 0, 4, 5]
    n = 7
    min_rot = np.zeros((n, 3), np.float32)
    max_rot = np.zeros((n, 3), np.float32)
    for base in (1, 4):
        min_rot[base : base + 2, :] = -PI
        max_rot[base : base + 2, :] = PI
        min_rot[base + 2, 2] = -PI
        max_rot[base + 2, 2] = PI
    spec = make_chain_spec(
        parent=parent,
        length=[0.0, 1.0, 1.0, 0.5, 1.0, 1.0, 0.5],
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=[3, 6],
        effector_weight=[1.0, 1.0],
    )
    pose = np.zeros((n, 3), np.float32)
    return spec, _problem(pose, [target_a, target_b])


def humanoid_45dof() -> Tuple[ChainSpec, IKProblem]:
    """5-effector humanoid tree: 16 nodes, 45 DOF, two branch points.

    pelvis(origin) -> spine -> chest, with the head and both arms
    branching at the chest and both legs branching at the pelvis —
    the richest tree topology in the zoo. The reference demonstrates
    trees via 3 effector children of ONE node (reference
    Main.cpp:100-117, flat parentIndex form Node.h:232-267); this
    model exercises multi-LEVEL branching (two interior nodes with 3
    children each) and five weighted effectors (head, hands, feet)
    through the same parent-indexed FK.

    Targets are the FK effector positions of a hand-picked bent pose,
    so all five are simultaneously reachable by construction; the
    solve starts from the straight canonical pose.
    """
    from ikpso.ops.fk import fk_points

    #           0   1  2  3  4  5  6  7  8  9  10  11  12  13  14  15
    # pelvis, spine, chest, head, Lsho, Lelb, Lhand, Rsho, Relb,
    # Rhand, Lhip, Lknee, Lfoot, Rhip, Rknee, Rfoot
    parent = [-1, 0, 1, 2, 2, 4, 5, 2, 7, 8, 0, 10, 11, 0, 13, 14]
    length = [0.0, 0.5, 0.5, 0.3,
              0.4, 0.5, 0.5,
              0.4, 0.5, 0.5,
              0.3, 0.6, 0.6,
              0.3, 0.6, 0.6]
    n = len(parent)
    limit = 2.0
    min_rot = np.full((n, 3), -limit, np.float32)
    max_rot = np.full((n, 3), limit, np.float32)
    min_rot[0] = max_rot[0] = 0.0
    spec = make_chain_spec(
        parent=parent,
        length=length,
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=[3, 6, 9, 12, 15],
        effector_weight=[1.0, 1.0, 1.0, 1.0, 1.0],
    )
    pose = np.zeros((n, 3), np.float32)
    target_pose = np.zeros((n, 3), np.float32)
    target_pose[1] = (0.0, 0.15, 0.10)   # spine
    target_pose[2] = (0.0, 0.10, 0.10)   # chest
    target_pose[3] = (0.10, 0.0, 0.20)   # head
    target_pose[4] = (0.0, 0.80, 0.50)   # L shoulder
    target_pose[5] = (0.0, 0.0, 0.70)    # L elbow
    target_pose[7] = (0.0, -0.80, -0.50)  # R shoulder
    target_pose[8] = (0.0, 0.0, -0.70)   # R elbow
    target_pose[10] = (0.0, -0.60, 0.40)  # L hip
    target_pose[11] = (0.0, 0.0, -0.80)  # L knee
    target_pose[13] = (0.0, 0.60, -0.40)  # R hip
    target_pose[14] = (0.0, 0.0, 0.80)   # R knee
    origin = jnp.zeros(3, jnp.float32)
    points = fk_points(
        spec, jnp.asarray(target_pose, jnp.float32), origin
    )
    targets = np.asarray(points)[np.asarray([3, 6, 9, 12, 15])]
    return spec, _problem(pose, targets)


def batched_problem(
    problem: IKProblem,
    targets: jnp.ndarray,
    target_rot: Optional[jnp.ndarray] = None,
) -> IKProblem:
    """Broadcast one problem into S swarms with per-swarm targets.

    ``targets`` is ``(S, E, 3)``; pose/origin are tiled. This is the
    trajectory-sweep layout: one swarm per waypoint (SURVEY.md §2.5).
    """
    s = targets.shape[0]
    return IKProblem(
        pose=jnp.broadcast_to(problem.pose, (s,) + problem.pose.shape),
        origin=jnp.broadcast_to(problem.origin, (s,) + problem.origin.shape),
        targets=jnp.asarray(targets, jnp.float32),
        target_rot=None if target_rot is None else jnp.asarray(target_rot, jnp.float32),
    )
