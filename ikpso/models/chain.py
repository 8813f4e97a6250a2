"""Kinematic-tree specification and per-solve problem state.

The reference models the arm as a host-side ``Node`` scene graph
(reference Node.h:37-463) flattened each frame into a parent-indexed
``NodeCUDA[]`` array via per-node H2D memcpys (reference
Node.h:232-267). Here the tree IS the flat form from the start:

  * :class:`ChainSpec` — static topology and joint data. The parent
    index array and effector index list are **trace-time constants**
    (pytree aux data), so forward kinematics unrolls into straight-line
    XLA with static gathers; joint limits / lengths / weights are
    device arrays.
  * :class:`IKProblem` — the per-solve (per-swarm, batchable) state:
    current pose (the PSO warm start AND the locality-regularizer
    anchor, SURVEY.md §2.3), origin placement, targets, and scene
    colliders.

Nodes must be topologically ordered (``parent[k] < k``; the reference
guarantees this via its pre-order DFS flattening, Node.h:232-267).
Node 0 is the origin: it contributes no degrees of freedom to the
particle vector (reference kernel.cu:44-46 indexes particles from node
1), so ``dof = (num_nodes - 1) * 3``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _as_f32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static description of an articulated kinematic tree.

    Equivalent of the reference's ``NodeCUDA`` array schema
    (reference Particle.h:25-40) minus the per-solve fields (current
    rotation, targets), which live in :class:`IKProblem`.

    Attributes:
      parent: tuple of parent node indices, ``parent[0] == -1``;
        static (trace-time) — topology changes retrace, matching the
        "shapes are static per jit trace" XLA model.
      effector_idx: tuple of node indices that are effectors, in the
        order their targets appear in ``IKProblem.targets``.
      length: ``(N,)`` link length along the parent-local +X axis
        (reference kernel.cu:54 translates by (length, 0, 0)).
      min_rotation / max_rotation: ``(N, 3)`` per-axis joint limits,
        enforced by clamping (reference kernel.cu:183-185).
      effector_weight: ``(N,)`` fitness weight; zero for non-effectors.
    """

    length: jnp.ndarray
    min_rotation: jnp.ndarray
    max_rotation: jnp.ndarray
    effector_weight: jnp.ndarray
    parent: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    effector_idx: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def num_nodes(self) -> int:
        return len(self.parent)

    @property
    def num_effectors(self) -> int:
        return len(self.effector_idx)

    @property
    def dof(self) -> int:
        """Degrees of freedom = 3 per non-origin node (SURVEY.md §2.3)."""
        return (self.num_nodes - 1) * 3

    def validate(self) -> "ChainSpec":
        if self.parent[0] != -1:
            raise ValueError("node 0 must be the origin (parent == -1)")
        for k, p in enumerate(self.parent[1:], start=1):
            if not 0 <= p < k:
                raise ValueError(
                    f"nodes must be topologically ordered: parent[{k}]={p}"
                )
        for e in self.effector_idx:
            if not 0 < e < self.num_nodes:
                raise ValueError(f"effector index {e} out of range")
        n = self.num_nodes
        for name in ("length", "effector_weight"):
            if getattr(self, name).shape != (n,):
                raise ValueError(f"{name} must have shape ({n},)")
        for name in ("min_rotation", "max_rotation"):
            if getattr(self, name).shape != (n, 3):
                raise ValueError(f"{name} must have shape ({n}, 3)")
        return self


def make_chain_spec(
    parent,
    length,
    min_rotation,
    max_rotation,
    effector_idx,
    effector_weight=None,
) -> ChainSpec:
    """Build and validate a :class:`ChainSpec` from array-likes.

    ``effector_weight`` may be given per-effector (len == num
    effectors) or per-node (len == num nodes); default weight is 1.0
    per effector (reference Main.cpp:83-85 passes weight 1.0).
    """
    parent = tuple(int(p) for p in np.asarray(parent))
    effector_idx = tuple(int(e) for e in np.asarray(effector_idx))
    n = len(parent)
    length = _as_f32(np.broadcast_to(np.asarray(length, np.float32), (n,)))
    min_rotation = _as_f32(np.broadcast_to(np.asarray(min_rotation, np.float32), (n, 3)))
    max_rotation = _as_f32(np.broadcast_to(np.asarray(max_rotation, np.float32), (n, 3)))
    weights = np.zeros((n,), np.float32)
    if effector_weight is None:
        weights[list(effector_idx)] = 1.0
    else:
        ew = np.asarray(effector_weight, np.float32)
        if ew.shape == (len(effector_idx),):
            weights[list(effector_idx)] = ew
        elif ew.shape == (n,):
            weights = ew
        else:
            raise ValueError("effector_weight must be per-effector or per-node")
    return ChainSpec(
        parent=parent,
        effector_idx=effector_idx,
        length=length,
        min_rotation=min_rotation,
        max_rotation=max_rotation,
        effector_weight=_as_f32(weights),
    ).validate()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Obstacles:
    """Oriented-box scene colliders (reference BoxCollider.h:4-10).

    ``half_extent`` stores HALF sizes; the reference's ``obj_t.x/y/z``
    are full dimensions halved inside the GJK support function
    (reference kernel.cu supportBox: ``Signum(dir)*obj->x*0.5``).
    ``rot`` is the box world rotation as a matrix (the reference keeps
    a quaternion; a matrix is what the SAT test consumes directly).
    """

    center: jnp.ndarray  # (C, 3)
    half_extent: jnp.ndarray  # (C, 3)
    rot: jnp.ndarray  # (C, 3, 3)

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def empty() -> "Obstacles":
        return Obstacles(
            center=jnp.zeros((0, 3), jnp.float32),
            half_extent=jnp.zeros((0, 3), jnp.float32),
            rot=jnp.zeros((0, 3, 3), jnp.float32),
        )

    @staticmethod
    def from_boxes(centers, full_dims, quats=None) -> "Obstacles":
        """Build from full box dimensions and optional (x,y,z,w) quats."""
        from ikpso.ops.rotations import quaternion_to_matrix

        centers = _as_f32(np.atleast_2d(np.asarray(centers, np.float32)))
        dims = _as_f32(np.atleast_2d(np.asarray(full_dims, np.float32)))
        c = centers.shape[0]
        if quats is None:
            rot = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (c, 3, 3))
        else:
            rot = quaternion_to_matrix(_as_f32(np.atleast_2d(np.asarray(quats, np.float32))))
        return Obstacles(center=centers, half_extent=dims * 0.5, rot=rot)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IKProblem:
    """Per-solve state; every field may carry leading batch (swarm) axes.

    Attributes:
      pose: ``(..., N, 3)`` current Euler-XYZ joint rotations. Row 0 is
        the origin rotation (fixed during the solve — reference
        kernel.cu:36-42 builds the root matrix from chain[0], never
        from particle state). Rows 1..N-1 are the PSO warm start and
        the locality anchor.
      origin: ``(..., 3)`` origin world translation
        (reference NodeCUDA.position, used at kernel.cu:37).
      targets: ``(..., E, 3)`` effector target positions, ordered like
        ``ChainSpec.effector_idx``.
      target_rot: optional ``(..., E, 3)`` Euler target orientations.
        The reference marshals these but never uses them in fitness
        (Node.h:445-447; SURVEY.md §2.3) — here they are a real,
        optional cost term (FitnessConfig.orientation_weight).
    """

    pose: jnp.ndarray
    origin: jnp.ndarray
    targets: jnp.ndarray
    target_rot: Optional[jnp.ndarray] = None

    def batch_shape(self) -> Tuple[int, ...]:
        return self.pose.shape[:-2]

    def replace(self, **kw) -> "IKProblem":
        return dataclasses.replace(self, **kw)


def stack_problems(problems) -> IKProblem:
    """Stack a list of unbatched problems into one batched IKProblem."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *problems)
