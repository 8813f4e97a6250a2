"""Compute ops: rotations, FK, fitness, collision, per-particle tile math.

NOTE: the submodule names ``fk`` and ``fitness`` collide with their main
function names; the package namespace keeps the SUBMODULES (so
``from ikpso.ops import fk as fk_ops`` works). Import the functions
from the submodules directly: ``from ikpso.ops.fk import fk``.
"""

from ikpso.ops import collision, fitness, fk, gjk, rotations, tile_fitness
from ikpso.ops.collision import chain_collides, obb_obb_intersect
from ikpso.ops.gjk import chain_collides_gjk, gjk_box_box, gjk_intersect
from ikpso.ops.fitness import COLLISION_PENALTY, FitnessConfig, true_effector_error
from ikpso.ops.fk import (
    angles_to_pose,
    effector_positions,
    fk_points,
    fk_serial_scan,
    pose_to_angles,
)

__all__ = [
    "collision",
    "fitness",
    "fk",
    "gjk",
    "chain_collides_gjk",
    "gjk_box_box",
    "gjk_intersect",
    "tile_fitness",
    "rotations",
    "chain_collides",
    "obb_obb_intersect",
    "COLLISION_PENALTY",
    "FitnessConfig",
    "true_effector_error",
    "angles_to_pose",
    "effector_positions",
    "fk_points",
    "fk_serial_scan",
    "pose_to_angles",
]
