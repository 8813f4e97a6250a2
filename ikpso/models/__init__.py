"""Kinematic models: ChainSpec/IKProblem and the prebuilt library."""

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles, make_chain_spec, stack_problems
from ikpso.models.library import (
    arm_6dof,
    arm_7dof,
    batched_problem,
    dual_arm_14dof,
    planar_3dof,
    reference_arm,
    reference_reset_targets,
    serial_chain,
)
