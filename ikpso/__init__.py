"""ikpso — batched particle-swarm inverse-kinematics engine for the GPU.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference CUDA application ``MadDevX/Inverse-Kinematics-PSO-Research``
(see ``SURVEY.md``): batched forward kinematics for articulated
kinematic trees, PSO over joint-angle space with warm-start
initialization, locality-regularized fitness with box-obstacle
collision rejection, the reset->solve->frames-to-converge experiment
harness, diagnostics streams, and an offline visualizer.

Design (batched, not a port):
  * The core data object is an ``(S, P, D)`` tensor — S independent
    swarms (one per IK target/waypoint), P particles, D degrees of
    freedom.
  * One jitted ``solve()`` = swarm init + ``lax.scan`` over PSO
    iterations; the global-best reduction is an on-device argmin in the
    scan carry — zero host round-trips per iteration (the reference
    performs a thrust reduction + D2H scalar sync every iteration,
    reference kernel.cu:307-323).
  * The megakernel (``pso.fused``, Pallas on the Triton route) runs a
    whole swarm's solve in one GPU program with its state in
    registers.
  * Scaling is a ``jax.sharding.Mesh``: swarm axis sharded across
    devices and processes (embarrassingly parallel), with an optional
    particle-sharded mode whose gbest is an all-reduce.
"""

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles, make_chain_spec
from ikpso.models.library import (
    planar_3dof,
    arm_6dof,
    arm_7dof,
    batched_problem,
    dual_arm_14dof,
    reference_arm,
    serial_chain,
)
from ikpso.ops.fk import fk, fk_points
from ikpso.ops.fitness import FitnessConfig, fitness, true_effector_error
from ikpso.pso.config import PSOConfig
from ikpso.pso.solver import SolveResult, make_solver, solve, solve_single

__all__ = [
    "ChainSpec",
    "IKProblem",
    "Obstacles",
    "FitnessConfig",
    "PSOConfig",
    "SolveResult",
    "fk",
    "fk_points",
    "fitness",
    "true_effector_error",
    "make_chain_spec",
    "make_solver",
    "solve",
    "solve_single",
    "batched_problem",
    "planar_3dof",
    "arm_6dof",
    "arm_7dof",
    "dual_arm_14dof",
    "reference_arm",
    "serial_chain",
]

__version__ = "0.1.0"
