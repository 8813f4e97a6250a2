"""Experiment harness: reference protocol, trajectory sweeps, CLI."""

from ikpso.harness.experiment import ExperimentResult, frames_to_converge, run_reference_experiment
from ikpso.harness.trajectory import SweepResult, solve_waypoints
