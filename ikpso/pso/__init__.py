"""The PSO solver core."""

from ikpso.pso.config import PSOConfig
from ikpso.pso.restarts import make_retry_solver, solve_with_retries
from ikpso.pso.solver import SolveResult, make_solver, solve, solve_single
