"""NaN/divergence guards (SURVEY.md §5 failure-detection plan)."""

import dataclasses

import numpy as np
import pytest

from ikpso.ops.fitness import COLLISION_PENALTY
from ikpso.utils.guards import SolveDivergedError, check_solve_result


@dataclasses.dataclass
class FakeResult:
    angles: np.ndarray
    fitness: np.ndarray
    effector_error: np.ndarray


def _ok():
    return FakeResult(
        angles=np.zeros((2, 3), np.float32),
        fitness=np.asarray([0.1, 0.2], np.float32),
        effector_error=np.asarray([0.01, 0.02], np.float32),
    )


def test_finite_result_passes():
    check_solve_result(_ok())


def test_nan_raises_with_context():
    res = _ok()
    res.angles[1, 2] = np.nan
    with pytest.raises(SolveDivergedError, match="frame 7.*angles"):
        check_solve_result(res, context="frame 7")


def test_inf_raises():
    res = _ok()
    res.effector_error[0] = np.inf
    with pytest.raises(SolveDivergedError):
        check_solve_result(res)


def test_all_rejected_warns():
    res = _ok()
    res.fitness[0] = float(COLLISION_PENALTY)
    with pytest.warns(RuntimeWarning, match="no collision-free pose"):
        check_solve_result(res)
