"""Failure detection: per-solve NaN/divergence guards.

The reference has no failure detection at all — `checkCuda` asserts in
debug builds only and release silently continues (reference
utility_kernels.cuh:9-19; SURVEY.md §5). Here every harness loop can
validate each solve on the host: NaN/Inf in the result raises
immediately with context, and an all-particles-rejected solve (gbest
fitness == COLLISION_PENALTY, i.e. the reference's FLT_MAX rejection
value survived the whole swarm) is surfaced as a warning. Solves are
stateless, so a failed batch is retryable by construction.
"""

from __future__ import annotations

import warnings

import numpy as np

from ikpso.ops.fitness import COLLISION_PENALTY


class SolveDivergedError(FloatingPointError):
    """A solve produced NaN/Inf state."""


def check_solve_result(result, context: str = "") -> None:
    """Raise :class:`SolveDivergedError` on non-finite solver output.

    Args:
      result: a ``SolveResult`` (or anything with angles / fitness /
        effector_error array attributes).
      context: human-readable location (e.g. ``"frame 12"``) included
        in the error.
    """
    where = f" ({context})" if context else ""
    for name in ("angles", "fitness", "effector_error"):
        arr = np.asarray(getattr(result, name))
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise SolveDivergedError(
                f"solve diverged{where}: {bad} non-finite values in '{name}'"
            )
    fit = np.asarray(result.fitness)
    rejected = fit >= float(COLLISION_PENALTY)
    if rejected.any():
        warnings.warn(
            f"{int(rejected.sum())} swarm(s) found no collision-free pose"
            f"{where}: global best is still the FLT_MAX rejection value",
            RuntimeWarning,
            stacklevel=2,
        )
