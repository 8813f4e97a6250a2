"""PSO hyperparameters.

Reference schema: ``PSOConfig{inertia, local, global, iterations}``
(reference Particle.h:70-85). Defaults here are the values the
reference actually runs with (Main.cpp:130: 0.5/0.5/1.25/15), not the
struct defaults (0.2/0.5/0.7/10) — SURVEY.md §2.4.7.
"""

from __future__ import annotations

import dataclasses

import jax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Swarm-update hyperparameters.

    Attributes:
      inertia / cognitive / social: velocity-update coefficients
        (the reference's ``_inertia`` / ``_local`` / ``_global``).
      iterations: PSO iterations per solve (static: sets the
        ``lax.scan`` length).
      inertia_mode: ``"randomized"`` multiplies the inertia term by a
        fresh U(0,1) draw — the reference's nonstandard update
        (reference kernel.cu:164, SURVEY.md §2.4.2) and the behavior
        its published convergence numbers were measured with, so it is
        the default. ``"canonical"`` is textbook PSO (inertia * v).
      init_velocity_scale: half-width of the uniform initial-velocity
        distribution; the reference draws U(-1, 1)
        (kernel.cu:261: ``curand_uniform * 2 - 1``).
    """

    inertia: float = 0.5
    cognitive: float = 0.5
    social: float = 1.25
    iterations: int = dataclasses.field(default=15, metadata=dict(static=True))
    inertia_mode: str = dataclasses.field(
        default="randomized", metadata=dict(static=True)
    )
    init_velocity_scale: float = 1.0
    # "warm": all particles start AT the current pose (the reference's
    # shipped iteration-2+ init, kernel.cu:249-253). "uniform":
    # particles start uniformly over the joint range — the reference's
    # iteration-1 protocol (Documentation/Iteration_1), kept for
    # convergence-parity experiments against that report's numbers.
    # "hybrid": particle 0 starts at the current pose, the rest
    # uniformly over the joint range — warm-start anchoring plus
    # global basin coverage for single-shot far-target solves (the
    # wrong-basin tail of exactly-determined tasks like
    # arm_6dof position+orientation).
    init_mode: str = dataclasses.field(default="warm", metadata=dict(static=True))
    # Optional linear inertia schedule (canonical mode only): the
    # inertia decays from ``inertia`` to ``inertia_end`` over the run —
    # the classic explore-then-exploit PSO schedule the reference lacks.
    inertia_end: float = dataclasses.field(default=-1.0, metadata=dict(static=True))
    # Recompute the swarm's global best every K iterations instead of
    # every iteration (async-PSO relaxation: the social attractor lags
    # by at most K-1 steps; local bests still update every step).
    # Megakernel only; a lagging attractor loosens convergence, so
    # keep the default 1 unless the workload tolerates that.
    gbest_interval: int = dataclasses.field(default=1, metadata=dict(static=True))
    # Velocity re-kick (0 = off): every ``rekick_interval`` iterations,
    # replace every particle's velocity with a fresh U(-1, 1) *
    # ``rekick_scale`` draw (positions and local bests are untouched).
    # Rescues prematurely-converged swarms — a warm-started swarm that
    # collapses onto a local optimum has near-zero velocity everywhere,
    # and the randomized-inertia update can never regrow it; the kick
    # restarts exploration around the collapsed cluster. The final
    # answer is the argmin over local bests, so a kick can never make
    # the reported solution worse.
    rekick_interval: int = dataclasses.field(default=0, metadata=dict(static=True))
    rekick_scale: float = 1.0
    # Selective re-kick: when >= 0, only swarms whose current
    # global-best fitness is ABOVE this value get kicked — swarms that
    # already converged keep their quiet refinement phase (tight p50),
    # while stuck ones restart exploration. < 0 kicks every swarm.
    rekick_threshold: float = dataclasses.field(
        default=-1.0, metadata=dict(static=True)
    )

    def __post_init__(self):
        if self.inertia_mode not in ("randomized", "canonical"):
            raise ValueError(f"unknown inertia_mode: {self.inertia_mode!r}")
        if self.init_mode not in ("warm", "uniform", "hybrid"):
            raise ValueError(f"unknown init_mode: {self.init_mode!r}")
        if self.inertia_end >= 0.0 and self.inertia_mode != "canonical":
            raise ValueError("inertia_end requires inertia_mode='canonical'")
        if self.rekick_interval < 0:
            raise ValueError("rekick_interval must be >= 0")

    def inertia_at(self, iteration):
        """Inertia coefficient for a (possibly traced) iteration index."""
        if self.inertia_end < 0.0:
            return self.inertia
        span = float(max(self.iterations - 1, 1))
        frac = iteration / span
        return self.inertia + (self.inertia_end - self.inertia) * frac
