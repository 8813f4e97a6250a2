"""Per-model solve recipes (shared by bench.py and the CLI).

The shared recipe shape: a short basin-finding PSO stage (canonical
inertia decaying 0.5 -> 0.2), an SoA Levenberg-Marquardt polish
finishing each swarm's gbest, and top-k retry rounds erasing the
failure tail (optionally with a diverse retry init or a target walk
for wrong-basin failures). ``impl`` names the PSO solver that runs the
recipe — the Triton megakernel (``"fused"``) or the ``lax.scan``
solver (``"jnp"``) — chosen per model by timing both on the GPU
(PERF.md, "Findings"). ``swarms`` is the model's benchmark batch.

These are deliberately OPT-IN (``bench.py`` defaults; ``--preset`` on
the CLI): the package-level ``PSOConfig`` defaults stay at reference
parity (randomized inertia, warm init — the configuration the
reference's published convergence numbers use).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FusedPreset:
    """One model's solve recipe."""

    particles: int
    iterations: int
    rekick_interval: int
    polish: int
    retries: int
    retry_init_mode: Optional[str] = None
    # PSO budget for the retry rounds only (None = same as the base):
    # only the failed bucket pays, so a much deeper retry is cheap —
    # the wrong-basin tail-closing tool (pso/restarts.py).
    retry_iterations: Optional[int] = None
    # Worst-N bucket per retry round (None = bench default
    # max(1024, S/16)). Models with a HIGH single-shot failure rate
    # (the 45-DOF humanoid) need rounds x bucket to cover the whole
    # failure set, not just a tail.
    retry_bucket: Optional[int] = None
    # Retry rounds as a W-step warm target WALK instead of an
    # independent restart (pso/restarts.py
    # wrap_solver_with_target_walk) — the reference's own per-frame
    # protocol applied to the failed bucket; for basins that resist
    # cold restarts. None/0 = ordinary retries.
    retry_walk: Optional[int] = None
    # Curved-path variation for walk retries: each round's
    # intermediate waypoints get a random offset scaled by this
    # fraction of the start-to-target span (annealed to zero at both
    # endpoints). 0 = straight walk paths.
    retry_walk_jitter: float = 0.0
    # Shrink the retry bucket K-fold per round (pso/restarts.py
    # bucket_decay): rounds after the first chase a geometrically-
    # shrinking residue. ONLY for models whose pre-retry failure rate
    # is low (a round's bucket must still cover the residue it faces);
    # high-failure models keep constant buckets.
    retry_bucket_decay: int = 1
    rekick_scale: float = 0.5
    rekick_threshold: float = 1e-6
    # The recipes use the canonical explore-then-exploit schedule.
    inertia: float = 0.5
    inertia_end: float = 0.2
    # Benchmark batch (a workload definition: how many independent
    # targets one call solves).
    swarms: int = 262_144
    # PSO solver for this model: "fused" (megakernel) where the kernel
    # was timed faster end to end on the GPU, else "jnp" (PERF.md).
    impl: str = "jnp"


FUSED_PRESETS = {
    # HEADLINE: with retries in place 8 PSO iterations find the basin,
    # 4 LM steps finish, and 4 shrinking-bucket retry rounds erase the
    # tail: first bucket S/32, decay 8 -> [32768, 4096, 1024, 1024].
    "arm_7dof": FusedPreset(128, 8, 0, 4, 4, swarms=1_048_576,
                            retry_bucket_decay=8, impl="fused"),
    # Planar's residual tail is warm-retry-resistant (wrong-basin
    # failures, not premature convergence): uniform-init retries
    # close it.
    "planar_3dof": FusedPreset(128, 8, 0, 4, 2, "uniform",
                               swarms=1_048_576, retry_bucket_decay=4,
                               impl="fused"),
    # The exactly-determined position+orientation task leaves
    # wrong-basin failures that only DIVERSE retries fix: 20
    # uniform-init retry rounds at a deep 80-iteration budget. Walk
    # retries do not help here: they interpolate positions with the
    # orientation held fixed, so they cannot re-explore the joint
    # basin structure.
    "arm_6dof": FusedPreset(128, 40, 20, 4, 20, "uniform",
                            retry_iterations=80),
    # 14-DOF needs the big P=1024 swarm for basin capture; hybrid-init
    # retries close the two-arm wrong-basin tail.
    "dual_arm_14dof": FusedPreset(1024, 8, 4, 4, 4, "hybrid"),
    # Single-shot far targets are not this model's protocol (the
    # reference re-solves per frame; see harness.experiment) — a deep
    # PSO budget with no polish or retries.
    "reference_arm": FusedPreset(256, 100, 0, 0, 0, impl="fused"),
    # 45-DOF 5-effector tree: the hardest single-shot basin in the zoo
    # (two 3-child branch points; random in-limit target sets are
    # mutually-coupled five-point constraints; the LM polish sticks in
    # limit/singularity traps from wrong basins). Retry rounds
    # re-solve the failed bucket via 8-step warm TARGET WALKS from the
    # canonical pose. The bucket stays large and CONSTANT: the
    # pre-retry failure rate is high, so rounds x bucket must cover the
    # whole failure set.
    "humanoid_45dof": FusedPreset(512, 60, 0, 6, 6,
                                  retry_iterations=60,
                                  retry_bucket=8192, retry_walk=8,
                                  swarms=16_384),
    # Deep serial chains: 4 PSO iterations find the basin, polish and
    # retries finish. snake:<links> shares the recipe.
    "snake_30dof": FusedPreset(256, 4, 2, 4, 2, swarms=65_536,
                               retry_bucket_decay=4),
}


def fused_preset(model: str) -> Optional[FusedPreset]:
    """Preset for a model-zoo name (``snake:<links>`` shares snake_30dof)."""
    if model.startswith("snake:"):
        model = "snake_30dof"
    return FUSED_PRESETS.get(model)
