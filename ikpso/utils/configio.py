"""Runtime configuration: JSON <-> dataclass, chain specs as data.

The reference's configuration is three static tiers — compile-time
#defines, hardcoded constructor args, and one CLI arg
(SURVEY.md §5 "config/flag system"). Here everything is runtime data:
PSO/fitness configs, chain topology, targets, obstacles, and solver
options load from a single JSON document (or CLI overrides); DOF and
topology changes re-trace instead of re-compile.

Schema (all sections optional, see DEFAULTS):

  {
    "model": "reference_arm" | "planar_3dof" | ... | {"parent": [...],
        "length": [...], "min_rotation": ..., "max_rotation": ...,
        "effector_idx": [...], "effector_weight": [...],
        "pose": [...], "origin": [...], "targets": [...]},
    "pso": {"inertia": 0.5, "cognitive": 0.5, "social": 1.25,
            "iterations": 15, "inertia_mode": "randomized"},
    "fitness": {"angle_weight": 3.0, "distance_weight": 0.0,
                "orientation_weight": 0.0},
    "num_particles": 16384,
    "obstacles": {"centers": [...], "full_dims": [...], "quats": [...]}
  }
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ikpso.models import library
from ikpso.models.chain import ChainSpec, IKProblem, Obstacles, make_chain_spec
from ikpso.ops.fitness import FitnessConfig
from ikpso.pso.config import PSOConfig

_MODELS = {
    "reference_arm": library.reference_arm,
    "planar_3dof": library.planar_3dof,
    "arm_6dof": library.arm_6dof,
    "arm_7dof": library.arm_7dof,
    "dual_arm_14dof": library.dual_arm_14dof,
    "snake_30dof": library.snake_30dof,
    "humanoid_45dof": library.humanoid_45dof,
}


@dataclasses.dataclass
class RunConfig:
    spec: ChainSpec
    problem: IKProblem
    pso: PSOConfig
    fitness: FitnessConfig
    num_particles: int
    obstacles: Optional[Obstacles]


def _dataclass_from_dict(cls, data: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - fields
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**data)


def _model_from_config(model) -> Tuple[ChainSpec, IKProblem]:
    if isinstance(model, str):
        if model.startswith("snake:"):
            # Parameterized long-chain family: "snake:<links>" — any
            # chain depth without recompiling (vs the reference's
            # compile-time DOF, ik_constants.h:3).
            return library.snake(int(model.split(":", 1)[1]))
        if model not in _MODELS:
            raise ValueError(
                f"unknown model {model!r}; available: "
                f"{sorted(_MODELS)} or 'snake:<links>'"
            )
        return _MODELS[model]()
    spec = make_chain_spec(
        parent=model["parent"],
        length=model["length"],
        min_rotation=model["min_rotation"],
        max_rotation=model["max_rotation"],
        effector_idx=model["effector_idx"],
        effector_weight=model.get("effector_weight"),
    )
    n = spec.num_nodes
    pose = np.asarray(model.get("pose", np.zeros((n, 3))), np.float32)
    origin = np.asarray(model.get("origin", (0.0, 0.0, 0.0)), np.float32)
    targets = np.asarray(model["targets"], np.float32)
    target_rot = model.get("target_rot")
    problem = IKProblem(
        pose=jnp.asarray(pose),
        origin=jnp.asarray(origin),
        targets=jnp.asarray(targets),
        target_rot=None if target_rot is None else jnp.asarray(target_rot, jnp.float32),
    )
    return spec, problem


def load_config(source) -> RunConfig:
    """Build a RunConfig from a dict, JSON string, or JSON file path."""
    if isinstance(source, str):
        if source.strip().startswith("{"):
            data = json.loads(source)
        else:
            with open(source) as f:
                data = json.load(f)
    else:
        data = dict(source)

    spec, problem = _model_from_config(data.get("model", "reference_arm"))
    pso = _dataclass_from_dict(PSOConfig, data.get("pso", {}))
    fitness = _dataclass_from_dict(FitnessConfig, data.get("fitness", {}))
    obstacles = None
    if "obstacles" in data and data["obstacles"]:
        ob = data["obstacles"]
        obstacles = Obstacles.from_boxes(
            ob["centers"], ob["full_dims"], ob.get("quats")
        )
    return RunConfig(
        spec=spec,
        problem=problem,
        pso=pso,
        fitness=fitness,
        num_particles=int(data.get("num_particles", 16384)),
        obstacles=obstacles,
    )


def dump_config(cfg: RunConfig) -> str:
    """Serialize a RunConfig back to JSON (custom-model form)."""
    spec, problem = cfg.spec, cfg.problem
    doc = {
        "model": {
            "parent": list(spec.parent),
            "length": np.asarray(spec.length).tolist(),
            "min_rotation": np.asarray(spec.min_rotation).tolist(),
            "max_rotation": np.asarray(spec.max_rotation).tolist(),
            "effector_idx": list(spec.effector_idx),
            "effector_weight": np.asarray(spec.effector_weight).tolist(),
            "pose": np.asarray(problem.pose).tolist(),
            "origin": np.asarray(problem.origin).tolist(),
            "targets": np.asarray(problem.targets).tolist(),
        },
        "pso": {
            "inertia": float(cfg.pso.inertia),
            "cognitive": float(cfg.pso.cognitive),
            "social": float(cfg.pso.social),
            "iterations": cfg.pso.iterations,
            "inertia_mode": cfg.pso.inertia_mode,
            "init_mode": cfg.pso.init_mode,
            "init_velocity_scale": float(cfg.pso.init_velocity_scale),
            "inertia_end": float(cfg.pso.inertia_end),
            "gbest_interval": cfg.pso.gbest_interval,
            "rekick_interval": cfg.pso.rekick_interval,
            "rekick_scale": float(cfg.pso.rekick_scale),
            "rekick_threshold": float(cfg.pso.rekick_threshold),
        },
        "fitness": {
            "angle_weight": float(cfg.fitness.angle_weight),
            "distance_weight": float(cfg.fitness.distance_weight),
            "orientation_weight": float(cfg.fitness.orientation_weight),
            "error_threshold": float(cfg.fitness.error_threshold),
            "collision_backend": cfg.fitness.collision_backend,
            "collision_shape": cfg.fitness.collision_shape,
            "trig_impl": cfg.fitness.trig_impl,
            "fk_impl": cfg.fitness.fk_impl,
        },
        "num_particles": cfg.num_particles,
    }
    if problem.target_rot is not None:
        doc["model"]["target_rot"] = np.asarray(problem.target_rot).tolist()
    if cfg.obstacles is not None and cfg.obstacles.count:
        doc["obstacles"] = {
            "centers": np.asarray(cfg.obstacles.center).tolist(),
            "full_dims": (np.asarray(cfg.obstacles.half_extent) * 2.0).tolist(),
        }
    return json.dumps(doc, indent=2)
