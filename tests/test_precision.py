"""Every f32 contraction in the FK, polish, collision and GJK programs
asks for full precision.

On a GPU a default-precision f32 product may run in TF32 (about three
decimal digits), which puts mm-scale error into FK — the reference the
kernels are judged against. Tracing is platform-free, so the CPU can
check the whole program's jaxpr.
"""

import jax
import jax.extend
import jax.numpy as jnp
import pytest
from jax import lax

from ikpso.models import library
from ikpso.models.chain import Obstacles
from ikpso.ops import fk as fk_ops


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dot_precisions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _dot_precisions(sub)


def _program(name):
    spec, problem = library.arm_6dof()  # orientation targets
    s = 2
    batched = library.batched_problem(
        problem,
        jnp.broadcast_to(problem.targets, (s,) + problem.targets.shape),
        target_rot=jnp.broadcast_to(
            problem.target_rot, (s,) + problem.target_rot.shape
        ),
    )
    obstacles = Obstacles.from_boxes([(1.2, 0.6, -0.4)], [(0.8, 0.8, 0.8)])
    pos, rot = fk_ops.fk(spec, batched.pose, batched.origin)
    parent = pos[..., list(spec.parent[1:]), :]
    args = (pos[:, 1:], rot[:, 1:], parent, spec.length[1:],
            obstacles.center, obstacles.half_extent, obstacles.rot)
    if name == "fk":
        return lambda p: (fk_ops.fk(spec, p, batched.origin),
                          fk_ops.fk_serial_scan(spec, p, batched.origin)), (batched.pose,)
    if name == "polish":
        from ikpso.pso.polish import polish_angles

        def run(b, a):
            return (polish_angles(spec, b, a, steps=2, use_orientation=True),
                    polish_angles(spec, b, a, steps=2, use_orientation=True,
                                  soa=False))

        return run, (batched, fk_ops.pose_to_angles(spec, batched.pose))
    if name == "collision":
        from ikpso.ops.collision import get_chain_collider

        return lambda *a: [get_chain_collider("sat", shape)(*a)
                           for shape in ("box", "capsule")], args
    from ikpso.ops.collision import get_chain_collider

    return lambda *a: [get_chain_collider("gjk", shape)(*a)
                       for shape in ("box", "capsule")], args


@pytest.mark.parametrize("name", ["fk", "polish", "collision", "gjk"])
def test_every_dot_general_is_highest_precision(name):
    fn, args = _program(name)
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    precisions = list(_dot_precisions(jaxpr))
    assert precisions, f"{name}: no contraction traced — the test proves nothing"
    for prec in precisions:
        assert prec is not None, f"{name}: a dot_general has default precision"
        pair = prec if isinstance(prec, tuple) else (prec, prec)
        assert all(p == lax.Precision.HIGHEST for p in pair), (name, prec)
