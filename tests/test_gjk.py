"""Masked fixed-iteration GJK vs the exact SAT oracle and analytic cases."""

import jax
import jax.numpy as jnp
import numpy as np

from ikpso.ops.collision import obb_obb_intersect
from ikpso.ops.gjk import (
    box_support,
    capsule_support,
    gjk_box_box,
    gjk_intersect,
    sphere_support,
)
from ikpso.ops.rotations import euler_xyz_to_matrix

EYE = jnp.eye(3, dtype=jnp.float32)


def test_box_box_matches_sat_random(rng):
    # Random box pairs; GJK and SAT must agree except within a thin
    # margin around exact contact (open vs closed set semantics).
    n = 256
    ca = jnp.asarray(rng.uniform(-2, 2, size=(n, 3)), jnp.float32)
    cb = jnp.asarray(rng.uniform(-2, 2, size=(n, 3)), jnp.float32)
    ha = jnp.asarray(rng.uniform(0.2, 1.2, size=(n, 3)), jnp.float32)
    hb = jnp.asarray(rng.uniform(0.2, 1.2, size=(n, 3)), jnp.float32)
    ra = euler_xyz_to_matrix(jnp.asarray(rng.uniform(-3, 3, size=(n, 3)), jnp.float32))
    rb = euler_xyz_to_matrix(jnp.asarray(rng.uniform(-3, 3, size=(n, 3)), jnp.float32))

    sat = np.asarray(obb_obb_intersect(ca, ha, ra, cb, hb, rb))
    gjk = np.asarray(gjk_box_box(ca, ha, ra, cb, hb, rb))

    disagree = sat != gjk
    if disagree.any():
        # Any disagreement must be a near-contact configuration: shrink
        # both boxes 2% -> SAT says no-hit; grow 2% -> SAT says hit.
        idx = np.where(disagree)[0]
        grown = np.asarray(
            obb_obb_intersect(ca[idx], ha[idx] * 1.02, ra[idx], cb[idx], hb[idx] * 1.02, rb[idx])
        )
        shrunk = np.asarray(
            obb_obb_intersect(ca[idx], ha[idx] * 0.98, ra[idx], cb[idx], hb[idx] * 0.98, rb[idx])
        )
        assert (grown & ~shrunk).all(), f"non-marginal GJK/SAT disagreement at {idx}"
    # And they can't disagree often.
    assert disagree.mean() < 0.02


def test_box_box_analytic_cases():
    assert bool(
        gjk_box_box(
            jnp.zeros(3), jnp.ones(3), EYE, jnp.asarray([1.5, 0.0, 0.0]), jnp.ones(3), EYE
        )
    )
    assert not bool(
        gjk_box_box(
            jnp.zeros(3), jnp.ones(3), EYE, jnp.asarray([5.0, 0.0, 0.0]), jnp.ones(3), EYE
        )
    )
    # Containment: no separating direction ever found.
    assert bool(
        gjk_box_box(
            jnp.zeros(3),
            jnp.asarray([2.0, 2.0, 2.0]),
            EYE,
            jnp.asarray([0.3, 0.2, -0.1]),
            jnp.asarray([0.1, 0.1, 0.1]),
            EYE,
        )
    )


def test_sphere_sphere():
    a = sphere_support(jnp.zeros(3), 1.0)
    b_hit = sphere_support(jnp.asarray([1.5, 0.0, 0.0]), 1.0)
    b_miss = sphere_support(jnp.asarray([2.5, 0.0, 0.0]), 1.0)
    d0 = jnp.asarray([1.0, 0.0, 0.0])
    assert bool(gjk_intersect(a, b_hit, d0))
    assert not bool(gjk_intersect(a, b_miss, d0))


def test_capsule_box():
    # Capsule along X from (0,0,0) to (2,0,0), radius 0.25, vs a unit
    # box at (1, y, 0): hits while |y| < 0.5 + 0.25 (+contact band).
    cap = capsule_support(jnp.zeros(3), jnp.asarray([2.0, 0.0, 0.0]), 0.25)
    near = box_support(jnp.asarray([1.0, 0.7, 0.0]), jnp.full(3, 0.5), EYE)
    far = box_support(jnp.asarray([1.0, 0.8, 0.0]), jnp.full(3, 0.5), EYE)
    assert bool(gjk_intersect(cap, near, jnp.asarray([0.0, 1.0, 0.0])))
    assert not bool(gjk_intersect(cap, far, jnp.asarray([0.0, 1.0, 0.0])))


def test_gjk_jits_and_batches(rng):
    n = 64
    ca = jnp.asarray(rng.uniform(-2, 2, size=(n, 3)), jnp.float32)
    f = jax.jit(
        lambda c: gjk_box_box(c, jnp.full(3, 0.5), EYE, jnp.zeros(3), jnp.ones(3), EYE)
    )
    out = f(ca)
    assert out.shape == (n,)
    expected = np.all(np.abs(np.asarray(ca)) <= 1.5 + 1e-3, axis=-1)
    # Allow contact-band slack: compare against SAT instead of exact.
    sat = np.asarray(
        obb_obb_intersect(
            ca, jnp.full(3, 0.5), jnp.broadcast_to(EYE, (n, 3, 3)), jnp.zeros(3), jnp.ones(3), EYE
        )
    )
    assert (np.asarray(out) == sat).mean() > 0.95
    del expected
