"""OBB SAT truth tables: known box pairs with analytic answers."""

import numpy as np
import jax.numpy as jnp

from ikpso.ops.collision import chain_collides, obb_obb_intersect
from ikpso.ops.rotations import euler_xyz_to_matrix

EYE = jnp.eye(3, dtype=jnp.float32)


def boxes(ca, ha, cb, hb, ra=None, rb=None):
    return (
        jnp.asarray(ca, jnp.float32),
        jnp.asarray(ha, jnp.float32),
        EYE if ra is None else ra,
        jnp.asarray(cb, jnp.float32),
        jnp.asarray(hb, jnp.float32),
        EYE if rb is None else rb,
    )


def test_identical_boxes_intersect():
    assert bool(obb_obb_intersect(*boxes([0, 0, 0], [1, 1, 1], [0, 0, 0], [1, 1, 1])))


def test_clearly_separated():
    assert not bool(
        obb_obb_intersect(*boxes([0, 0, 0], [1, 1, 1], [5, 0, 0], [1, 1, 1]))
    )


def test_face_touching_axis_aligned():
    # Unit half-extent boxes 2 apart along X: exactly touching faces.
    # With the eps fattening, touching counts as intersecting (matches
    # GJK's closed-set semantics).
    assert bool(obb_obb_intersect(*boxes([0, 0, 0], [1, 1, 1], [2.0 - 1e-4, 0, 0], [1, 1, 1])))
    assert not bool(obb_obb_intersect(*boxes([0, 0, 0], [1, 1, 1], [2.0 + 1e-3, 0, 0], [1, 1, 1])))


def test_rotated_45_degrees_corner_overlap():
    # A 45-degree rotated unit box's corner extends sqrt(2) along X:
    # centers 2.3 apart -> overlap (1 + 1.414 > 2.3); 2.5 apart -> none.
    rb = euler_xyz_to_matrix(jnp.asarray([0.0, 0.0, np.pi / 4], jnp.float32))
    assert bool(
        obb_obb_intersect(*boxes([0, 0, 0], [1, 1, 1], [2.3, 0, 0], [1, 1, 1], rb=rb))
    )
    assert not bool(
        obb_obb_intersect(*boxes([0, 0, 0], [1, 1, 1], [2.5, 0, 0], [1, 1, 1], rb=rb))
    )


def test_edge_cross_axis_separation():
    # Two long thin rods crossed at right angles but offset in Z:
    # only the edge-cross axes separate them.
    ra = EYE
    rb = euler_xyz_to_matrix(jnp.asarray([0.0, 0.0, np.pi / 2], jnp.float32))
    ha = jnp.asarray([2.0, 0.1, 0.1], jnp.float32)
    hb = jnp.asarray([2.0, 0.1, 0.1], jnp.float32)
    near = obb_obb_intersect(
        jnp.zeros(3), ha, ra, jnp.asarray([0.0, 0.0, 0.15], jnp.float32), hb, rb
    )
    far = obb_obb_intersect(
        jnp.zeros(3), ha, ra, jnp.asarray([0.0, 0.0, 0.25], jnp.float32), hb, rb
    )
    assert bool(near)
    assert not bool(far)


def test_containment():
    # Small box fully inside a big one: no separating axis exists.
    assert bool(
        obb_obb_intersect(*boxes([0, 0, 0], [2, 2, 2], [0.3, 0.2, -0.1], [0.1, 0.1, 0.1]))
    )


def test_batched_broadcast(rng):
    # (B,) batch of A boxes vs one B box.
    ca = jnp.asarray(rng.uniform(-3, 3, size=(32, 3)), jnp.float32)
    ha = jnp.full((32, 3), 0.5, jnp.float32)
    ra = jnp.broadcast_to(EYE, (32, 3, 3))
    hit = obb_obb_intersect(
        ca, ha, ra, jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32), EYE
    )
    assert hit.shape == (32,)
    expected = np.all(np.abs(np.asarray(ca)) < 1.5 + 1e-5, axis=-1)
    np.testing.assert_array_equal(np.asarray(hit), expected)


def test_chain_collides_link_midpoint():
    # Single link from (0,0,0) to (1,0,0); obstacle over the midpoint
    # but far from both endpoints: only the LINK box should hit.
    positions = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    rotations = jnp.broadcast_to(EYE, (1, 3, 3))
    parents = jnp.zeros((1, 3), jnp.float32)
    lengths = jnp.asarray([1.0], jnp.float32)
    obstacle_c = jnp.asarray([[0.5, 0.0, 0.0]], jnp.float32)
    obstacle_h = jnp.asarray([[0.05, 0.05, 0.05]], jnp.float32)
    obstacle_r = jnp.broadcast_to(EYE, (1, 3, 3))
    hit = chain_collides(
        positions, rotations, parents, lengths, obstacle_c, obstacle_h, obstacle_r
    )
    assert bool(hit)
    # Same obstacle shifted off-axis in Y beyond gizmo/4: no hit.
    hit2 = chain_collides(
        positions,
        rotations,
        parents,
        lengths,
        jnp.asarray([[0.5, 0.2, 0.0]], jnp.float32),
        obstacle_h,
        obstacle_r,
    )
    assert not bool(hit2)


def test_empty_obstacles_never_hit():
    positions = jnp.zeros((4, 2, 3), jnp.float32)
    rotations = jnp.broadcast_to(EYE, (4, 2, 3, 3))
    hit = chain_collides(
        positions,
        rotations,
        positions,
        jnp.ones((2,), jnp.float32),
        jnp.zeros((0, 3), jnp.float32),
        jnp.zeros((0, 3), jnp.float32),
        jnp.zeros((0, 3, 3), jnp.float32),
    )
    assert hit.shape == (4,)
    assert not bool(hit.any())


# --- Capsule shape: exact point/segment OBB distances -----------------


def test_point_obb_dist2_axis_aligned():
    from ikpso.ops.collision import point_obb_dist2

    c = jnp.zeros(3)
    h = jnp.asarray([1.0, 2.0, 3.0])
    # Inside -> 0; face/edge/corner distances analytic.
    assert float(point_obb_dist2(jnp.asarray([0.5, -1.0, 2.0]), c, h, EYE)) == 0.0
    np.testing.assert_allclose(
        float(point_obb_dist2(jnp.asarray([3.0, 0.0, 0.0]), c, h, EYE)), 4.0,
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(point_obb_dist2(jnp.asarray([2.0, 3.0, 0.0]), c, h, EYE)),
        1.0 + 1.0, rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(point_obb_dist2(jnp.asarray([2.0, 3.0, 4.0]), c, h, EYE)),
        3.0, rtol=1e-6,
    )


def test_point_obb_dist2_rotated():
    from ikpso.ops.collision import point_obb_dist2

    # Unit cube rotated 45 deg about Z: the point at (sqrt(2)+1, 0, 0)
    # sits 1 unit off the rotated corner edge along X.
    rot = euler_xyz_to_matrix(jnp.asarray([0.0, 0.0, np.pi / 4]))
    p = jnp.asarray([np.sqrt(2.0) + 1.0, 0.0, 0.0])
    d2 = float(point_obb_dist2(p, jnp.zeros(3), jnp.ones(3), rot))
    np.testing.assert_allclose(d2, 1.0, rtol=1e-5)


def test_segment_obb_dist2_analytic():
    from ikpso.ops.collision import segment_obb_dist2

    c = jnp.zeros(3)
    h = jnp.ones(3)
    # Segment crossing above the box at z=2: closest approach 1.
    d2 = float(segment_obb_dist2(
        jnp.asarray([-5.0, 0.0, 2.0]), jnp.asarray([5.0, 0.0, 2.0]), c, h, EYE
    ))
    np.testing.assert_allclose(d2, 1.0, rtol=1e-5)
    # Segment that pierces the box: distance 0.
    d2 = float(segment_obb_dist2(
        jnp.asarray([-5.0, 0.0, 0.0]), jnp.asarray([5.0, 0.0, 0.0]), c, h, EYE
    ))
    assert d2 <= 1e-10
    # Endpoint-limited case: both endpoints beyond the box on one side;
    # the minimum is at the near endpoint (2,0,0) -> distance 1.
    d2 = float(segment_obb_dist2(
        jnp.asarray([2.0, 0.0, 0.0]), jnp.asarray([5.0, 0.0, 0.0]), c, h, EYE
    ))
    np.testing.assert_allclose(d2, 1.0, rtol=1e-5)
    # Diagonal segment whose interior minimum is off both endpoints:
    # from (-3, 2, 0) to (3, 2, 0) shifted -> min at x=0, dist 1 to y face.
    d2 = float(segment_obb_dist2(
        jnp.asarray([-3.0, 2.0, 0.0]), jnp.asarray([3.0, 2.0, 0.0]), c, h, EYE
    ))
    np.testing.assert_allclose(d2, 1.0, rtol=1e-5)


def test_segment_obb_dist2_matches_sampled_minimum(rng):
    # Exactness check: dense sampling of d^2(t) can only be >= the
    # bisection answer, and the two agree to f32 precision.
    from ikpso.ops.collision import point_obb_dist2, segment_obb_dist2

    n = 64
    p0 = jnp.asarray(rng.uniform(-4, 4, (n, 3)), jnp.float32)
    p1 = jnp.asarray(rng.uniform(-4, 4, (n, 3)), jnp.float32)
    c = jnp.asarray(rng.uniform(-1, 1, (3,)), jnp.float32)
    h = jnp.asarray(rng.uniform(0.3, 2.0, (3,)), jnp.float32)
    rot = euler_xyz_to_matrix(jnp.asarray(rng.uniform(-np.pi, np.pi, (3,)), jnp.float32))
    got = np.asarray(segment_obb_dist2(p0, p1, c, h, rot))
    ts = jnp.linspace(0.0, 1.0, 4097)[:, None, None]
    pts = p0[None] + ts * (p1 - p0)[None]
    sampled = np.asarray(point_obb_dist2(pts, c, h, rot)).min(axis=0)
    assert (got <= sampled + 1e-5).all()
    np.testing.assert_allclose(got, sampled, atol=2e-4, rtol=1e-3)


def test_chain_collides_capsule_matches_gjk(rng):
    # The closed-form capsule collider vs the generic-support GJK twin
    # on random chains and obstacles: booleans agree away from exact
    # tangency.
    from ikpso.ops.collision import (
        chain_collides_capsule,
        point_obb_dist2,
        segment_obb_dist2,
    )
    from ikpso.ops.gjk import chain_collides_capsule_gjk

    b, k, nobs = 256, 3, 2
    gizmo = 0.2
    pos = jnp.asarray(rng.uniform(-2, 2, (b, k, 3)), jnp.float32)
    ppos = jnp.asarray(rng.uniform(-2, 2, (b, k, 3)), jnp.float32)
    rot = jnp.broadcast_to(EYE, (b, k, 3, 3))
    lengths = jnp.ones((k,), jnp.float32)
    oc = jnp.asarray(rng.uniform(-1.5, 1.5, (nobs, 3)), jnp.float32)
    oh = jnp.asarray(rng.uniform(0.2, 1.0, (nobs, 3)), jnp.float32)
    orot = euler_xyz_to_matrix(
        jnp.asarray(rng.uniform(-np.pi, np.pi, (nobs, 3)), jnp.float32)
    )
    args = (pos, rot, ppos, lengths, oc, oh, orot)
    exact = np.asarray(chain_collides_capsule(*args, gizmo_size=gizmo))
    gjk = np.asarray(chain_collides_capsule_gjk(*args, gizmo_size=gizmo))

    # Margin filter: drop poses within 1e-3 of tangency for any collider.
    nd2 = np.asarray(point_obb_dist2(pos[:, :, None], oc, oh, orot))
    ld2 = np.asarray(segment_obb_dist2(ppos[:, :, None], pos[:, :, None], oc, oh, orot))
    m1 = np.abs(np.sqrt(nd2) - gizmo * 0.5).min(axis=(1, 2))
    m2 = np.abs(np.sqrt(ld2) - gizmo * 0.125).min(axis=(1, 2))
    clear = (np.minimum(m1, m2) > 1e-3)
    assert clear.sum() > 200
    assert exact[clear].any() and not exact[clear].all()
    np.testing.assert_array_equal(exact[clear], gjk[clear])


def test_get_chain_collider_dispatch():
    import pytest

    from ikpso.ops.collision import (
        chain_collides,
        chain_collides_capsule,
        get_chain_collider,
    )
    from ikpso.ops.gjk import chain_collides_capsule_gjk, chain_collides_gjk

    assert get_chain_collider("sat", "box") is chain_collides
    assert get_chain_collider("sat", "capsule") is chain_collides_capsule
    assert get_chain_collider("gjk", "box") is chain_collides_gjk
    assert get_chain_collider("gjk", "capsule") is chain_collides_capsule_gjk
    with pytest.raises(ValueError, match="collision_backend"):
        get_chain_collider("aabb", "box")
    with pytest.raises(ValueError, match="collision_shape"):
        get_chain_collider("sat", "mesh")
