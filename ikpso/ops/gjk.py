"""Branch-free, fixed-iteration GJK boolean intersection (no divergence).

The reference implements collision rejection with an iterative
support-point GJK over a divergent simplex-case branch tree
(reference GJKIntersection.cuh:1-50, simplex.cuh, support.cuh;
implementations kernel.cu:443-1099, up to ``GJK_ITERATIONS = 50``
rounds, ik_constants.h:8). For its only shape pair — box vs box — the
closed-form SAT test in :mod:`ikpso.ops.collision` is exact and is
what the fitness path uses. This module provides the GJK *algorithm*
itself, re-designed for XLA:

  * **No divergent control flow.** Every simplex case (segment,
    triangle, tetrahedron — the reference's ``doSimplex2/3/4``) is
    evaluated as masked selects over a fixed ``(4, 3)`` simplex buffer;
    all lanes run the same straight-line code each round.
  * **Fixed iteration count** (default 50, matching the reference)
    inside a ``lax.fori_loop``; converged lanes freeze their state via
    the ``done`` mask instead of early-returning.
  * **Generic support functions.** ``gjk_intersect`` takes any pair of
    support callables, so convex shapes beyond boxes (spheres,
    capsules for links) plug in without new case logic — something the
    reference's box-only ``supportBox`` (kernel.cu) cannot do.

All entry points broadcast over arbitrary leading batch dimensions, so
one call tests (particles x nodes x colliders) pairs.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
from jax import lax

# Matches the reference's fixed iteration budget (ik_constants.h:8).
GJK_ITERATIONS = 50

# Squared-magnitude epsilon: the reference's IsZERO checks squared
# lengths against FLT_EPSILON (GJKIntersection.cuh COL_EPS; SURVEY.md
# §2.4.4 notes its float3Len is length squared).
_EPS = 1.19209290e-07

SupportFn = Callable[[jnp.ndarray], jnp.ndarray]  # (..., 3) dir -> (..., 3) point


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _cross(a, b):
    return jnp.cross(a, b)


def _triple(a, b, c):
    """(a x b) x c — the reference's repeated vec3Cross composition."""
    return _cross(_cross(a, b), c)


def _where(mask, a, b):
    return jnp.where(mask[..., None], a, b)


def _simplex2(a, b):
    """Segment case (reference doSimplex2).

    Returns (pts (..., 4, 3), n, dir, contact). ``contact`` is True
    where the origin lies ON the segment — the simplex is a subset of
    the Minkowski difference, so that is a definite intersection.
    Simplex ordering: index 0 is always the most recent point A.
    """
    ab = b - a
    ao = -a
    t = _dot(ab, ao)
    toward = t > 0
    d_line = _triple(ab, ao, ab)
    # Collinear test: |ab x ao x ab|^2 = |ab|^4 |ao|^2 sin^2(theta).
    ab2 = _dot(ab, ab)
    ao2 = _dot(ao, ao)
    collinear = _dot(d_line, d_line) <= _EPS * ab2 * ab2 * ao2
    between = toward & (t <= ab2 * (1.0 + _EPS))
    contact = collinear & between
    new_dir = _where(toward, d_line, ao)
    pts = jnp.stack([a, b, b, b], axis=-2)
    n = jnp.where(toward, 2, 1)
    return pts, n, new_dir, contact


def _simplex3(a, b, c):
    """Triangle case (reference doSimplex3). Returns (pts, n, dir, contact)."""
    ab = b - a
    ac = c - a
    ao = -a
    abc = _cross(ab, ac)

    outside_ac = _dot(_cross(abc, ac), ao) > 0
    ac_toward = _dot(ac, ao) > 0
    outside_ab = _dot(_cross(ab, abc), ao) > 0
    above = _dot(abc, ao) > 0

    # Candidate: edge AC region.
    pts_ac, n_ac, dir_ac, contact_ac = _simplex2(a, c)
    # Candidate: edge AB region (the reference's "star case" falls
    # through to the same doSimplex2 on [A, B]).
    pts_ab, n_ab, dir_ab, contact_ab = _simplex2(a, b)
    # Candidate: inside the triangle, above or below its plane. If the
    # origin is exactly IN the plane and inside the edge regions, it is
    # on the triangle -> contact.
    plane_d = _dot(abc, ao)
    abc2 = _dot(abc, abc)
    in_plane = plane_d * plane_d <= _EPS * abc2 * jnp.maximum(_dot(ao, ao), _EPS)
    pts_up = jnp.stack([a, b, c, c], axis=-2)
    pts_dn = jnp.stack([a, c, b, b], axis=-2)
    pts_tri = _where(above[..., None], pts_up, pts_dn)
    dir_tri = _where(above, abc, -abc)
    n_tri = jnp.full(above.shape, 3)

    # Selection tree as nested wheres (mirrors the reference's branch
    # tree, evaluated data-parallel).
    use_ac = outside_ac & ac_toward
    use_ab = (outside_ac & ~ac_toward) | (~outside_ac & outside_ab)
    use_tri = ~use_ac & ~use_ab

    pts = _where(use_ac[..., None], pts_ac, _where(use_ab[..., None], pts_ab, pts_tri))
    n = jnp.where(use_ac, n_ac, jnp.where(use_ab, n_ab, n_tri))
    new_dir = _where(use_ac, dir_ac, _where(use_ab, dir_ab, dir_tri))
    contact = jnp.where(
        use_ac, contact_ac, jnp.where(use_ab, contact_ab, use_tri & in_plane)
    )
    return pts, n, new_dir, contact


def _simplex4(a, b, c, d):
    """Tetrahedron case (reference doSimplex4).

    Returns (pts, n, dir, contains) — ``contains`` True where the
    origin is inside the tetrahedron (intersection found).
    """
    ab = b - a
    ac = c - a
    ad = d - a
    ao = -a
    abc = _cross(ab, ac)
    acd = _cross(ac, ad)
    adb = _cross(ad, ab)

    out_abc = _dot(abc, ao) > 0
    out_acd = _dot(acd, ao) > 0
    out_adb = _dot(adb, ao) > 0
    contains = ~(out_abc | out_acd | out_adb)

    pts_abc, n_abc, dir_abc, c_abc = _simplex3(a, b, c)
    pts_acd, n_acd, dir_acd, c_acd = _simplex3(a, c, d)
    pts_adb, n_adb, dir_adb, c_adb = _simplex3(a, d, b)

    pts = _where(
        out_abc[..., None],
        pts_abc,
        _where(out_acd[..., None], pts_acd, pts_adb),
    )
    n = jnp.where(out_abc, n_abc, jnp.where(out_acd, n_acd, n_adb))
    new_dir = _where(out_abc, dir_abc, _where(out_acd, dir_acd, dir_adb))
    sub_contact = jnp.where(out_abc, c_abc, jnp.where(out_acd, c_acd, c_adb))
    # When contains, pts/n/dir are unused (the caller freezes state).
    return pts, n, new_dir, contains | sub_contact


def gjk_intersect(
    support_a: SupportFn,
    support_b: SupportFn,
    init_dir: jnp.ndarray,
    *,
    iterations: int = GJK_ITERATIONS,
) -> jnp.ndarray:
    """Boolean GJK intersection for convex shapes A and B.

    Args:
      support_a / support_b: map a batched direction ``(..., 3)`` to the
        farthest point of the shape in that direction (world frame).
      init_dir: ``(..., 3)`` initial search direction; conventionally
        ``center_b - center_a`` (the reference seeds with the
        center-difference too).
      iterations: fixed round count (reference GJK_ITERATIONS = 50).

    Returns:
      ``(...,)`` bool — True where the shapes overlap. Lanes that
      exhaust the budget without a separating verdict report True
      (treat-deep-contact-as-hit, matching the reference's use as a
      conservative pose rejector).
    """

    def minkowski_support(d):
        return support_a(d) - support_b(-d)

    batch = init_dir.shape[:-1]
    d0 = jnp.where(
        (_dot(init_dir, init_dir) < _EPS)[..., None],
        jnp.array([1.0, 0.0, 0.0], init_dir.dtype),
        init_dir,
    )
    s0 = minkowski_support(d0)
    pts = jnp.broadcast_to(s0[..., None, :], batch + (4, 3)).astype(init_dir.dtype)
    n = jnp.ones(batch, jnp.int32)
    direction = -s0
    hit = jnp.zeros(batch, bool)
    # Origin is the first support point itself -> contact.
    done = _dot(direction, direction) < _EPS
    hit = hit | done

    def body(_, state):
        pts, n, direction, hit, done = state
        a = minkowski_support(direction)
        # New point did not pass the origin: shapes are separated.
        separated = _dot(a, direction) < 0
        # Stall: the support returned a point already in the simplex —
        # no progress is possible, so the origin is not in the interior
        # (a strictly-contained origin always admits a support point
        # strictly past it). The padding rows of ``pts`` are copies of
        # valid rows by construction, so checking all 4 is safe.
        diff = a[..., None, :] - pts
        scale = 1.0 + _dot(a, a)
        stalled = jnp.any(jnp.sum(diff * diff, axis=-1) < _EPS * scale[..., None], axis=-1)

        b, c, d = pts[..., 0, :], pts[..., 1, :], pts[..., 2, :]
        pts2, n2, dir2, hit2 = _simplex2(a, b)
        pts3, n3, dir3, hit3 = _simplex3(a, b, c)
        pts4, n4, dir4, hit4 = _simplex4(a, b, c, d)

        is2 = n == 1
        is3 = n == 2
        new_pts = _where(is2[..., None], pts2, _where(is3[..., None], pts3, pts4))
        new_n = jnp.where(is2, n2, jnp.where(is3, n3, n4))
        new_dir = _where(is2, dir2, _where(is3, dir3, dir4))
        new_hit = jnp.where(is2, hit2, jnp.where(is3, hit3, hit4))
        # Degenerate next-direction that is NOT a contact (e.g. a
        # collinear simplex with the origin off it): keep the search
        # moving toward the origin; at-origin support point = contact.
        zero_dir = _dot(new_dir, new_dir) < _EPS
        new_dir = _where(zero_dir, -a, new_dir)
        at_origin = zero_dir & (_dot(a, a) < _EPS)

        # Separation verdict wins: when the new support point failed to
        # pass the origin, the simplex-case contact flags were computed
        # from a configuration GJK has already proven disjoint.
        step_hit = ~separated & (new_hit | at_origin)
        step_done = separated | stalled | step_hit

        pts = _where(done[..., None], pts, new_pts)
        n = jnp.where(done, n, new_n)
        direction = _where(done, direction, new_dir)
        hit = jnp.where(done, hit, step_hit)
        done = done | step_done
        return pts, n, direction, hit, done

    pts, n, direction, hit, done = lax.fori_loop(
        0, iterations, body, (pts, n, direction, hit, done)
    )
    # Budget exhausted without a verdict: conservative hit.
    return jnp.where(done, hit, True)


def box_support(center: jnp.ndarray, half: jnp.ndarray, rot: jnp.ndarray) -> SupportFn:
    """Support function of an OBB (reference supportBox, kernel.cu).

    ``center`` (..., 3), ``half`` (..., 3) half extents, ``rot``
    (..., 3, 3) world rotation (columns = local axes). The reference
    rotates the direction into the box frame with the inverse
    quaternion, signs it against the half extents, and rotates back —
    same math, matrix form.
    """

    def support(d):
        local = jnp.einsum(  # R^T d
            "...ji,...j->...i", rot, d, precision="highest"
        )
        corner = jnp.where(local >= 0, half, -half)
        return center + jnp.einsum(
            "...ij,...j->...i", rot, corner, precision="highest"
        )

    return support


def sphere_support(center: jnp.ndarray, radius) -> SupportFn:
    """Support function of a sphere (beyond the reference's box-only set)."""

    def support(d):
        norm = jnp.sqrt(jnp.maximum(_dot(d, d), 1e-30))[..., None]
        return center + radius * d / norm

    return support


def segment_support(p0: jnp.ndarray, p1: jnp.ndarray) -> SupportFn:
    """Support function of a line segment (capsule core for links)."""

    def support(d):
        pick1 = (_dot(p1 - p0, d) > 0)[..., None]
        return jnp.where(pick1, p1, p0)

    return support


def capsule_support(p0: jnp.ndarray, p1: jnp.ndarray, radius) -> SupportFn:
    """Capsule = segment Minkowski-sum sphere: exact rounded link collider."""
    seg = segment_support(p0, p1)

    def support(d):
        norm = jnp.sqrt(jnp.maximum(_dot(d, d), 1e-30))[..., None]
        return seg(d) + radius * d / norm

    return support


def chain_collides_gjk(
    positions: jnp.ndarray,
    rotations: jnp.ndarray,
    parent_positions: jnp.ndarray,
    lengths: jnp.ndarray,
    obstacle_center: jnp.ndarray,
    obstacle_half: jnp.ndarray,
    obstacle_rot: jnp.ndarray,
    gizmo_size: float = 0.2,
    *,
    iterations: int = GJK_ITERATIONS,
) -> jnp.ndarray:
    """GJK twin of :func:`ikpso.ops.collision.chain_collides`.

    Same collider construction as the reference (kernel.cu:104-136):
    a ``gizmo_size`` cube at each non-root node plus a
    ``length x (gizmo_size/4)^2`` box at each link midpoint, both
    oriented by the node's world rotation, tested against every scene
    box — but with the iterative GJK instead of closed-form SAT.
    Selected via ``FitnessConfig.collision_backend = "gjk"``.
    """
    if obstacle_center.shape[0] == 0:
        return jnp.zeros(positions.shape[:-2], dtype=bool)

    node_center = positions[..., :, None, :]
    node_rot = rotations[..., :, None, :, :]
    node_half = jnp.full((3,), gizmo_size * 0.5, dtype=positions.dtype)

    link_center = ((positions + parent_positions) * 0.5)[..., :, None, :]
    link_half = jnp.stack(
        [
            lengths * 0.5,
            jnp.full_like(lengths, gizmo_size * 0.25 * 0.5),
            jnp.full_like(lengths, gizmo_size * 0.25 * 0.5),
        ],
        axis=-1,
    )[..., :, None, :]

    node_hit = gjk_box_box(
        node_center, node_half, node_rot,
        obstacle_center, obstacle_half, obstacle_rot,
        iterations=iterations,
    )
    link_hit = gjk_box_box(
        link_center, link_half, node_rot,
        obstacle_center, obstacle_half, obstacle_rot,
        iterations=iterations,
    )
    return jnp.any(node_hit | link_hit, axis=(-2, -1))


def chain_collides_capsule_gjk(
    positions: jnp.ndarray,
    rotations: jnp.ndarray,
    parent_positions: jnp.ndarray,
    lengths: jnp.ndarray,
    obstacle_center: jnp.ndarray,
    obstacle_half: jnp.ndarray,
    obstacle_rot: jnp.ndarray,
    gizmo_size: float = 0.2,
    *,
    iterations: int = GJK_ITERATIONS,
) -> jnp.ndarray:
    """GJK twin of :func:`ikpso.ops.collision.chain_collides_capsule`.

    Same rounded colliders — node spheres (radius ``gizmo_size/2``)
    and parent->node link capsules (radius ``gizmo_size/8``) — tested
    against every scene box through the generic-support GJK
    (:func:`sphere_support` / :func:`capsule_support`), the shape
    generality the reference's box-only ``supportBox`` cannot express.
    ``rotations``/``lengths`` are accepted for signature parity and
    ignored (rounded colliders are rotation-free).
    """
    del rotations, lengths
    if obstacle_center.shape[0] == 0:
        return jnp.zeros(positions.shape[:-2], dtype=bool)

    p = positions[..., :, None, :]
    pp = parent_positions[..., :, None, :]
    obox = box_support(obstacle_center, obstacle_half, obstacle_rot)
    node_hit = gjk_intersect(
        sphere_support(p, gizmo_size * 0.5),
        obox,
        obstacle_center - p,
        iterations=iterations,
    )
    mid = (p + pp) * 0.5
    link_hit = gjk_intersect(
        capsule_support(pp, p, gizmo_size * 0.125),
        obox,
        obstacle_center - mid,
        iterations=iterations,
    )
    return jnp.any(node_hit | link_hit, axis=(-2, -1))


def gjk_box_box(
    center_a: jnp.ndarray,
    half_a: jnp.ndarray,
    rot_a: jnp.ndarray,
    center_b: jnp.ndarray,
    half_b: jnp.ndarray,
    rot_b: jnp.ndarray,
    *,
    iterations: int = GJK_ITERATIONS,
) -> jnp.ndarray:
    """Drop-in GJK twin of :func:`ikpso.ops.collision.obb_obb_intersect`."""
    return gjk_intersect(
        box_support(center_a, half_a, rot_a),
        box_support(center_b, half_b, rot_b),
        center_b - center_a,
        iterations=iterations,
    )
