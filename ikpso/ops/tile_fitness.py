"""FK + fitness on particle vectors: the math the PSO megakernel runs.

Every function here is elementwise over a "tile" of particles (any
array shape) and reads its constants through callables, so the same
code runs inside the Pallas megakernel (``ikpso.pso.fused``, where a
tile is one swarm's ``(P,)`` particle vector) and in plain jnp (the
op counter in ``ikpso.utils.flops`` traces it). The reference's hot op
is ``calculateDistance`` — a per-particle FK rollout plus cost
accumulation (SURVEY.md §3.4-§3.5); here the tree walk is unrolled at
trace time (static parent indices) into straight-line code: sin/cos
of the angles, ~9 multiply-adds per 3x3 compose, and the cost terms.

Per-swarm constants (root rotation, origin, anchors, targets) are
packed into one vector per swarm; per-chain constants (term weights,
lengths, effector weights, obstacle boxes) into another
(:class:`MetaLayout`). Box-obstacle rejection (SAT, reference
kernel.cu:104-136) and the capsule distances are closed-form and
branch-free.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso.ops.fitness import COLLISION_PENALTY, FitnessConfig
from ikpso.ops.rotations import euler_xyz_to_matrix


# Polynomial sincos: minimax-fit odd/even polynomials after a one-step
# range reduction to [-pi, pi]. Error over [-4pi, 4pi]: 3.1e-7 (sin) /
# 3.6e-8 (cos) is the polynomial FIT error in exact arithmetic; the f32
# end-to-end max error is 1.2e-6 / 5.3e-7, dominated by the range
# reduction's round-off — micrometre scale at this reach (validated
# against the jnp path in tests and the float64 native oracle).
# ``FitnessConfig.trig_impl`` picks this or the stock sin/cos.
_INV_2PI = np.float32(1.0 / (2.0 * np.pi))
_2PI = np.float32(2.0 * np.pi)
_SIN_C = tuple(np.float32(v) for v in (
    9.9999970703e-01, -1.6666577215e-01, 8.3325581177e-03,
    -1.9812575520e-04, 2.7040512127e-06, -2.0534244526e-08,
))
_COS_C = tuple(np.float32(v) for v in (
    9.9999999228e-01, -4.9999991772e-01, 4.1666524360e-02,
    -1.3887970390e-03, 2.4773423752e-05, -2.7113368761e-07,
    1.7369116668e-09,
))


def _sincos(x, trig_impl: str = "poly"):
    """(sin x, cos x) — polynomial by default, stock lowering optionally."""
    if trig_impl == "exact":
        return jnp.sin(x), jnp.cos(x)
    # floor(. + 0.5), not round(): the Triton lowering has no round.
    r = x - jnp.floor(x * _INV_2PI + 0.5) * _2PI
    r2 = r * r
    s = _SIN_C[-1]
    for coef in _SIN_C[-2::-1]:
        s = s * r2 + coef
    c = _COS_C[-1]
    for coef in _COS_C[-2::-1]:
        c = c * r2 + coef
    return s * r, c


def _rot_xyz(ax, ay, az, trig_impl: str = "poly"):
    """Rx@Ry@Rz on elementwise tiles -> 9 tile-shaped entries."""
    sx, cx = _sincos(ax, trig_impl)
    sy, cy = _sincos(ay, trig_impl)
    sz, cz = _sincos(az, trig_impl)
    return (
        cy * cz, -cy * sz, sy,
        cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
        sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy,
    )


def _mat_mul(a, b):
    """3x3 compose of two 9-tuples of tiles (row-major)."""
    return (
        a[0] * b[0] + a[1] * b[3] + a[2] * b[6],
        a[0] * b[1] + a[1] * b[4] + a[2] * b[7],
        a[0] * b[2] + a[1] * b[5] + a[2] * b[8],
        a[3] * b[0] + a[4] * b[3] + a[5] * b[6],
        a[3] * b[1] + a[4] * b[4] + a[5] * b[7],
        a[3] * b[2] + a[4] * b[5] + a[5] * b[8],
        a[6] * b[0] + a[7] * b[3] + a[8] * b[6],
        a[6] * b[1] + a[7] * b[4] + a[8] * b[7],
        a[6] * b[2] + a[7] * b[5] + a[8] * b[8],
    )


def _sat_obb(px, py, pz, rot, half, oc, oh, orot):
    """SAT intersect: per-particle box (center p, rotation ``rot``
    9-tuple of tiles, half extents ``half`` 3-tuple of scalars) vs one
    static box (center ``oc``, half ``oh``, rotation ``orot`` — scalars).

    Returns a boolean tile. Mirrors ops.collision.obb_obb_intersect
    with A = the particle box, B = the obstacle.
    """
    eps = 1e-6
    # C = Ra^T Rb  (Ra rows are tiles, Rb is scalar 3x3)
    c = [None] * 9
    for i in range(3):
        for j in range(3):
            # column i of Ra dot column j of Rb
            c[i * 3 + j] = (
                rot[i] * orot[0][j] + rot[3 + i] * orot[1][j] + rot[6 + i] * orot[2][j]
            )
    # T = Ra^T (ob - pa)
    dx, dy, dz = oc[0] - px, oc[1] - py, oc[2] - pz
    t = (
        rot[0] * dx + rot[3] * dy + rot[6] * dz,
        rot[1] * dx + rot[4] * dy + rot[7] * dz,
        rot[2] * dx + rot[5] * dy + rot[8] * dz,
    )
    ac = [jnp.abs(v) + eps for v in c]
    a = half
    b = oh
    sep = jnp.zeros_like(px, dtype=bool)
    for i in range(3):
        rb = b[0] * ac[i * 3] + b[1] * ac[i * 3 + 1] + b[2] * ac[i * 3 + 2]
        sep |= jnp.abs(t[i]) > a[i] + rb
    for j in range(3):
        ra = a[0] * ac[j] + a[1] * ac[3 + j] + a[2] * ac[6 + j]
        proj = t[0] * c[j] + t[1] * c[3 + j] + t[2] * c[6 + j]
        sep |= jnp.abs(proj) > ra + b[j]
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            ra = a[i1] * ac[i2 * 3 + j] + a[i2] * ac[i1 * 3 + j]
            rb = b[j1] * ac[i * 3 + j2] + b[j2] * ac[i * 3 + j1]
            lhs = jnp.abs(t[i2] * c[i1 * 3 + j] - t[i1] * c[i2 * 3 + j])
            sep |= lhs > ra + rb
    return ~sep


def _point_obb_dist2(px, py, pz, oc, oh, orot):
    """Exact squared point->OBB distance on tiles (sphere-vs-box core).

    Mirrors ops.collision.point_obb_dist2: clamp the point, in the box
    frame, to the box. ``oc``/``oh`` scalar 3-tuples, ``orot`` scalar
    3x3 (rows r, cols c); q_i = column i of R dotted with (p - c).
    """
    dx, dy, dz = px - oc[0], py - oc[1], pz - oc[2]
    d2 = None
    for i in range(3):
        qi = orot[0][i] * dx + orot[1][i] * dy + orot[2][i] * dz
        di = jnp.maximum(jnp.abs(qi) - oh[i], 0.0)
        d2 = di * di if d2 is None else d2 + di * di
    return d2


def _seg_obb_dist2(p0, p1, oc, oh, orot, iterations=24):
    """Exact squared segment->OBB distance on tiles (capsule-vs-box core).

    Mirrors ops.collision.segment_obb_dist2: branch-free bisection on
    the convex distance's monotone derivative, statically unrolled —
    every lane runs the same straight-line VPU code.
    """
    q0 = []
    q1 = []
    for i in range(3):
        q0.append(
            orot[0][i] * (p0[0] - oc[0])
            + orot[1][i] * (p0[1] - oc[1])
            + orot[2][i] * (p0[2] - oc[2])
        )
        q1.append(
            orot[0][i] * (p1[0] - oc[0])
            + orot[1][i] * (p1[1] - oc[1])
            + orot[2][i] * (p1[2] - oc[2])
        )
    b = [q1[i] - q0[i] for i in range(3)]

    def g(t):
        acc = None
        for i in range(3):
            qi = q0[i] + t * b[i]
            si = jnp.sign(qi) * jnp.maximum(jnp.abs(qi) - oh[i], 0.0)
            acc = si * b[i] if acc is None else acc + si * b[i]
        return acc

    lo = jnp.zeros_like(p0[0])
    hi = jnp.ones_like(p0[0])
    for _ in range(iterations):
        tm = 0.5 * (lo + hi)
        pred = g(tm) > 0
        hi = jnp.where(pred, tm, hi)
        lo = jnp.where(pred, lo, tm)
    t = 0.5 * (lo + hi)
    d2 = None
    for i in range(3):
        qi = q0[i] + t * b[i]
        di = jnp.maximum(jnp.abs(qi) - oh[i], 0.0)
        d2 = di * di if d2 is None else d2 + di * di
    return d2


class MetaLayout:
    """Offsets into the packed per-chain (meta) and per-swarm vectors.

    meta:  [aw, dw, len_1..len_{N-1}, w_e.., (center3 half3 rot9) x C]
    swarm: [root R (9), origin (3), anchor angles (D), targets (3E),
            anchor positions (3(N-1))]
    """

    def __init__(self, spec: ChainSpec, num_obstacles: int,
                 use_orientation: bool = False):
        d = spec.dof
        e_count = len(spec.effector_idx)
        num_joints = spec.num_nodes - 1
        self.OFF_LEN = 2
        self.OFF_EW = 2 + num_joints
        self.OFF_OBS = self.OFF_EW + e_count
        # Orientation weight rides at the END of meta so the offsets
        # above stay stable whether or not it is present.
        self.OFF_OW = self.OFF_OBS + 15 * num_obstacles
        self.meta_size = self.OFF_OW + (1 if use_orientation else 0)
        self.OFF_ROOT = 0
        self.OFF_ORIGIN = 9
        self.OFF_ANCHOR = 12
        self.OFF_TGT = 12 + d
        self.OFF_APOS = 12 + d + 3 * e_count
        # Optional per-effector target rotation matrices (9E), appended.
        self.OFF_TROT = self.OFF_APOS + 3 * num_joints
        self.swarm_size = self.OFF_TROT + (9 * e_count if use_orientation else 0)


def fk_fitness_tile(
    spec: ChainSpec,
    get_x,
    meta,
    sw,
    tile_shape,
    *,
    num_obstacles: int,
    use_distance_term: bool,
    gizmo_size: float,
    use_orientation: bool = False,
    collision_shape: str = "box",
    trig_impl: str = "poly",
):
    """FK rollout + cost for one particle tile (shared kernel body).

    ``get_x(d)`` returns the tile of angles for DOF ``d``; ``meta(i)`` /
    ``sw(i)`` read scalars from the packed per-chain / per-swarm
    constant vectors (layout: :class:`MetaLayout`). ``tile_shape`` is
    the shape of one angle tile.
    """
    n = spec.num_nodes
    num_joints = n - 1
    eff_set = {e: i for i, e in enumerate(spec.effector_idx)}
    lay = MetaLayout(spec, num_obstacles, use_orientation)

    aw = meta(0)
    dw = meta(1)
    root_r = tuple(sw(lay.OFF_ROOT + i) for i in range(9))
    root_p = tuple(sw(lay.OFF_ORIGIN + i) for i in range(3))

    rot_diff = jnp.zeros(tile_shape, jnp.float32)
    pos_diff = jnp.zeros(tile_shape, jnp.float32)
    cost = jnp.zeros(tile_shape, jnp.float32)
    hit = jnp.zeros(tile_shape, jnp.bool_)

    if num_obstacles:
        obstacles = []
        for o in range(num_obstacles):
            base = lay.OFF_OBS + o * 15
            oc = tuple(meta(base + i) for i in range(3))
            oh = tuple(meta(base + 3 + i) for i in range(3))
            orot = tuple(
                tuple(meta(base + 6 + r * 3 + cc) for cc in range(3))
                for r in range(3)
            )
            obstacles.append((oc, oh, orot))
        gz = gizmo_size * 0.5
        node_half = (gz, gz, gz)

    # World rotation/position per node; parents precede children.
    rots = {0: root_r}
    poss = {0: root_p}
    for k in range(1, n):
        d0 = 3 * (k - 1)
        ax = get_x(d0)
        ay = get_x(d0 + 1)
        az = get_x(d0 + 2)
        local = _rot_xyz(ax, ay, az, trig_impl)
        parent = spec.parent[k]
        pr = rots[parent]
        rk = _mat_mul(pr, local)
        length = meta(lay.OFF_LEN + (k - 1))
        pp = poss[parent]
        pk = (
            pp[0] + length * rk[0],
            pp[1] + length * rk[3],
            pp[2] + length * rk[6],
        )
        rots[k] = rk
        poss[k] = pk

        # Angular locality (reference kernel.cu:78-84).
        da = ax - sw(lay.OFF_ANCHOR + d0)
        db = ay - sw(lay.OFF_ANCHOR + d0 + 1)
        dc = az - sw(lay.OFF_ANCHOR + d0 + 2)
        rot_diff += da * da + db * db + dc * dc

        if use_distance_term:
            ox = pk[0] - sw(lay.OFF_APOS + d0)
            oy = pk[1] - sw(lay.OFF_APOS + d0 + 1)
            oz = pk[2] - sw(lay.OFF_APOS + d0 + 2)
            pos_diff += ox * ox + oy * oy + oz * oz

        if num_obstacles:
            if collision_shape == "capsule":
                # Node sphere + parent->node link capsule vs every
                # obstacle: exact closed-form point/segment OBB
                # distances (ops.collision capsule shape).
                node_r2 = np.float32((gizmo_size * 0.5) ** 2)
                link_r2 = np.float32((gizmo_size * 0.125) ** 2)
                for oc, oh, orot in obstacles:
                    hit |= (
                        _point_obb_dist2(pk[0], pk[1], pk[2], oc, oh, orot)
                        <= node_r2
                    )
                    hit |= _seg_obb_dist2(pp, pk, oc, oh, orot) <= link_r2
            else:
                # Node gizmo cube + link box vs every obstacle
                # (reference kernel.cu:104-136).
                mid = (
                    (pk[0] + pp[0]) * 0.5,
                    (pk[1] + pp[1]) * 0.5,
                    (pk[2] + pp[2]) * 0.5,
                )
                link_half = (
                    # length is a traced scalar; fine inside the tuple
                    length * 0.5,
                    gizmo_size * 0.25 * 0.5,
                    gizmo_size * 0.25 * 0.5,
                )
                for oc, oh, orot in obstacles:
                    hit |= _sat_obb(pk[0], pk[1], pk[2], rk, node_half, oc, oh, orot)
                    hit |= _sat_obb(mid[0], mid[1], mid[2], rk, link_half, oc, oh, orot)

        if k in eff_set:
            e = eff_set[k]
            w = meta(lay.OFF_EW + e)
            tx = sw(lay.OFF_TGT + 3 * e)
            ty = sw(lay.OFF_TGT + 3 * e + 1)
            tz = sw(lay.OFF_TGT + 3 * e + 2)
            ex = pk[0] - tx
            ey = pk[1] - ty
            ez = pk[2] - tz
            cost += w * (ex * ex + ey * ey + ez * ez)

            if use_orientation:
                # Squared Frobenius distance between the effector's
                # world rotation and its target rotation (matches
                # ops.fitness orientation term).
                ow = meta(lay.OFF_OW)
                fro = jnp.zeros(tile_shape, jnp.float32)
                for i in range(9):
                    dr = rk[i] - sw(lay.OFF_TROT + 9 * e + i)
                    fro += dr * dr
                cost += ow * w * fro

    total = cost + (aw / num_joints) * rot_diff
    if use_distance_term:
        total = total + (dw / num_joints) * pos_diff
    if num_obstacles:
        total = jnp.where(hit, COLLISION_PENALTY, total)
    return total


def pack_meta(
    spec: ChainSpec,
    fit: FitnessConfig,
    obstacles: Optional[Obstacles],
    use_orientation: bool = False,
) -> np.ndarray:
    """(M,) per-chain constant vector (layout: :class:`MetaLayout`).

    Chain, weights and scene are fixed when a solver is built, so the
    vector is concrete numpy: the megakernel bakes each entry into its
    code as a constant.
    """
    parts = [
        [float(np.asarray(fit.angle_weight)), float(np.asarray(fit.distance_weight))],
        np.asarray(spec.length)[1:],
        np.asarray(spec.effector_weight)[np.array(spec.effector_idx)],
    ]
    if obstacles is not None and obstacles.count > 0:
        per = np.concatenate(
            [
                np.asarray(obstacles.center),
                np.asarray(obstacles.half_extent),
                np.asarray(obstacles.rot).reshape(-1, 9),
            ],
            axis=-1,
        )  # (C, 15)
        parts.append(per.reshape(-1))
    if use_orientation:
        parts.append([float(np.asarray(fit.orientation_weight))])
    return np.concatenate([np.asarray(p, np.float32) for p in parts])


def pack_swarm(
    spec: ChainSpec, problem: IKProblem, anchor_angles, anchor_positions,
    use_orientation: bool = False,
) -> jnp.ndarray:
    """(S, K) per-swarm constant vector (layout: :class:`MetaLayout`).

    ``anchor_positions`` may be the tensor ``(S, N, 3)`` FK or the
    already-flat ``(S, 3*(N-1))`` non-root block
    (pso.polish_soa.anchor_positions_flat — the padding-free path).
    """
    root_r = euler_xyz_to_matrix(problem.pose[..., 0, :])  # (S, 3, 3)
    s = root_r.shape[0]
    ap = (
        anchor_positions[:, 1:].reshape(s, -1)
        if anchor_positions.ndim == 3
        else anchor_positions
    )
    parts = [
        root_r.reshape(s, 9),
        jnp.broadcast_to(problem.origin, (s, 3)),
        anchor_angles,
        problem.targets.reshape(s, -1),
        ap,
    ]
    if use_orientation:
        if problem.target_rot is None:
            raise ValueError("use_orientation requires problem.target_rot")
        parts.append(euler_xyz_to_matrix(problem.target_rot).reshape(s, -1))
    return jnp.concatenate(parts, axis=-1).astype(jnp.float32)
