"""Structure-of-arrays LM polish core: one ``(S,)`` array per quantity.

The general polish path (pso/polish.py) carries ``(S, N, 3)`` /
``(S, M, M)`` tensors with tiny minor dimensions, where every
``a[..., i, j]`` slice is a strided access.

This module unrolls the same math over the STATIC topology (node
count, effector count, DOF) so that every intermediate is a single
``(S,)`` array: every op is a full-width elementwise op over the
swarms, and there are no strided slices. The FK composes rotation
components elementwise (exact f32, like the megakernel — no reduced
precision matrix unit), so results match pso/polish.py to float
rounding.

Covers the full residual family (any effector count, ancestry-masked
trees): position rows, optional world rotation-vector orientation
rows, and optional Tikhonov locality rows; locality (or rows > DOF)
switches the normal equations from the dual (M, M) to the primal
(D, D) form. ``pso.polish.polish_angles`` dispatches every polish to
this core; its tensor path remains the test oracle.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp

from ikpso.models.chain import ChainSpec
from ikpso.ops.jacobian import ancestry_mask

# NOTE: ChainSpec's array leaves (lengths, limits, weights) are traced
# inside jit — only the topology (parent/effector index tuples) is
# static. Everything below indexes them into traced scalars once and
# unrolls over the static topology.


def _euler_rows(ax, ay, az):
    """Rotation-matrix components of Rx@Ry@Rz from (S,) angle rows.

    Same closed form as ops/rotations.euler_xyz_to_matrix, kept in
    scalar rows; returns a 9-list [r00, r01, ..., r22].
    """
    cx, sx = jnp.cos(ax), jnp.sin(ax)
    cy, sy = jnp.cos(ay), jnp.sin(ay)
    cz, sz = jnp.cos(az), jnp.sin(az)
    return [
        cy * cz, -cy * sz, sy,
        cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
        sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy,
    ], (cx, sx)


def _matmul3_rows(a: Sequence, b: Sequence) -> List:
    """Row-major 9-component product of two row-list rotations."""
    out = []
    for i in range(3):
        for j in range(3):
            out.append(
                a[3 * i + 0] * b[0 + j]
                + a[3 * i + 1] * b[3 + j]
                + a[3 * i + 2] * b[6 + j]
            )
    return out


def _fk_rows(spec: ChainSpec, ang_rows, root_rows, origin_rows):
    """Unrolled FK over (S,) rows.

    Args:
      ang_rows: D rows (node-major, 3 per non-root node).
      root_rows: 3 rows — origin Euler rotation.
      origin_rows: 3 rows — origin translation.

    Returns:
      (pos, rot, cxsx): per-node [px, py, pz] rows, 9-component world
      rotation rows, and per-node (cos, sin) of the local X angle
      (needed for the Jacobian's Y-axis).
    """
    n = spec.num_nodes
    rot0, cs0 = _euler_rows(*root_rows)
    pos = [list(origin_rows)]
    rot = [rot0]
    cxsx = [cs0]
    for k in range(1, n):
        p = spec.parent[k]
        local, cs = _euler_rows(
            ang_rows[3 * (k - 1)], ang_rows[3 * (k - 1) + 1],
            ang_rows[3 * (k - 1) + 2],
        )
        rk = _matmul3_rows(rot[p], local)
        lk = spec.length[k]
        pk = [
            pos[p][0] + lk * rk[0],
            pos[p][1] + lk * rk[3],
            pos[p][2] + lk * rk[6],
        ]
        pos.append(pk)
        rot.append(rk)
        cxsx.append(cs)
    return pos, rot, cxsx


def _residual_rows(spec: ChainSpec, pos, targets_rows, w_sqrt):
    """M = E*3 weighted position-residual rows from FK node positions."""
    rows = []
    for ei, node in enumerate(spec.effector_idx):
        for c in range(3):
            rows.append((pos[node][c] - targets_rows[ei][c]) * w_sqrt[ei])
    return rows


def _err2_rows(rows) -> jnp.ndarray:
    s = rows[0] * rows[0]
    for r in rows[1:]:
        s = s + r * r
    return s


def _chol_solve_rows(a, b):
    """SPD solve on an MxM matrix of (S,) rows (unrolled Cholesky)."""
    m = len(b)
    low = [[None] * m for _ in range(m)]
    for i in range(m):
        for jc in range(i + 1):
            s = a[i][jc]
            for k in range(jc):
                s = s - low[i][k] * low[jc][k]
            if i == jc:
                low[i][jc] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                low[i][jc] = s / low[jc][jc]
    y = [None] * m
    for i in range(m):
        s = b[i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return x


def polish_angles_soa(
    spec: ChainSpec,
    problem,
    angles: jnp.ndarray,
    *,
    steps: int,
    init_damping: float,
    locality_weight: float = 0.0,
    use_orientation: bool = False,
    orientation_weight: float = 1.0,
) -> jnp.ndarray:
    """SoA-unrolled LM polish (position / orientation / locality rows).

    Semantics match ``polish_angles(soa=False)`` to float rounding:
    same damping race, same gradient-projection active set, same
    accept gate. The step body is pure (S,)-row arithmetic;
    ``lax.scan`` carries ``(x, lam)`` across steps so the (large,
    fully-unrolled) body is traced and compiled once regardless of the
    step count.

    Without locality and with few residual rows (M <= D) the normal
    equations are solved in the dual (M,M) form. With
    ``locality_weight`` (Tikhonov rows make the system full-rank in
    D-space) or M > D, the primal (D,D) form is used: ``A = J^T J +
    w·keep + lam``, ``g = J^T r + w (x - anchor)`` — matching the
    general path's ``m > d`` branch (pso/polish.py) including its use
    of the unprojected gradient (pinned coordinates are restored by
    the clip). ``use_orientation`` adds the three world rotation-vector
    rows per effector (``0.5 vee(R Rt^T)``, Jacobian = world joint
    axes — ops/jacobian.py orientation rows) in scalar-row form.
    """
    d = spec.dof
    eff = list(spec.effector_idx)
    e_count = len(eff)
    m = 3 * e_count * (2 if use_orientation else 1)
    lo_flat = spec.min_rotation[1:].reshape(-1)
    hi_flat = spec.max_rotation[1:].reshape(-1)
    lo = [lo_flat[k] for k in range(d)]
    hi = [hi_flat[k] for k in range(d)]
    free_dim = [hi[k] > lo[k] for k in range(d)]  # traced bool scalars
    mask = ancestry_mask(spec)  # (E, N-1) numpy — static topology
    w_sqrt = [
        jnp.sqrt(spec.effector_weight[node]) for node in eff
    ]

    # One-time layout change: rows are contiguous (S,) slices.
    xT = jnp.moveaxis(angles, -1, 0)  # (D, S)
    root_rows = [problem.pose[..., 0, c] for c in range(3)]
    origin_rows = [problem.origin[..., c] for c in range(3)]
    targets_rows = [
        [problem.targets[..., ei, c] for c in range(3)]
        for ei in range(e_count)
    ]

    s_shape = xT[0].shape
    lam0 = jnp.full(s_shape, init_damping, angles.dtype)
    lw = float(locality_weight)
    anchor = [
        problem.pose[..., 1 + k // 3, k % 3] for k in range(d)
    ] if lw else None
    wo = float(orientation_weight) ** 0.5 if use_orientation else 0.0
    if use_orientation:
        # Target rotations as 9-component rows (constant across steps).
        rt_rows = [
            _euler_rows(
                problem.target_rot[..., ei, 0],
                problem.target_rot[..., ei, 1],
                problem.target_rot[..., ei, 2],
            )[0]
            for ei in range(e_count)
        ]

    def residual_rows_of(pos, rot):
        rows = _residual_rows(spec, pos, targets_rows, w_sqrt)
        if use_orientation:
            for ei, node in enumerate(eff):
                re, rtm = rot[node], rt_rows[ei]
                # m = R_fk @ Rt^T, row-major 9-lists:
                # m[i][j] = sum_k re[3i+k] * rtm[3j+k].
                mm = [
                    [
                        re[3 * i + 0] * rtm[3 * j + 0]
                        + re[3 * i + 1] * rtm[3 * j + 1]
                        + re[3 * i + 2] * rtm[3 * j + 2]
                        for j in range(3)
                    ]
                    for i in range(3)
                ]
                rows.append(wo * 0.5 * (mm[2][1] - mm[1][2]))
                rows.append(wo * 0.5 * (mm[0][2] - mm[2][0]))
                rows.append(wo * 0.5 * (mm[1][0] - mm[0][1]))
        return rows

    def residual_at(x_rows):
        pos, rot, _ = _fk_rows(spec, x_rows, root_rows, origin_rows)
        return residual_rows_of(pos, rot)

    def total_err2(x_rows, r_rows):
        s = _err2_rows(r_rows)
        if lw:
            for k in range(d):
                dk = x_rows[k] - anchor[k]
                s = s + lw * dk * dk
        return s

    def lm_step(carry, _):
        xs, lam = carry
        x = [xs[k] for k in range(d)]
        pos, rot, cxsx = _fk_rows(spec, x, root_rows, origin_rows)
        r = residual_rows_of(pos, rot)

        # Jacobian rows J[i][dof]: world joint axes x pivot offsets
        # (ops/jacobian.py in scalar rows).
        jac = [[None] * d for _ in range(m)]
        for k in range(1, spec.num_nodes):
            p = spec.parent[k]
            rp = rot[p]
            cx, sx = cxsx[k]
            axes = [
                (rp[0], rp[3], rp[6]),  # theta_x: parent col 0
                (
                    cx * rp[1] + sx * rp[2],
                    cx * rp[4] + sx * rp[5],
                    cx * rp[7] + sx * rp[8],
                ),
                (rot[k][2], rot[k][5], rot[k][8]),  # theta_z: own col 2
            ]
            for ei, node in enumerate(eff):
                if mask[ei, k - 1] == 0.0:
                    continue
                dx0 = pos[node][0] - pos[p][0]
                dy0 = pos[node][1] - pos[p][1]
                dz0 = pos[node][2] - pos[p][2]
                for a in range(3):
                    wx, wy, wz = axes[a]
                    col = 3 * (k - 1) + a
                    cxv = wy * dz0 - wz * dy0
                    cyv = wz * dx0 - wx * dz0
                    czv = wx * dy0 - wy * dx0
                    we = w_sqrt[ei]
                    jac[3 * ei + 0][col] = we * cxv
                    jac[3 * ei + 1][col] = we * cyv
                    jac[3 * ei + 2][col] = we * czv
                    if use_orientation:
                        # Rotation-vector rows: J = world joint axis.
                        base_row = 3 * e_count + 3 * ei
                        jac[base_row + 0][col] = wo * wx
                        jac[base_row + 1][col] = wo * wy
                        jac[base_row + 2][col] = wo * wz

        zero = jnp.zeros(s_shape, angles.dtype)
        for i in range(m):
            for kcol in range(d):
                if jac[i][kcol] is None:
                    jac[i][kcol] = zero

        # Gradient-projection active set: zero columns of locked dims
        # (min == max) and of coords pinned at a bound being pushed
        # outward. Limits are traced, so masking is arithmetic. The
        # (unprojected) gradient includes the locality pull.
        g0 = [None] * d
        keep_row = [None] * d
        for kcol in range(d):
            g = jac[0][kcol] * r[0]
            for i in range(1, m):
                g = g + jac[i][kcol] * r[i]
            if lw:
                g = g + lw * (x[kcol] - anchor[kcol])
            g0[kcol] = g
            pinned = ((x[kcol] <= lo[kcol] + 1e-7) & (g > 0)) | (
                (x[kcol] >= hi[kcol] - 1e-7) & (g < 0)
            )
            keep = (~pinned & free_dim[kcol]).astype(angles.dtype)
            keep_row[kcol] = keep
            for i in range(m):
                jac[i][kcol] = jac[i][kcol] * keep

        primal = bool(lw) or m > d
        if primal:
            # Primal (D, D) normal matrix: J^T J + w on kept diagonals.
            h = [[None] * d for _ in range(d)]
            for kcol in range(d):
                for lcol in range(kcol + 1):
                    s = jac[0][kcol] * jac[0][lcol]
                    for i in range(1, m):
                        s = s + jac[i][kcol] * jac[i][lcol]
                    if kcol == lcol and lw:
                        s = s + lw * keep_row[kcol]
                    h[kcol][lcol] = s
                    h[lcol][kcol] = s
        else:
            # Dual: J J^T entries (symmetric M x M of rows).
            jjt = [[None] * m for _ in range(m)]
            for i in range(m):
                for jr in range(i + 1):
                    s = jac[i][0] * jac[jr][0]
                    for kcol in range(1, d):
                        s = s + jac[i][kcol] * jac[jr][kcol]
                    jjt[i][jr] = s
                    jjt[jr][i] = s

        err_cur = total_err2(x, r)

        # Damping race: 0.1/1/10x lambda candidates, keep the best.
        cand_x = []
        cand_e = []
        for mult in (0.1, 1.0, 10.0):
            lam_k = lam * mult
            xn = []
            if primal:
                a = [
                    [
                        h[kcol][lcol] + lam_k if kcol == lcol
                        else h[kcol][lcol]
                        for lcol in range(d)
                    ]
                    for kcol in range(d)
                ]
                dx = _chol_solve_rows(a, g0)
                for kcol in range(d):
                    xn.append(
                        jnp.clip(x[kcol] - dx[kcol], lo[kcol], hi[kcol])
                    )
            else:
                a = [
                    [
                        jjt[i][jr] + lam_k if i == jr else jjt[i][jr]
                        for jr in range(m)
                    ]
                    for i in range(m)
                ]
                y = _chol_solve_rows(a, r)
                for kcol in range(d):
                    dxk = jac[0][kcol] * y[0]
                    for i in range(1, m):
                        dxk = dxk + jac[i][kcol] * y[i]
                    xn.append(
                        jnp.clip(x[kcol] - dxk, lo[kcol], hi[kcol])
                    )
            cand_x.append(xn)
            cand_e.append(total_err2(xn, residual_at(xn)))

        e01 = jnp.minimum(cand_e[0], cand_e[1])
        ebest = jnp.minimum(e01, cand_e[2])
        better = ebest < err_cur
        pick0 = cand_e[0] <= ebest
        pick1 = (~pick0) & (cand_e[1] <= ebest)
        lam_best = jnp.where(
            pick0, lam * 0.1, jnp.where(pick1, lam, lam * 10.0)
        )
        for kcol in range(d):
            xk = jnp.where(
                pick0,
                cand_x[0][kcol],
                jnp.where(pick1, cand_x[1][kcol], cand_x[2][kcol]),
            )
            x[kcol] = jnp.where(better, xk, x[kcol])
        lam = jnp.clip(
            jnp.where(better, lam_best * 0.5, lam * 10.0), 1e-8, 1e6
        )
        return (jnp.stack(x), lam), None

    (xs, _), _ = jax.lax.scan(lm_step, (xT, lam0), None, length=steps)
    return jnp.moveaxis(xs, 0, -1)


def true_effector_error_rows(spec: ChainSpec, problem, angles) -> jnp.ndarray:
    """``(S,)`` sum of Euclidean effector distances, in row layout.

    Same metric as ``ops.fitness.true_effector_error`` (the reference's
    ``checkDistance`` ground truth, Main.cpp:290-298) computed through
    the SoA row FK: every intermediate is an ``(S,)`` array, which XLA
    fuses into a few elementwise loops. Equal to the tensor oracle to
    float rounding (exact f32 composes in both; summation order differs
    by last-ulp) — tests/test_polish.py covers the row-FK equivalence.
    """
    d = angles.shape[-1]

    def core(args):
        pose, origin, targets, ang = args
        ang_rows = [ang[..., k] for k in range(d)]
        root = pose[..., 0, :]
        root_rows = [root[..., c] for c in range(3)]
        origin_rows = [origin[..., c] for c in range(3)]
        pos, _, _ = _fk_rows(spec, ang_rows, root_rows, origin_rows)
        err = None
        for ei, node in enumerate(spec.effector_idx):
            s2 = None
            for c in range(3):
                dc = pos[node][c] - targets[..., ei, c]
                s2 = dc * dc if s2 is None else s2 + dc * dc
            e = jnp.sqrt(s2)
            err = e if err is None else err + e
        return err

    origin = jnp.broadcast_to(problem.origin, angles.shape[:-1] + (3,))
    return core((problem.pose, origin, problem.targets, angles))


def anchor_positions_flat(spec: ChainSpec, problem) -> jnp.ndarray:
    """``(S, 3*(N-1))`` non-root node positions of the problem's pose.

    The megakernel's per-swarm constant pack wants the anchor FK as a
    flat row block (ops.tile_fitness.pack_swarm); the row FK computes
    it without ``(S, N, 3, 3)`` intermediates (see
    :func:`true_effector_error_rows`).
    """
    n = spec.num_nodes

    def core(args):
        pose, origin = args
        ang_rows = [
            pose[..., k, c] for k in range(1, n) for c in range(3)
        ]
        root_rows = [pose[..., 0, c] for c in range(3)]
        origin_rows = [origin[..., c] for c in range(3)]
        pos, _, _ = _fk_rows(spec, ang_rows, root_rows, origin_rows)
        return jnp.stack(
            [pos[k][c] for k in range(1, n) for c in range(3)], axis=-1
        )

    origin = jnp.broadcast_to(
        problem.origin, problem.pose.shape[:-2] + (3,)
    )
    return core((problem.pose, origin))
