"""Native host runtime (C++ scene graph / FK oracle / diagnostics).

The native library is the independent double-precision oracle for the
JAX FK (the role the reference's glm host FK plays against its device
FK, SURVEY.md §4 "oracle" pattern), so these tests cross-check the two
implementations against each other and against the numpy oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ikpso import native
from ikpso.models import library
from ikpso.ops import fk as fk_ops

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native runtime unavailable: {native.load_error()}"
)


def test_tree_builder_flattens_to_chain_spec():
    t = native.NodeTree()
    j1 = t.add_joint(0, 1.0, limits=(-1.0, 1.0))
    j2 = t.add_joint(j1, 0.5)
    e1 = t.add_effector(j2, 0.75, weight=2.0)
    e2 = t.add_effector(j2, 0.25, weight=0.5)  # tree: two children of j2
    spec = t.to_chain_spec()
    assert spec.parent == (-1, 0, 1, 2, 2)
    assert spec.effector_idx == (e1, e2)
    np.testing.assert_allclose(np.asarray(spec.length), [0, 1.0, 0.5, 0.75, 0.25])
    np.testing.assert_allclose(
        np.asarray(spec.effector_weight), [0, 0, 0, 2.0, 0.5]
    )
    np.testing.assert_allclose(np.asarray(spec.min_rotation)[1], [-1.0] * 3)


def test_invalid_parent_rejected():
    t = native.NodeTree()
    with pytest.raises(ValueError):
        t.add_joint(parent=5, length=1.0)


def test_native_fk_matches_jax_fk(rng):
    spec, problem = library.reference_arm()
    tree = native.tree_from_chain_spec(spec)
    for _ in range(5):
        pose = rng.uniform(-np.pi, np.pi, size=(spec.num_nodes, 3)).astype(np.float32)
        ours = np.asarray(
            fk_ops.fk_points(spec, jnp.asarray(pose), problem.origin)
        )
        theirs = tree.fk(pose, np.asarray(problem.origin))
        np.testing.assert_allclose(ours, theirs, atol=5e-5)


def test_native_effector_error_is_oracle(rng):
    from ikpso.ops.fitness import true_effector_error

    spec, problem = library.reference_arm()
    tree = native.tree_from_chain_spec(spec)
    pose = rng.uniform(-np.pi, np.pi, size=(spec.num_nodes, 3)).astype(np.float32)
    ours = float(true_effector_error(spec, jnp.asarray(pose), problem))
    theirs = tree.effector_error(pose, np.asarray(problem.origin), np.asarray(problem.targets))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


def test_fk_batch(rng):
    spec, problem = library.arm_7dof()
    tree = native.tree_from_chain_spec(spec)
    poses = rng.uniform(-1, 1, size=(8, spec.num_nodes, 3))
    out = tree.fk_batch(poses, np.zeros(3))
    assert out.shape == (8, spec.num_nodes, 3)
    for b in range(8):
        np.testing.assert_allclose(out[b], tree.fk(poses[b]), atol=1e-12)


def test_native_diagnostics_schema(tmp_path):
    from ikpso.utils.diagnostics import DiagnosticsWriter

    angles = np.asarray([0.25, -1.5, 3.0])
    positions = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    with native.NativeDiagnostics(str(tmp_path / "nat")) as d:
        d.log_frame(angles, positions, 0.125)
        d.log_convergence(42)
    with DiagnosticsWriter(str(tmp_path / "py")) as d:
        d.log_frame(angles, positions, 0.125)
        d.log_convergence(42)
    for stream in ("positions", "degrees", "frames", "distance"):
        nat = (tmp_path / "nat" / f"IK-diagnostics-{stream}.txt").read_text()
        py = (tmp_path / "py" / f"IK-diagnostics-{stream}.txt").read_text()
        assert nat == py, f"{stream}: {nat!r} != {py!r}"


def test_diagnostics_append_mode(tmp_path):
    d1 = native.NativeDiagnostics(str(tmp_path))
    d1.log_convergence(1)
    d1.close()
    d2 = native.NativeDiagnostics(str(tmp_path))
    d2.log_convergence(2)
    d2.close()
    assert (tmp_path / "IK-diagnostics-frames.txt").read_text() == "1\n2\n"
