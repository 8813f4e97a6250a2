"""ctypes bindings for the native host runtime (``native/``).

The reference's host layer — scene graph, tree->flat marshaling, host
FK, experiment logging — is C++ (reference Node.h, Main.cpp). This
framework keeps that layer native too: ``native/ikpso_native.cpp``
implements it against a plain C ABI, and this module is the Python
binding (ctypes; no pybind11 in the image).

Everything degrades gracefully: if the shared library is missing it is
built on demand with ``make`` (g++, ~1s); if no toolchain exists,
``available()`` returns False and callers fall back to the pure-Python
paths (``ikpso.ops.fk`` on CPU, ``utils.diagnostics``).

Public API:
  * :class:`NodeTree` — build a kinematic tree node by node (the
    reference's ``new Node`` / ``AttachChild`` idiom, Main.cpp:76-117),
    then ``to_chain_spec()`` for the JAX solver, ``fk()`` /
    ``effector_error()`` for the independent host oracle.
  * :class:`NativeDiagnostics` — drop-in fast replacement for
    ``utils.diagnostics.DiagnosticsWriter`` (same 4-file schema).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libikpso_native.so")

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None
_lock = threading.Lock()


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_dbl_p = ctypes.POINTER(ctypes.c_double)
    c_i32_p = ctypes.POINTER(ctypes.c_int32)

    lib.ik_tree_create.restype = ctypes.c_void_p
    lib.ik_tree_destroy.argtypes = [ctypes.c_void_p]
    lib.ik_tree_add_node.restype = ctypes.c_int
    lib.ik_tree_add_node.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
        c_dbl_p, c_dbl_p, ctypes.c_double, ctypes.c_int,
    ]
    lib.ik_tree_num_nodes.restype = ctypes.c_int
    lib.ik_tree_num_nodes.argtypes = [ctypes.c_void_p]
    lib.ik_tree_num_effectors.restype = ctypes.c_int
    lib.ik_tree_num_effectors.argtypes = [ctypes.c_void_p]
    lib.ik_tree_flatten.argtypes = [
        ctypes.c_void_p, c_i32_p, c_dbl_p, c_dbl_p, c_dbl_p, c_dbl_p, c_i32_p,
    ]
    lib.ik_tree_fk.argtypes = [ctypes.c_void_p, c_dbl_p, c_dbl_p, c_dbl_p, c_dbl_p]
    lib.ik_tree_fk_batch.argtypes = [
        ctypes.c_void_p, c_dbl_p, c_dbl_p, ctypes.c_int64, c_dbl_p,
    ]
    lib.ik_tree_effector_error.restype = ctypes.c_double
    lib.ik_tree_effector_error.argtypes = [ctypes.c_void_p, c_dbl_p, c_dbl_p, c_dbl_p]

    lib.ik_diag_open.restype = ctypes.c_void_p
    lib.ik_diag_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ik_diag_log_frame.argtypes = [
        ctypes.c_void_p, c_dbl_p, ctypes.c_int64, c_dbl_p, ctypes.c_int64,
        ctypes.c_double,
    ]
    lib.ik_diag_log_convergence.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ik_diag_flush.argtypes = [ctypes.c_void_p]
    lib.ik_diag_close.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.SubprocessError) as e:
                _lib_error = f"native build failed: {e}"
                return None
        try:
            _lib = _configure(ctypes.CDLL(_SO_PATH))
        except OSError as e:
            _lib_error = f"native load failed: {e}"
            return None
        return _lib


def available() -> bool:
    """True if the native runtime is (or can be) loaded."""
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _lib_error


def _dbl(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NodeTree:
    """Native kinematic-tree builder + host FK oracle.

    The Python-facing twin of the reference's scene-graph idiom
    (Main.cpp:76-117): create the origin, attach joints/effectors,
    then hand the flat form to the JAX solver::

        tree = NodeTree(origin_rotation=(0, 0, 0))
        j1 = tree.add_joint(parent=0, length=1.0, limits=(-3.14, 3.14))
        tree.add_effector(parent=j1, length=1.0, weight=1.0)
        spec = tree.to_chain_spec()
    """

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_lib_error}")
        self._lib = lib
        self._ptr = ctypes.c_void_p(lib.ik_tree_create())
        # Node 0: the origin (no DOF, no length).
        zero = np.zeros(3, np.float64)
        r = lib.ik_tree_add_node(self._ptr, -1, 0.0, _dbl(zero), _dbl(zero), 0.0, 0)
        assert r == 0

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.ik_tree_destroy(ptr)
            self._ptr = None

    def _add(self, parent, length, min_rot, max_rot, weight, is_eff) -> int:
        lo = np.ascontiguousarray(np.broadcast_to(min_rot, (3,)), np.float64)
        hi = np.ascontiguousarray(np.broadcast_to(max_rot, (3,)), np.float64)
        idx = self._lib.ik_tree_add_node(
            self._ptr, int(parent), float(length), _dbl(lo), _dbl(hi),
            float(weight), int(is_eff),
        )
        if idx < 0:
            raise ValueError(
                f"invalid parent {parent}: must reference an existing node"
            )
        return idx

    def add_joint(self, parent: int, length: float, limits=( -2 * np.pi, 2 * np.pi)) -> int:
        lo, hi = limits
        return self._add(parent, length, lo, hi, 0.0, False)

    def add_effector(
        self, parent: int, length: float, weight: float = 1.0,
        limits=(-2 * np.pi, 2 * np.pi),
    ) -> int:
        lo, hi = limits
        return self._add(parent, length, lo, hi, weight, True)

    @property
    def num_nodes(self) -> int:
        return self._lib.ik_tree_num_nodes(self._ptr)

    @property
    def num_effectors(self) -> int:
        return self._lib.ik_tree_num_effectors(self._ptr)

    def flatten(self):
        """Flat arrays (parent, length, min_rot, max_rot, eff_weight, eff_idx)."""
        n = self.num_nodes
        e = self.num_effectors
        parent = np.empty(n, np.int32)
        length = np.empty(n, np.float64)
        min_rot = np.empty((n, 3), np.float64)
        max_rot = np.empty((n, 3), np.float64)
        eff_w = np.empty(n, np.float64)
        eff_idx = np.empty(max(e, 1), np.int32)
        self._lib.ik_tree_flatten(
            self._ptr, _i32(parent), _dbl(length), _dbl(min_rot),
            _dbl(max_rot), _dbl(eff_w), _i32(eff_idx),
        )
        return parent, length, min_rot, max_rot, eff_w, eff_idx[:e]

    def to_chain_spec(self):
        """Marshal to the JAX solver's ChainSpec (the tree->flat step
        the reference does per frame with cudaMemcpys, Node.h:232-267 —
        here it happens once, and the arrays go to device via the
        normal jit path)."""
        from ikpso.models.chain import make_chain_spec

        parent, length, min_rot, max_rot, eff_w, eff_idx = self.flatten()
        return make_chain_spec(
            parent=parent,
            length=length,
            min_rotation=min_rot,
            max_rotation=max_rot,
            effector_idx=eff_idx,
            effector_weight=eff_w,
        )

    def fk(self, pose, origin=(0.0, 0.0, 0.0), return_rotations: bool = False):
        """Double-precision host FK — the independent oracle."""
        n = self.num_nodes
        pose = np.ascontiguousarray(pose, np.float64).reshape(n, 3)
        origin = np.ascontiguousarray(origin, np.float64).reshape(3)
        out_pos = np.empty((n, 3), np.float64)
        out_rot = np.empty((n, 3, 3), np.float64) if return_rotations else None
        self._lib.ik_tree_fk(
            self._ptr, _dbl(pose), _dbl(origin), _dbl(out_pos),
            _dbl(out_rot) if return_rotations else None,
        )
        return (out_pos, out_rot) if return_rotations else out_pos

    def fk_batch(self, poses, origins) -> np.ndarray:
        n = self.num_nodes
        poses = np.ascontiguousarray(poses, np.float64).reshape(-1, n, 3)
        b = poses.shape[0]
        origins = np.ascontiguousarray(
            np.broadcast_to(np.asarray(origins, np.float64), (b, 3))
        )
        out = np.empty((b, n, 3), np.float64)
        self._lib.ik_tree_fk_batch(
            self._ptr, _dbl(poses), _dbl(origins), b, _dbl(out)
        )
        return out

    def effector_error(self, pose, origin, targets) -> float:
        """True Euclidean summed effector error (reference checkDistance)."""
        n = self.num_nodes
        pose = np.ascontiguousarray(pose, np.float64).reshape(n, 3)
        origin = np.ascontiguousarray(origin, np.float64).reshape(3)
        targets = np.ascontiguousarray(targets, np.float64).reshape(-1, 3)
        if targets.shape[0] != self.num_effectors:
            raise ValueError(
                f"expected {self.num_effectors} targets, got {targets.shape[0]}"
            )
        return float(
            self._lib.ik_tree_effector_error(
                self._ptr, _dbl(pose), _dbl(origin), _dbl(targets)
            )
        )


def tree_from_chain_spec(spec) -> "NodeTree":
    """Rebuild a native NodeTree from a ChainSpec (for oracle checks)."""
    tree = NodeTree.__new__(NodeTree)
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_lib_error}")
    tree._lib = lib
    tree._ptr = ctypes.c_void_p(lib.ik_tree_create())
    length = np.asarray(spec.length, np.float64)
    min_rot = np.asarray(spec.min_rotation, np.float64)
    max_rot = np.asarray(spec.max_rotation, np.float64)
    eff_w = np.asarray(spec.effector_weight, np.float64)
    eff = set(spec.effector_idx)
    for k, parent in enumerate(spec.parent):
        lo = np.ascontiguousarray(min_rot[k])
        hi = np.ascontiguousarray(max_rot[k])
        r = lib.ik_tree_add_node(
            tree._ptr, int(parent), float(length[k]), _dbl(lo), _dbl(hi),
            float(eff_w[k]), int(k in eff),
        )
        if r != k:
            raise ValueError(f"bad topology at node {k} (parent {parent})")
    return tree


class NativeDiagnostics:
    """Native 4-stream diagnostics writer (same schema as
    ``utils.diagnostics.DiagnosticsWriter``; reference Main.cpp:147-216)."""

    def __init__(self, directory: str, prefix: str = "IK-diagnostics"):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_lib_error}")
        os.makedirs(directory, exist_ok=True)
        self._lib = lib
        self._ptr = ctypes.c_void_p(
            lib.ik_diag_open(directory.encode(), prefix.encode())
        )
        if not self._ptr:
            raise OSError(f"could not open diagnostics streams in {directory}")

    def log_frame(self, degrees, positions, distance: float) -> None:
        deg = np.ascontiguousarray(np.asarray(degrees, np.float64).reshape(-1))
        pos = np.ascontiguousarray(np.asarray(positions, np.float64).reshape(-1))
        self._lib.ik_diag_log_frame(
            self._ptr, _dbl(deg), deg.size, _dbl(pos), pos.size, float(distance)
        )

    def log_convergence(self, frames: int) -> None:
        self._lib.ik_diag_log_convergence(self._ptr, int(frames))

    def flush(self) -> None:
        self._lib.ik_diag_flush(self._ptr)

    def close(self) -> None:
        if self._ptr:
            self._lib.ik_diag_close(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self.close()


def make_diagnostics_writer(directory: str, prefix: str = "IK-diagnostics"):
    """Native writer when available, Python fallback otherwise."""
    if available():
        return NativeDiagnostics(directory, prefix)
    from ikpso.utils.diagnostics import DiagnosticsWriter

    return DiagnosticsWriter(directory, prefix)
