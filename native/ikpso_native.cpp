// Native host runtime for ikpso: scene graph, marshaling, host FK
// oracle, and the diagnostics stream writer.
//
// The reference keeps its scene graph, tree->flat marshaling, host
// forward kinematics, and experiment logging in host C++
// (reference Node.h:37-463, Main.cpp:147-337). The device compute path in
// this framework is JAX/XLA/Pallas; THIS file is the native runtime
// around it:
//
//   * IkTree       — parent-indexed kinematic tree builder (the
//                    reference's Node/OriginNode/EffectorNode graph,
//                    flat from the start: no per-node H2D memcpys).
//   * ik_tree_fk   — double-precision host FK, the independent oracle
//                    the reference implements with glm
//                    (Node.h:92-102); semantics: root = T(origin) *
//                    Rxyz(pose0), child = parent * Rxyz(pose_k) *
//                    T_x(len_k); Euler order X then Y then Z.
//   * ik_tree_effector_error — the true-Euclidean convergence metric
//                    (the reference's checkDistance, Main.cpp:290-298).
//   * IkDiag       — buffered append-mode 4-stream diagnostics writer
//                    (IK-diagnostics-{positions,degrees,frames,
//                    distance}.txt; reference Main.cpp:147-216).
//
// Exposed as a plain C ABI consumed by ctypes
// (ikpso/native/__init__.py). Build: `make -C native`.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Mat3 {
  double m[9];  // row-major
};

Mat3 matmul(const Mat3& a, const Mat3& b) {
  Mat3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.m[i * 3 + j] = a.m[i * 3 + 0] * b.m[0 * 3 + j] +
                       a.m[i * 3 + 1] * b.m[1 * 3 + j] +
                       a.m[i * 3 + 2] * b.m[2 * 3 + j];
  return r;
}

// Rx(x) * Ry(y) * Rz(z), closed form — identical element formulas to
// ikpso.ops.rotations.euler_xyz_to_matrix (and the reference's
// rotateEuler composition, matrix_operations.cuh:166-180).
Mat3 euler_xyz(double x, double y, double z) {
  const double cx = std::cos(x), sx = std::sin(x);
  const double cy = std::cos(y), sy = std::sin(y);
  const double cz = std::cos(z), sz = std::sin(z);
  Mat3 r;
  r.m[0] = cy * cz;
  r.m[1] = -cy * sz;
  r.m[2] = sy;
  r.m[3] = cx * sz + sx * sy * cz;
  r.m[4] = cx * cz - sx * sy * sz;
  r.m[5] = -sx * cy;
  r.m[6] = sx * sz - cx * sy * cz;
  r.m[7] = sx * cz + cx * sy * sz;
  r.m[8] = cx * cy;
  return r;
}

struct Node {
  int parent;
  double length;
  double min_rot[3];
  double max_rot[3];
  double effector_weight;
  bool is_effector;
};

}  // namespace

extern "C" {

struct IkTree {
  std::vector<Node> nodes;
};

IkTree* ik_tree_create() { return new IkTree(); }

void ik_tree_destroy(IkTree* t) { delete t; }

// Returns the new node's index, or -1 on a topology error. Node 0 must
// be the origin (parent == -1); children must come after their parent
// (the invariant the reference maintains by pre-order DFS flattening,
// Node.h:232-267).
int ik_tree_add_node(IkTree* t, int parent, double length,
                     const double* min_rot, const double* max_rot,
                     double effector_weight, int is_effector) {
  const int idx = static_cast<int>(t->nodes.size());
  if (idx == 0) {
    if (parent != -1) return -1;
  } else if (parent < 0 || parent >= idx) {
    return -1;
  }
  Node n;
  n.parent = parent;
  n.length = length;
  for (int i = 0; i < 3; ++i) {
    n.min_rot[i] = min_rot ? min_rot[i] : 0.0;
    n.max_rot[i] = max_rot ? max_rot[i] : 0.0;
  }
  n.effector_weight = effector_weight;
  n.is_effector = is_effector != 0;
  t->nodes.push_back(n);
  return idx;
}

int ik_tree_num_nodes(const IkTree* t) {
  return static_cast<int>(t->nodes.size());
}

int ik_tree_num_effectors(const IkTree* t) {
  int e = 0;
  for (const Node& n : t->nodes) e += n.is_effector ? 1 : 0;
  return e;
}

// Flatten to the ChainSpec arrays. Caller allocates: parent (N ints),
// length (N), min_rot/max_rot (N*3), eff_weight (N), eff_idx (E ints).
void ik_tree_flatten(const IkTree* t, int32_t* parent, double* length,
                     double* min_rot, double* max_rot, double* eff_weight,
                     int32_t* eff_idx) {
  int e = 0;
  for (size_t k = 0; k < t->nodes.size(); ++k) {
    const Node& n = t->nodes[k];
    parent[k] = n.parent;
    length[k] = n.length;
    for (int i = 0; i < 3; ++i) {
      min_rot[k * 3 + i] = n.min_rot[i];
      max_rot[k * 3 + i] = n.max_rot[i];
    }
    eff_weight[k] = n.is_effector ? n.effector_weight : 0.0;
    if (n.is_effector) eff_idx[e++] = static_cast<int32_t>(k);
  }
}

// Host FK for one pose. pose: N*3 Euler-XYZ rows (row 0 = origin
// rotation); origin: world translation of node 0. Outputs world
// positions (N*3) and, if non-null, world rotations (N*9 row-major).
void ik_tree_fk(const IkTree* t, const double* pose, const double* origin,
                double* out_pos, double* out_rot) {
  const size_t n = t->nodes.size();
  std::vector<Mat3> rots(n);
  for (size_t k = 0; k < n; ++k) {
    const Mat3 local =
        euler_xyz(pose[k * 3 + 0], pose[k * 3 + 1], pose[k * 3 + 2]);
    if (k == 0) {
      rots[0] = local;
      out_pos[0] = origin[0];
      out_pos[1] = origin[1];
      out_pos[2] = origin[2];
    } else {
      const int p = t->nodes[k].parent;
      rots[k] = matmul(rots[p], local);
      const double L = t->nodes[k].length;
      // T_x(L): offset L along the node's world X axis (column 0).
      out_pos[k * 3 + 0] = out_pos[p * 3 + 0] + L * rots[k].m[0];
      out_pos[k * 3 + 1] = out_pos[p * 3 + 1] + L * rots[k].m[3];
      out_pos[k * 3 + 2] = out_pos[p * 3 + 2] + L * rots[k].m[6];
    }
    if (out_rot) std::memcpy(out_rot + k * 9, rots[k].m, 9 * sizeof(double));
  }
}

// Batched host FK: B poses -> B*N*3 positions. The "data loader" shape
// used by the experiment harness to produce the positions stream.
void ik_tree_fk_batch(const IkTree* t, const double* poses,
                      const double* origins, int64_t batch,
                      double* out_pos) {
  const size_t n = t->nodes.size();
  for (int64_t b = 0; b < batch; ++b) {
    ik_tree_fk(t, poses + b * n * 3, origins + b * 3, out_pos + b * n * 3,
               nullptr);
  }
}

// True summed Euclidean effector error — the reference's host oracle
// checkDistance (Main.cpp:290-298): deliberately Euclidean, not the
// squared-space device fitness (SURVEY.md §2.4.3). targets: E*3 in
// effector order (ascending node index).
double ik_tree_effector_error(const IkTree* t, const double* pose,
                              const double* origin, const double* targets) {
  const size_t n = t->nodes.size();
  std::vector<double> pos(n * 3);
  ik_tree_fk(t, pose, origin, pos.data(), nullptr);
  double err = 0.0;
  int e = 0;
  for (size_t k = 0; k < n; ++k) {
    if (!t->nodes[k].is_effector) continue;
    const double dx = pos[k * 3 + 0] - targets[e * 3 + 0];
    const double dy = pos[k * 3 + 1] - targets[e * 3 + 1];
    const double dz = pos[k * 3 + 2] - targets[e * 3 + 2];
    err += std::sqrt(dx * dx + dy * dy + dz * dz);
    ++e;
  }
  return err;
}

// ---------------------------------------------------------------------------
// Diagnostics: the reference's 4 append-mode streams (Main.cpp:147-216).

struct IkDiag {
  FILE* positions;
  FILE* degrees;
  FILE* frames;
  FILE* distance;
};

IkDiag* ik_diag_open(const char* directory, const char* prefix) {
  const std::string dir(directory);
  const std::string pre(prefix && prefix[0] ? prefix : "IK-diagnostics");
  auto open_stream = [&](const char* name) -> FILE* {
    const std::string path = dir + "/" + pre + "-" + name + ".txt";
    return std::fopen(path.c_str(), "a");  // append, like ofstream::app
  };
  IkDiag* d = new IkDiag();
  d->positions = open_stream("positions");
  d->degrees = open_stream("degrees");
  d->frames = open_stream("frames");
  d->distance = open_stream("distance");
  if (!d->positions || !d->degrees || !d->frames || !d->distance) {
    if (d->positions) std::fclose(d->positions);
    if (d->degrees) std::fclose(d->degrees);
    if (d->frames) std::fclose(d->frames);
    if (d->distance) std::fclose(d->distance);
    delete d;
    return nullptr;
  }
  return d;
}

static void write_row(FILE* f, const double* v, int64_t count) {
  for (int64_t i = 0; i < count; ++i) std::fprintf(f, "%g;", v[i]);
  std::fputc('\n', f);
}

void ik_diag_log_frame(IkDiag* d, const double* degrees, int64_t dof,
                       const double* positions, int64_t pos_count,
                       double distance) {
  write_row(d->degrees, degrees, dof);
  write_row(d->positions, positions, pos_count);
  std::fprintf(d->distance, "%g\n", distance);
}

void ik_diag_log_convergence(IkDiag* d, int64_t frames) {
  std::fprintf(d->frames, "%lld\n", static_cast<long long>(frames));
}

void ik_diag_flush(IkDiag* d) {
  std::fflush(d->positions);
  std::fflush(d->degrees);
  std::fflush(d->frames);
  std::fflush(d->distance);
}

void ik_diag_close(IkDiag* d) {
  if (!d) return;
  std::fclose(d->positions);
  std::fclose(d->degrees);
  std::fclose(d->frames);
  std::fclose(d->distance);
  delete d;
}

}  // extern "C"
