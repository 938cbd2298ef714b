// Quadric-error-metric mesh decimation (Garland-Heckbert style).
//
// Native replacement for Open3D's simplify_quadric_decimation used by the
// reference's shell extraction (frosting_extractors/coarse_shell.py:488).
// Exposed as a C ABI for ctypes; built with g++ at first use by
// frosting_tpu_torch/_build.py and bound in extract/meshclean.py.
//
// Algorithm: per-vertex 4x4 error quadrics from face planes; greedy edge
// collapses by minimum quadric cost from a lazy min-heap; midpoint-or-
// endpoint placement (solving the full 3x3 system is skipped for
// robustness); simple link-condition-lite guards against fin/flip
// degeneracies via normal-flip rejection.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <unordered_set>
#include <algorithm>

namespace {

struct Quadric {
  // symmetric 4x4, stored as upper triangle (10 values)
  double q[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  void add_plane(double a, double b, double c, double d) {
    q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
    q[4] += b * b; q[5] += b * c; q[6] += b * d;
    q[7] += c * c; q[8] += c * d;
    q[9] += d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) q[i] += o.q[i];
  }
  double eval(const double* v) const {
    double x = v[0], y = v[1], z = v[2];
    return q[0] * x * x + 2 * q[1] * x * y + 2 * q[2] * x * z + 2 * q[3] * x
         + q[4] * y * y + 2 * q[5] * y * z + 2 * q[6] * y
         + q[7] * z * z + 2 * q[8] * z
         + q[9];
  }
};

struct HeapEntry {
  double cost;
  int64_t a, b;       // endpoints (a < b) at push time
  uint64_t stamp;     // validity stamp = version[a] + version[b]
  bool operator<(const HeapEntry& o) const { return cost > o.cost; }
};

inline void cross3(const double* u, const double* v, double* out) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

}  // namespace

extern "C" {

// Decimate (verts[nv*3], faces[nf*3]) to approximately target_v vertices.
// Outputs are written into out_verts / out_faces (caller-allocated with
// capacity nv*3 and nf*3); returns 0 on error, else sets *out_nv/*out_nf.
int qem_decimate(const double* verts, int64_t nv,
                 const int64_t* faces, int64_t nf,
                 int64_t target_v,
                 double* out_verts, int64_t* out_nv,
                 int64_t* out_faces, int64_t* out_nf) {
  if (nv <= 0 || nf <= 0 || target_v < 4) return 0;

  std::vector<double> pos(verts, verts + nv * 3);
  std::vector<Quadric> quad(nv);
  std::vector<std::vector<int64_t>> vfaces(nv);
  std::vector<int64_t> f(faces, faces + nf * 3);
  std::vector<char> face_dead(nf, 0);
  std::vector<uint64_t> version(nv, 0);
  std::vector<char> vert_dead(nv, 0);

  // initial quadrics from face planes
  for (int64_t i = 0; i < nf; ++i) {
    int64_t a = f[i * 3], b = f[i * 3 + 1], c = f[i * 3 + 2];
    if (a == b || b == c || a == c) { face_dead[i] = 1; continue; }
    double e1[3] = {pos[b * 3] - pos[a * 3], pos[b * 3 + 1] - pos[a * 3 + 1],
                    pos[b * 3 + 2] - pos[a * 3 + 2]};
    double e2[3] = {pos[c * 3] - pos[a * 3], pos[c * 3 + 1] - pos[a * 3 + 1],
                    pos[c * 3 + 2] - pos[a * 3 + 2]};
    double n[3];
    cross3(e1, e2, n);
    double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len < 1e-20) { face_dead[i] = 1; continue; }
    n[0] /= len; n[1] /= len; n[2] /= len;
    double d = -(n[0] * pos[a * 3] + n[1] * pos[a * 3 + 1] + n[2] * pos[a * 3 + 2]);
    Quadric pq;
    pq.add_plane(n[0], n[1], n[2], d);
    // area weighting stabilizes large/small triangle mixes
    for (int k = 0; k < 10; ++k) pq.q[k] *= len * 0.5;
    quad[a].add(pq); quad[b].add(pq); quad[c].add(pq);
    vfaces[a].push_back(i); vfaces[b].push_back(i); vfaces[c].push_back(i);
  }

  auto edge_cost = [&](int64_t a, int64_t b, double* best) -> double {
    Quadric q = quad[a];
    q.add(quad[b]);
    const double* pa = &pos[a * 3];
    const double* pb = &pos[b * 3];
    double mid[3] = {(pa[0] + pb[0]) * 0.5, (pa[1] + pb[1]) * 0.5,
                     (pa[2] + pb[2]) * 0.5};
    double ca = q.eval(pa), cb = q.eval(pb), cm = q.eval(mid);
    if (cm <= ca && cm <= cb) { std::memcpy(best, mid, 24); return cm; }
    if (ca <= cb) { std::memcpy(best, pa, 24); return ca; }
    std::memcpy(best, pb, 24); return cb;
  };

  std::priority_queue<HeapEntry> heap;
  {
    std::unordered_set<uint64_t> seen;
    seen.reserve(nf * 3);
    for (int64_t i = 0; i < nf; ++i) {
      if (face_dead[i]) continue;
      for (int e = 0; e < 3; ++e) {
        int64_t a = f[i * 3 + e], b = f[i * 3 + (e + 1) % 3];
        if (a > b) std::swap(a, b);
        uint64_t key = (uint64_t)a << 32 | (uint64_t)b;
        if (!seen.insert(key).second) continue;
        double best[3];
        double c = edge_cost(a, b, best);
        heap.push({c, a, b, version[a] + version[b]});
      }
    }
  }

  int64_t alive = nv;
  std::vector<int64_t> remap(nv);
  for (int64_t i = 0; i < nv; ++i) remap[i] = i;
  auto find = [&](int64_t v) {
    while (remap[v] != v) { remap[v] = remap[remap[v]]; v = remap[v]; }
    return v;
  };

  while (alive > target_v && !heap.empty()) {
    HeapEntry e = heap.top(); heap.pop();
    int64_t a = find(e.a), b = find(e.b);
    if (a == b || vert_dead[a] || vert_dead[b]) continue;
    if (version[a] + version[b] != e.stamp || a != e.a || b != e.b) {
      // stale: recompute and re-push once endpoints canonicalized
      double best[3];
      double c = edge_cost(a, b, best);
      if (a > b) std::swap(a, b);
      heap.push({c, a, b, version[a] + version[b]});
      continue;
    }

    double best[3];
    edge_cost(a, b, best);

    // normal-flip rejection: test faces of a and b that survive
    bool flip = false;
    for (int side = 0; side < 2 && !flip; ++side) {
      int64_t v = side == 0 ? a : b;
      for (int64_t fi : vfaces[v]) {
        if (face_dead[fi]) continue;
        int64_t va = find(f[fi * 3]), vb = find(f[fi * 3 + 1]),
                vc = find(f[fi * 3 + 2]);
        // face collapses entirely -> will die; skip
        int hit = (va == a || va == b) + (vb == a || vb == b) +
                  (vc == a || vc == b);
        if (hit >= 2) continue;
        double p[3][3];
        int64_t ids[3] = {va, vb, vc};
        for (int k = 0; k < 3; ++k) {
          if (ids[k] == a || ids[k] == b) std::memcpy(p[k], best, 24);
          else std::memcpy(p[k], &pos[ids[k] * 3], 24);
        }
        double e1[3] = {p[1][0] - p[0][0], p[1][1] - p[0][1], p[1][2] - p[0][2]};
        double e2[3] = {p[2][0] - p[0][0], p[2][1] - p[0][1], p[2][2] - p[0][2]};
        double n_new[3];
        cross3(e1, e2, n_new);
        // old normal
        double q0[3], q1[3], q2[3];
        std::memcpy(q0, &pos[ids[0] * 3], 24);
        std::memcpy(q1, &pos[ids[1] * 3], 24);
        std::memcpy(q2, &pos[ids[2] * 3], 24);
        double o1[3] = {q1[0] - q0[0], q1[1] - q0[1], q1[2] - q0[2]};
        double o2[3] = {q2[0] - q0[0], q2[1] - q0[1], q2[2] - q0[2]};
        double n_old[3];
        cross3(o1, o2, n_old);
        if (n_new[0] * n_old[0] + n_new[1] * n_old[1] + n_new[2] * n_old[2]
            < 0.0) { flip = true; break; }
      }
    }
    if (flip) continue;

    // collapse b into a
    std::memcpy(&pos[a * 3], best, 24);
    quad[a].add(quad[b]);
    vert_dead[b] = 1;
    remap[b] = a;
    version[a]++;
    alive--;

    // merge face lists, kill degenerate faces
    for (int64_t fi : vfaces[b]) {
      if (face_dead[fi]) continue;
      int64_t va = find(f[fi * 3]), vb = find(f[fi * 3 + 1]),
              vc = find(f[fi * 3 + 2]);
      if (va == vb || vb == vc || va == vc) { face_dead[fi] = 1; continue; }
      vfaces[a].push_back(fi);
    }
    // also prune a's own dead faces opportunistically
    auto& fa = vfaces[a];
    fa.erase(std::remove_if(fa.begin(), fa.end(), [&](int64_t fi) {
      if (face_dead[fi]) return true;
      int64_t va = find(f[fi * 3]), vb = find(f[fi * 3 + 1]),
              vc = find(f[fi * 3 + 2]);
      if (va == vb || vb == vc || va == vc) { face_dead[fi] = 1; return true; }
      return false;
    }), fa.end());

    // push fresh edges around a
    std::unordered_set<int64_t> nbrs;
    for (int64_t fi : vfaces[a]) {
      int64_t vs[3] = {find(f[fi * 3]), find(f[fi * 3 + 1]),
                       find(f[fi * 3 + 2])};
      for (int k = 0; k < 3; ++k) if (vs[k] != a) nbrs.insert(vs[k]);
    }
    for (int64_t nb : nbrs) {
      int64_t x = a, y = nb;
      if (x > y) std::swap(x, y);
      double bp[3];
      double c = edge_cost(x, y, bp);
      heap.push({c, x, y, version[x] + version[y]});
    }
  }

  // compact output
  std::vector<int64_t> new_id(nv, -1);
  int64_t vn = 0;
  for (int64_t i = 0; i < nv; ++i) {
    if (!vert_dead[i] && find(i) == i) {
      new_id[i] = vn;
      std::memcpy(&out_verts[vn * 3], &pos[i * 3], 24);
      vn++;
    }
  }
  int64_t fn = 0;
  std::unordered_set<uint64_t> face_seen;
  for (int64_t i = 0; i < nf; ++i) {
    if (face_dead[i]) continue;
    int64_t a = find(f[i * 3]), b = find(f[i * 3 + 1]), c = find(f[i * 3 + 2]);
    if (a == b || b == c || a == c) continue;
    int64_t na = new_id[a], nb = new_id[b], nc = new_id[c];
    if (na < 0 || nb < 0 || nc < 0) continue;
    // dedupe faces regardless of rotation (keep orientation)
    int64_t s0 = std::min({na, nb, nc}), s2 = std::max({na, nb, nc});
    int64_t s1 = na + nb + nc - s0 - s2;
    uint64_t key = ((uint64_t)s0 * 1000003ULL + (uint64_t)s1) * 1000003ULL
                 + (uint64_t)s2;
    if (!face_seen.insert(key).second) continue;
    out_faces[fn * 3] = na; out_faces[fn * 3 + 1] = nb;
    out_faces[fn * 3 + 2] = nc;
    fn++;
  }
  *out_nv = vn;
  *out_nf = fn;
  return 1;
}

}  // extern "C"
