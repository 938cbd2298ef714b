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
//
// The same algorithm as the JAX package's native qem.cpp, step for step,
// and so the same output bit for bit: the heap is std::priority_queue's
// binary heap written out (the same comparisons, so equal costs leave in
// the same order), laid out so that a node's two children share a cache
// line and prefetching its grandchildren; a vertex's position, quadric,
// version and union-find link share one 128-byte record, which is what a
// popped entry's validity test and edge cost read, and the next entry's
// two records are fetched while one is handled: most pops are of stale
// entries (~30 per collapse at a 40-fold decimation), each reading two
// random records. Meshes of 2^31 vertices or more are refused.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_set>
#include <algorithm>
#include <cstdlib>
#include <new>

namespace {

struct Quadric {
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

// One vertex's state in two cache lines: what a heap entry's validity test
// and its edge cost read.
struct alignas(64) Vert {
  Quadric quad;
  double pos[3];
  int32_t remap;
  uint32_t version;
  char dead;
};

struct alignas(32) HeapEntry {
  double cost;
  int32_t a, b;       // endpoints (a < b) at push time
  uint32_t stamp;     // validity stamp = version[a] + version[b]
};

// std::priority_queue's binary heap, step for step (libstdc++'s
// __push_heap / __adjust_heap with the same comparisons, so equal costs
// leave in the same order), over an array offset by one slot so that the
// two children of a node share a cache line; the sift-down prefetches
// the grandchildren.
class Heap {
 public:
  ~Heap() { std::free(v_); }
  bool empty() const { return n_ == 0; }
  const HeapEntry& top() const { return at(0); }
  void push(const HeapEntry& e) {
    if (n_ + 2 > cap_) grow();
    sift_up(n_, e);
    ++n_;
  }
  void pop() {
    --n_;
    HeapEntry value = at(n_);
    if (n_ == 0) return;
    adjust(value);
  }

 private:
  HeapEntry& at(size_t i) { return v_[i + 1]; }
  const HeapEntry& at(size_t i) const { return v_[i + 1]; }
  void grow() {
    size_t cap = std::max<size_t>(2 * cap_, 64);
    auto* v = static_cast<HeapEntry*>(std::aligned_alloc(64, cap * sizeof(HeapEntry)));
    if (v == nullptr) throw std::bad_alloc();
    if (n_) std::memcpy(v + 1, v_ + 1, n_ * sizeof(HeapEntry));
    std::free(v_);
    v_ = v;
    cap_ = cap;
  }
  // __comp(x, y) of std::less<HeapEntry>: x.cost > y.cost
  static bool less(const HeapEntry& x, const HeapEntry& y) { return x.cost > y.cost; }
  void sift_up(size_t hole, const HeapEntry& value) {
    size_t parent = (hole - 1) / 2;
    while (hole > 0 && less(at(parent), value)) {
      at(hole) = at(parent);
      hole = parent;
      parent = (hole - 1) / 2;
    }
    at(hole) = value;
  }
  void adjust(const HeapEntry& value) {
    const size_t len = n_;
    size_t hole = 0, child = 0;
    while (len >= 2 && child < (len - 1) / 2) {
      child = 2 * (child + 1);
      // the children of nodes child - 1 and child: v_[2 * child ...
      // 2 * child + 3], two cache lines
      size_t g = 2 * child;
      if (g + 1 < cap_) __builtin_prefetch(&v_[g]);
      if (g + 3 < cap_) __builtin_prefetch(&v_[g + 2]);
      if (less(at(child), at(child - 1))) child--;
      at(hole) = at(child);
      hole = child;
    }
    if ((len & 1) == 0 && child == (len - 2) / 2) {
      child = 2 * (child + 1);
      at(hole) = at(child - 1);
      hole = child - 1;
    }
    sift_up(hole, value);
  }
  HeapEntry* v_ = nullptr;  // v_[1 + i] is node i; 64-byte aligned
  size_t cap_ = 0;
  size_t n_ = 0;
};

inline void cross3(const double* u, const double* v, double* out) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

}  // namespace

extern "C" {

int qem_decimate(const double* verts, int64_t nv,
                 const int64_t* faces, int64_t nf,
                 int64_t target_v,
                 double* out_verts, int64_t* out_nv,
                 int64_t* out_faces, int64_t* out_nf) {
  if (nv <= 0 || nf <= 0 || target_v < 4) return 0;
  if (nv > INT32_MAX) return 0;

  std::vector<Vert> vx(nv);
  for (int64_t i = 0; i < nv; ++i) {
    std::memcpy(vx[i].pos, verts + i * 3, 24);
    vx[i].remap = (int32_t)i;
    vx[i].version = 0;
    vx[i].dead = 0;
  }
  std::vector<std::vector<int64_t>> vfaces(nv);
  std::vector<int64_t> f(faces, faces + nf * 3);
  std::vector<char> face_dead(nf, 0);

  for (int64_t i = 0; i < nf; ++i) {
    int64_t a = f[i * 3], b = f[i * 3 + 1], c = f[i * 3 + 2];
    if (a == b || b == c || a == c) { face_dead[i] = 1; continue; }
    const double* pa = vx[a].pos; const double* pb = vx[b].pos; const double* pc = vx[c].pos;
    double e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    double e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    double n[3];
    cross3(e1, e2, n);
    double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len < 1e-20) { face_dead[i] = 1; continue; }
    n[0] /= len; n[1] /= len; n[2] /= len;
    double d = -(n[0] * pa[0] + n[1] * pa[1] + n[2] * pa[2]);
    Quadric pq;
    pq.add_plane(n[0], n[1], n[2], d);
    for (int k = 0; k < 10; ++k) pq.q[k] *= len * 0.5;
    vx[a].quad.add(pq); vx[b].quad.add(pq); vx[c].quad.add(pq);
    vfaces[a].push_back(i); vfaces[b].push_back(i); vfaces[c].push_back(i);
  }

  auto edge_cost = [&](int64_t a, int64_t b, double* best) -> double {
    Quadric q = vx[a].quad;
    q.add(vx[b].quad);
    const double* pa = vx[a].pos;
    const double* pb = vx[b].pos;
    double mid[3] = {(pa[0] + pb[0]) * 0.5, (pa[1] + pb[1]) * 0.5,
                     (pa[2] + pb[2]) * 0.5};
    double ca = q.eval(pa), cb = q.eval(pb), cm = q.eval(mid);
    if (cm <= ca && cm <= cb) { std::memcpy(best, mid, 24); return cm; }
    if (ca <= cb) { std::memcpy(best, pa, 24); return ca; }
    std::memcpy(best, pb, 24); return cb;
  };
  auto push = [&](Heap& h, double c, int64_t a, int64_t b) {
    h.push({c, (int32_t)a, (int32_t)b, vx[a].version + vx[b].version});
  };

  Heap heap;
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
        push(heap, c, a, b);
      }
    }
  }

  int64_t alive = nv;
  auto find = [&](int64_t v) -> int64_t {
    while (vx[v].remap != v) {
      vx[v].remap = vx[vx[v].remap].remap;
      v = vx[v].remap;
    }
    return v;
  };

  while (alive > target_v && !heap.empty()) {
    HeapEntry e = heap.top(); heap.pop();
    if (!heap.empty()) {
      // the next entry's two vertex records, fetched while this one is
      // handled
      const char* na = reinterpret_cast<const char*>(&vx[heap.top().a]);
      const char* nb = reinterpret_cast<const char*>(&vx[heap.top().b]);
      __builtin_prefetch(na); __builtin_prefetch(na + 64);
      __builtin_prefetch(nb); __builtin_prefetch(nb + 64);
    }
    int64_t a = find(e.a), b = find(e.b);
    if (a == b || vx[a].dead || vx[b].dead) continue;
    if (vx[a].version + vx[b].version != e.stamp || a != e.a || b != e.b) {
      double best[3];
      double c = edge_cost(a, b, best);
      if (a > b) std::swap(a, b);
      push(heap, c, a, b);
      continue;
    }

    double best[3];
    edge_cost(a, b, best);

    bool flip = false;
    for (int side = 0; side < 2 && !flip; ++side) {
      int64_t v = side == 0 ? a : b;
      for (int64_t fi : vfaces[v]) {
        if (face_dead[fi]) continue;
        int64_t va = find(f[fi * 3]), vb = find(f[fi * 3 + 1]),
                vc = find(f[fi * 3 + 2]);
        int hit = (va == a || va == b) + (vb == a || vb == b) +
                  (vc == a || vc == b);
        if (hit >= 2) continue;
        double p[3][3];
        int64_t ids[3] = {va, vb, vc};
        for (int k = 0; k < 3; ++k) {
          if (ids[k] == a || ids[k] == b) std::memcpy(p[k], best, 24);
          else std::memcpy(p[k], vx[ids[k]].pos, 24);
        }
        double e1[3] = {p[1][0] - p[0][0], p[1][1] - p[0][1], p[1][2] - p[0][2]};
        double e2[3] = {p[2][0] - p[0][0], p[2][1] - p[0][1], p[2][2] - p[0][2]};
        double n_new[3];
        cross3(e1, e2, n_new);
        const double* q0 = vx[ids[0]].pos;
        const double* q1 = vx[ids[1]].pos;
        const double* q2 = vx[ids[2]].pos;
        double o1[3] = {q1[0] - q0[0], q1[1] - q0[1], q1[2] - q0[2]};
        double o2[3] = {q2[0] - q0[0], q2[1] - q0[1], q2[2] - q0[2]};
        double n_old[3];
        cross3(o1, o2, n_old);
        if (n_new[0] * n_old[0] + n_new[1] * n_old[1] + n_new[2] * n_old[2]
            < 0.0) { flip = true; break; }
      }
    }
    if (flip) continue;

    std::memcpy(vx[a].pos, best, 24);
    vx[a].quad.add(vx[b].quad);
    vx[b].dead = 1;
    vx[b].remap = (int32_t)a;
    vx[a].version++;
    alive--;

    for (int64_t fi : vfaces[b]) {
      if (face_dead[fi]) continue;
      int64_t va = find(f[fi * 3]), vb = find(f[fi * 3 + 1]),
              vc = find(f[fi * 3 + 2]);
      if (va == vb || vb == vc || va == vc) { face_dead[fi] = 1; continue; }
      vfaces[a].push_back(fi);
    }
    auto& fa = vfaces[a];
    fa.erase(std::remove_if(fa.begin(), fa.end(), [&](int64_t fi) {
      if (face_dead[fi]) return true;
      int64_t va = find(f[fi * 3]), vb = find(f[fi * 3 + 1]),
              vc = find(f[fi * 3 + 2]);
      if (va == vb || vb == vc || va == vc) { face_dead[fi] = 1; return true; }
      return false;
    }), fa.end());

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
      push(heap, c, x, y);
    }
  }

  std::vector<int64_t> new_id(nv, -1);
  int64_t vn = 0;
  for (int64_t i = 0; i < nv; ++i) {
    if (!vx[i].dead && find(i) == i) {
      new_id[i] = vn;
      std::memcpy(&out_verts[vn * 3], vx[i].pos, 24);
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
