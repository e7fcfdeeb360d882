// Native 3D KD-tree: nearest-neighbour chamfer queries and radius dedup.
//
// The port's copy of wildmvs/cpp/kdtree.cpp (the code is the same; only
// this header differs). Role: the scipy cKDTree usage in the reference's
// evaluation/metrics.py:38-64 and :141-167, native for throughput
// (multi-threaded queries, no Python overhead in the inner loops).
//
// C API (ctypes):
//   kdtree_build(points, n)                      -> handle
//   kdtree_free(handle)
//   kdtree_nn(handle, queries, m, maxdist, out)  -> NN distance per query
//   kdtree_radius_dedup(points, n, radius, order, keep) -> keep mask
//
// All points are double[3] row-major.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Node {
  int32_t left = -1, right = -1;
  int32_t start = 0, end = 0;  // leaf range into idx_
  int8_t axis = -1;            // -1 for leaf
  double split = 0.0;
  double bb_min[3], bb_max[3];
};

class KDTree {
 public:
  KDTree(const double* pts, int64_t n) : pts_(pts), n_(n) {
    idx_.resize(n);
    for (int64_t i = 0; i < n; ++i) idx_[i] = i;
    nodes_.reserve(2 * (n / kLeaf + 1));
    if (n > 0) root_ = build(0, n);
  }

  // squared NN distance with an upper bound
  double nn_sq(const double* q, double bound_sq) const {
    if (root_ < 0) return bound_sq;
    double best = bound_sq;
    search(root_, q, best);
    return best;
  }

  // append indices within radius of q
  void radius(const double* q, double r, std::vector<int64_t>* out) const {
    if (root_ >= 0) radius_search(root_, q, r * r, out);
  }

 private:
  static constexpr int kLeaf = 16;

  int32_t build(int64_t start, int64_t end) {
    Node node;
    node.start = static_cast<int32_t>(start);
    node.end = static_cast<int32_t>(end);
    for (int d = 0; d < 3; ++d) {
      node.bb_min[d] = std::numeric_limits<double>::infinity();
      node.bb_max[d] = -std::numeric_limits<double>::infinity();
    }
    for (int64_t i = start; i < end; ++i) {
      const double* p = pts_ + 3 * idx_[i];
      for (int d = 0; d < 3; ++d) {
        node.bb_min[d] = std::min(node.bb_min[d], p[d]);
        node.bb_max[d] = std::max(node.bb_max[d], p[d]);
      }
    }
    if (end - start <= kLeaf) {
      nodes_.push_back(node);
      return static_cast<int32_t>(nodes_.size() - 1);
    }
    int axis = 0;
    double ext = -1;
    for (int d = 0; d < 3; ++d) {
      double e = node.bb_max[d] - node.bb_min[d];
      if (e > ext) { ext = e; axis = d; }
    }
    int64_t mid = (start + end) / 2;
    std::nth_element(idx_.begin() + start, idx_.begin() + mid,
                     idx_.begin() + end,
                     [&](int64_t a, int64_t b) {
                       return pts_[3 * a + axis] < pts_[3 * b + axis];
                     });
    node.axis = static_cast<int8_t>(axis);
    node.split = pts_[3 * idx_[mid] + axis];
    int32_t self = static_cast<int32_t>(nodes_.size());
    nodes_.push_back(node);
    int32_t l = build(start, mid);
    int32_t r = build(mid, end);
    nodes_[self].left = l;
    nodes_[self].right = r;
    return self;
  }

  static double box_dist_sq(const Node& n, const double* q) {
    double s = 0;
    for (int d = 0; d < 3; ++d) {
      double v = 0;
      if (q[d] < n.bb_min[d]) v = n.bb_min[d] - q[d];
      else if (q[d] > n.bb_max[d]) v = q[d] - n.bb_max[d];
      s += v * v;
    }
    return s;
  }

  void search(int32_t ni, const double* q, double& best) const {
    const Node& node = nodes_[ni];
    if (box_dist_sq(node, q) >= best) return;
    if (node.axis < 0) {
      for (int32_t i = node.start; i < node.end; ++i) {
        const double* p = pts_ + 3 * idx_[i];
        double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        double d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best) best = d2;
      }
      return;
    }
    int32_t first = node.left, second = node.right;
    if (q[node.axis] > node.split) std::swap(first, second);
    search(first, q, best);
    search(second, q, best);
  }

  void radius_search(int32_t ni, const double* q, double r2,
                     std::vector<int64_t>* out) const {
    const Node& node = nodes_[ni];
    if (box_dist_sq(node, q) > r2) return;
    if (node.axis < 0) {
      for (int32_t i = node.start; i < node.end; ++i) {
        const double* p = pts_ + 3 * idx_[i];
        double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        if (dx * dx + dy * dy + dz * dz <= r2) out->push_back(idx_[i]);
      }
      return;
    }
    radius_search(node.left, q, r2, out);
    radius_search(node.right, q, r2, out);
  }

  const double* pts_;
  int64_t n_;
  std::vector<int64_t> idx_;
  std::vector<Node> nodes_;
  int32_t root_ = -1;
};

void parallel_for(int64_t n, int threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (threads <= 1 || n < 1024) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t s = t * chunk, e = std::min<int64_t>(n, s + chunk);
    if (s >= e) break;
    pool.emplace_back([&, s, e] { fn(s, e); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void* kdtree_build(const double* points, int64_t n) {
  return new KDTree(points, n);
}

void kdtree_free(void* handle) { delete static_cast<KDTree*>(handle); }

void kdtree_nn(void* handle, const double* queries, int64_t m,
               double maxdist, double* out, int threads) {
  auto* tree = static_cast<KDTree*>(handle);
  double bound_sq = maxdist * maxdist;
  parallel_for(m, threads, [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; ++i) {
      double d2 = tree->nn_sq(queries + 3 * i, bound_sq);
      out[i] = std::sqrt(d2);
    }
  });
}

// Random-order radius dedup: keep[order[j]] stays 1, everything within
// `radius` of it is cleared (matching metrics.py:38-64 semantics).
void kdtree_radius_dedup(const double* points, int64_t n, double radius,
                         const int64_t* order, uint8_t* keep) {
  KDTree tree(points, n);
  std::memset(keep, 1, n);
  std::vector<int64_t> neigh;
  for (int64_t j = 0; j < n; ++j) {
    int64_t id = order[j];
    if (!keep[id]) continue;
    neigh.clear();
    tree.radius(points + 3 * id, radius, &neigh);
    for (int64_t k : neigh) keep[k] = 0;
    keep[id] = 1;
  }
}

}  // extern "C"
