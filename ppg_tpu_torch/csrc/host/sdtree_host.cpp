// Native host-side SD-tree topology kernels: DTree::reset and
// DTree::build across all spatial leaves at once.
//
// Plays the role of the reference's per-leaf OpenMP topology loops
// (mitsuba/src/integrators/path/guided_path.cpp:924-933 driving
// DTree::reset :456-514 and DTree::build :520-533 /
// QuadTreeNode::build :346-366). The numpy fallback in ../host.py is
// level-synchronous and allocation-heavy (~10 array passes over pools
// that reach tens of millions of nodes in sdTreeMaxMemory regimes);
// this kernel is one fused pass, ~30 ns/node.
//
// Node numbering contract (shared with the numpy path, asserted equal
// by tests/test_host_scalability.py): per-dtree contiguous slabs in
// dtree order; within a slab, level (BFS) order, within a level the
// (parent, quadrant) creation order. Children always follow parents,
// which lets build() run one backward linear pass.
//
// C ABI (ctypes): reset is two-phase — build into an internal arena,
// then copy out. build() mutates the caller's arrays in place.
//
// Build: c++ -O3 -march=native -shared -fPIC -std=c++17
//        sdtree_host.cpp -o libppgsdt.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct FrontierNode {
  int64_t id;      // local node id within the tree's slab
  int64_t src;     // source node in the old sampling tree, -1 = virtual
  double s[4];     // quadrant sums (inherited sum/4 when virtual)
};

struct ResetArena {
  std::vector<int64_t> qb_child;  // [N*4]
  std::vector<int64_t> b_cnt;     // [T]
};

// persistent across calls: this host has ~60 MB/s first-touch page
// faults, so freed-and-remapped arenas would dominate every iteration
ResetArena g_reset;

}  // namespace

extern "C" {

// Rebuild the building-tree topology for every dtree from the sampling
// pools. Returns the total node count N (qb_child is [N,4]); fetch with
// ppg_sdt_reset_copy. Semantics mirror DTree::reset (guided_path.cpp
// :456-514): a quadrant subdivides when its energy fraction of the
// tree total exceeds `threshold` (fraction 0.25^depth when the total
// is zero), descending virtually past old leaves with sum/4
// inheritance, depth capped at max_depth levels and the per-tree node
// count at `cap` (:499-503; cap applies level-atomically like the
// numpy path).
int64_t ppg_sdt_reset(int64_t T, const double *totals, const int64_t *s_off,
                      const double *qs_sum, const int64_t *qs_child,
                      double threshold, int64_t max_depth, int64_t cap) {
  auto &child = g_reset.qb_child;
  auto &b_cnt = g_reset.b_cnt;
  child.clear();  // keeps capacity
  b_cnt.assign((size_t)T, 0);
  if (child.capacity() < (size_t)T * 8) child.reserve((size_t)T * 8);

  std::vector<FrontierNode> cur, next;
  for (int64_t t = 0; t < T; ++t) {
    const int64_t base = (int64_t)(child.size() / 4);
    const double tot = totals[t];
    int64_t count = 1;  // root
    child.insert(child.end(), 4, -1);

    cur.clear();
    FrontierNode root;
    root.id = 0;
    root.src = s_off[t];
    for (int q = 0; q < 4; ++q) root.s[q] = qs_sum[root.src * 4 + q];
    cur.push_back(root);

    for (int64_t level = 0; !cur.empty() && level + 1 < max_depth; ++level) {
      const double depth = (double)(level + 1);
      // the zero-total rule is uniform across the level: 0.25^depth
      const bool virt_split = std::pow(0.25, depth) > threshold;

      // count prospective children; the cap suppresses the whole level
      // for this tree if it would overflow (matches the numpy path)
      int64_t n_new = 0;
      for (const auto &n : cur)
        for (int q = 0; q < 4; ++q) {
          const bool sub = tot > 0.0 ? (n.s[q] / tot > threshold) : virt_split;
          n_new += sub;
        }
      if (n_new == 0 || count + n_new > cap) break;

      next.clear();
      next.reserve(n_new);
      for (const auto &n : cur)
        for (int q = 0; q < 4; ++q) {
          const bool sub = tot > 0.0 ? (n.s[q] / tot > threshold) : virt_split;
          if (!sub) continue;
          FrontierNode k;
          k.id = count++;
          k.src = n.src >= 0 ? qs_child[n.src * 4 + q] : -1;
          if (k.src >= 0) {
            for (int c = 0; c < 4; ++c) k.s[c] = qs_sum[k.src * 4 + c];
          } else {
            const double quarter = n.s[q] / 4.0;
            for (int c = 0; c < 4; ++c) k.s[c] = quarter;
          }
          child[(size_t)((base + n.id) * 4 + q)] = base + k.id;
          child.insert(child.end(), 4, -1);
          next.push_back(k);
        }
      cur.swap(next);
    }
    b_cnt[t] = count;
  }
  return (int64_t)(child.size() / 4);
}

void ppg_sdt_reset_copy(int64_t *qb_child, int64_t *b_cnt) {
  std::memcpy(qb_child, g_reset.qb_child.data(),
              g_reset.qb_child.size() * sizeof(int64_t));
  std::memcpy(b_cnt, g_reset.b_cnt.data(),
              g_reset.b_cnt.size() * sizeof(int64_t));
}

// STree::refine pool regather (the data movement of STreeNode::subdivide,
// guided_path.cpp:876-895): new dtree j copies source dtree src[j]'s slab
// (rows off[src[j]] .. +cnt[src[j]]) and shifts child links into the new
// slab at n_off[j]. One fused pass, no index temporaries — the numpy
// formulation materialized three node-pool-sized intermediates per call,
// and growing process RSS measures ~45 MB/s on this host.
void ppg_sdt_regather(int64_t T_new, const int64_t *src, const int64_t *off,
                      const int64_t *cnt, const double *q_sum,
                      const int64_t *q_child, const int64_t *n_off,
                      double *out_sum, int64_t *out_child) {
  for (int64_t j = 0; j < T_new; ++j) {
    const int64_t s = src[j];
    const int64_t so = off[s], c = cnt[s], base = n_off[j];
    const int64_t shift = base - so;
    std::memcpy(out_sum + base * 4, q_sum + so * 4,
                (size_t)c * 4 * sizeof(double));
    const int64_t *in = q_child + so * 4;
    int64_t *out = out_child + base * 4;
    for (int64_t k = 0; k < c * 4; ++k)
      out[k] = in[k] < 0 ? -1 : in[k] + shift;
  }
}

// QuadTreeNode::build (:346-366) + DTree::build (:520-533) over every
// slab: internal quadrant sums become their child subtree's total
// (children always follow parents, so one backward pass suffices),
// sum_s[t] = root total, maxdepth[t] = deepest node level + 1.
// Push box-splat residuals sitting on INTERNAL quadrants down to the
// leaves (quarter per child quadrant, level by level). Forward index
// order suffices: the numbering contract puts children after parents.
// One linear pass, in place — the numpy level loop this replaces cost
// ~6.5 s of CPU at 10M nodes when residuals are dense.
void ppg_sdt_pushdown(int64_t N, double *qb_sum, const int64_t *qb_child) {
  for (int64_t i = 0; i < N; ++i)
    for (int q = 0; q < 4; ++q) {
      const int64_t c = qb_child[i * 4 + q];
      const double r = qb_sum[i * 4 + q];
      if (c >= 0 && r != 0.0) {
        const double s = r * 0.25;
        qb_sum[c * 4 + 0] += s;
        qb_sum[c * 4 + 1] += s;
        qb_sum[c * 4 + 2] += s;
        qb_sum[c * 4 + 3] += s;
        qb_sum[i * 4 + q] = 0.0;
      }
    }
}

void ppg_sdt_build(int64_t N, int64_t T, double *qb_sum,
                   const int64_t *qb_child, const int64_t *b_off,
                   const int64_t *b_cnt, double *sum_s, int64_t *maxdepth) {
  for (int64_t i = N - 1; i >= 0; --i)
    for (int q = 0; q < 4; ++q) {
      const int64_t c = qb_child[i * 4 + q];
      if (c >= 0)
        qb_sum[i * 4 + q] = ((qb_sum[c * 4 + 0] + qb_sum[c * 4 + 1]) +
                             qb_sum[c * 4 + 2]) +
                            qb_sum[c * 4 + 3];
    }

  std::vector<int32_t> depth;
  for (int64_t t = 0; t < T; ++t) {
    const int64_t off = b_off[t], cnt = b_cnt[t];
    depth.assign((size_t)cnt, 0);
    int32_t md = 0;
    for (int64_t i = 0; i < cnt; ++i) {
      const int32_t d = depth[(size_t)i];
      for (int q = 0; q < 4; ++q) {
        const int64_t c = qb_child[(off + i) * 4 + q];
        if (c >= 0) {
          depth[(size_t)(c - off)] = d + 1;
          if (d + 1 > md) md = d + 1;
        }
      }
    }
    maxdepth[t] = md + 1;
    sum_s[t] = ((qb_sum[off * 4 + 0] + qb_sum[off * 4 + 1]) +
                qb_sum[off * 4 + 2]) +
               qb_sum[off * 4 + 3];
  }
}

}  // extern "C"
