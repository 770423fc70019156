// Native binned-SAH BVH builder: binary SAH build, collapsed to a
// W-wide BVH (packed SoA float rows) for the TPU wavefront walk.
//
// Plays the role of the reference's parallel SAH kd-tree builder
// (mitsuba/include/mitsuba/render/gkdtree.h:709-1954): full-sweep binned
// SAH over 16 bins per axis, multithreaded over subtrees. The binary
// tree is collapsed into W-ary rows (internal: W child AABBs + child
// infos in SoA W-blocks; leaf: up to K Woop triangles in SoA K-blocks)
// consumed by ../traverse.py's ordered group-stack traversal. W and K
// are runtime parameters of ppg_bvhw_build (W<=32: the traversal's
// pending mask is one int32); on-TPU gather cost is dominated by a
// per-row fee (~10 ns/lane) that is nearly width-independent, so wide
// rows buy a shallower walk nearly for free.
//
// C ABI (ctypes): two-phase — build into an internal arena, then copy out.
//
// Build: c++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//        bvh_builder.cpp -o libppgbvh.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int N_BINS = 16;
constexpr float INF = std::numeric_limits<float>::infinity();

struct V3 {
  float x, y, z;
  V3() : x(0), y(0), z(0) {}
  V3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
  V3 lo{INF, INF, INF}, hi{-INF, -INF, -INF};
  void grow(const AABB &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const V3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    if (hi.x < lo.x) return 0.f;
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct BuildNode {
  AABB box;
  int left = -1;   // child index (right = left subtree's DFS successor)
  int right = -1;
  int first = 0, count = 0;  // leaf prim range
};

struct Builder {
  const float *verts;
  const int *faces;
  int max_leaf;
  std::vector<V3> centroid;
  std::vector<AABB> prim_box;
  std::vector<int> prim_ids;
  std::vector<BuildNode> nodes;
  std::mutex node_mu;
  std::atomic<int> threads_live{1};
  int max_threads = 1;

  int alloc_node() {
    std::lock_guard<std::mutex> g(node_mu);
    nodes.emplace_back();
    return (int)nodes.size() - 1;
  }

  // Median split on the largest centroid axis (degenerate/depth fallback).
  int median_split(int first, int count) {
    AABB cbox;
    for (int i = 0; i < count; ++i) cbox.grow(centroid[prim_ids[first + i]]);
    int axis = 0;
    float ext = cbox.hi.x - cbox.lo.x;
    if (cbox.hi.y - cbox.lo.y > ext) { axis = 1; ext = cbox.hi.y - cbox.lo.y; }
    if (cbox.hi.z - cbox.lo.z > ext) axis = 2;
    int *b0 = prim_ids.data() + first;
    std::nth_element(b0, b0 + count / 2, b0 + count, [&](int a, int b) {
      return centroid[a][axis] < centroid[b][axis];
    });
    return count / 2;
  }

  // SAH split of prim_ids[first, first+count); returns mid or -1 for leaf.
  // Guarantees a split whenever count > max_leaf (median fallback), and
  // forces median splits when the remaining depth budget gets tight so
  // tree depth stays <= 62 (the traversal bitstack is 64 wide).
  int split(const AABB &box, int first, int count, int depth, int &axis_out) {
    if (count <= max_leaf) return -1;
    axis_out = 0;
    int need = 0;
    for (int c = count; c > max_leaf; c = (c + 1) / 2) ++need;  // log2 bound
    if (depth + need >= 62) return median_split(first, count);
    AABB cbox;
    for (int i = 0; i < count; ++i) cbox.grow(centroid[prim_ids[first + i]]);
    float best_cost = INF;
    int best_axis = -1, best_bin = -1;
    for (int axis = 0; axis < 3; ++axis) {
      float lo = cbox.lo[axis], hi = cbox.hi[axis];
      if (hi - lo < 1e-12f) continue;
      float inv = N_BINS / (hi - lo);
      AABB bins[N_BINS];
      int cnt[N_BINS] = {0};
      for (int i = 0; i < count; ++i) {
        int id = prim_ids[first + i];
        int b = (int)((centroid[id][axis] - lo) * inv);
        b = std::min(std::max(b, 0), N_BINS - 1);
        bins[b].grow(prim_box[id]);
        cnt[b]++;
      }
      AABB right[N_BINS];
      AABB acc;
      for (int b = N_BINS - 1; b > 0; --b) {
        acc.grow(bins[b]);
        right[b] = acc;
      }
      AABB lacc;
      int lcnt = 0;
      for (int b = 0; b < N_BINS - 1; ++b) {
        lacc.grow(bins[b]);
        lcnt += cnt[b];
        int rcnt = count - lcnt;
        if (lcnt == 0 || rcnt == 0) continue;
        float cost = lacc.area() * lcnt + right[b + 1].area() * rcnt;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }
    // degenerate (all centroids coincide): median fallback, never a fat leaf
    if (best_axis < 0) return median_split(first, count);

    float lo = cbox.lo[best_axis];
    float inv = N_BINS / (cbox.hi[best_axis] - lo);
    int *b0 = prim_ids.data() + first;
    int *mid = std::partition(b0, b0 + count, [&](int id) {
      int b = (int)((centroid[id][best_axis] - lo) * inv);
      b = std::min(std::max(b, 0), N_BINS - 1);
      return b <= best_bin;
    });
    int m = (int)(mid - b0);
    if (m == 0 || m == count) m = count / 2;  // degenerate: median fallback
    axis_out = best_axis;
    return m;
  }

  void build_range(int node_idx, int first, int count, const AABB &box,
                   int depth) {
    int axis, m = split(box, first, count, depth, axis);
    if (m < 0) {
      std::lock_guard<std::mutex> g(node_mu);
      nodes[node_idx].box = box;
      nodes[node_idx].first = first;
      nodes[node_idx].count = count;
      return;
    }
    AABB lbox, rbox;
    for (int i = 0; i < m; ++i) lbox.grow(prim_box[prim_ids[first + i]]);
    for (int i = m; i < count; ++i) rbox.grow(prim_box[prim_ids[first + i]]);
    int li = alloc_node(), ri = alloc_node();
    {
      std::lock_guard<std::mutex> g(node_mu);
      nodes[node_idx].box = box;
      nodes[node_idx].left = li;
      nodes[node_idx].right = ri;
    }
    bool spawn = count > 16384 && depth < 5 &&
                 threads_live.load() < max_threads;
    if (spawn) {
      threads_live++;
      std::thread t([=] {
        build_range(li, first, m, lbox, depth + 1);
        threads_live--;
      });
      build_range(ri, first + m, count - m, rbox, depth + 1);
      t.join();
    } else {
      build_range(li, first, m, lbox, depth + 1);
      build_range(ri, first + m, count - m, rbox, depth + 1);
    }
  }
};

// DFS flattening with miss links.
struct Flat {
  std::vector<float> node_min, node_max;
  std::vector<uint8_t> is_leaf;
  std::vector<int32_t> leaf_off, leaf_cnt, miss;
  std::vector<int32_t> prim_out;
};

// Subtree sizes (node counts) via iterative post-order.
void compute_sizes(const Builder &b, int root, std::vector<int> &size) {
  size.assign(b.nodes.size(), 1);
  std::vector<std::pair<int, int>> st;  // (node, state)
  st.push_back({root, 0});
  while (!st.empty()) {
    auto [idx, state] = st.back();  // copy: push_back below may reallocate
    const BuildNode &n = b.nodes[idx];
    if (n.left < 0) {
      st.pop_back();
    } else if (state == 0) {
      st.back().second = 1;
      st.push_back({n.left, 0});
    } else if (state == 1) {
      st.back().second = 2;
      st.push_back({n.right, 0});
    } else {
      size[idx] = 1 + size[n.left] + size[n.right];
      st.pop_back();
    }
  }
}

// Pre-order emission: node i's hit-successor is i+1 (left child); the
// left subtree's miss link is the right child's index i+1+size(left);
// the right subtree inherits the parent's miss link.
void flatten(const Builder &b, int root, int sentinel, Flat &f) {
  std::vector<int> size;
  compute_sizes(b, root, size);
  std::vector<std::pair<int, int>> st;  // (src, miss)
  st.push_back({root, sentinel});
  while (!st.empty()) {
    auto [src, miss] = st.back();
    st.pop_back();
    const BuildNode &n = b.nodes[src];
    f.node_min.insert(f.node_min.end(), {n.box.lo.x, n.box.lo.y, n.box.lo.z});
    f.node_max.insert(f.node_max.end(), {n.box.hi.x, n.box.hi.y, n.box.hi.z});
    f.miss.push_back(miss);
    if (n.left < 0) {
      f.is_leaf.push_back(1);
      f.leaf_off.push_back((int)f.prim_out.size());
      f.leaf_cnt.push_back(n.count);
      for (int i = 0; i < n.count; ++i)
        f.prim_out.push_back(b.prim_ids[n.first + i]);
    } else {
      f.is_leaf.push_back(0);
      f.leaf_off.push_back(0);
      f.leaf_cnt.push_back(0);
      int my_idx = (int)f.is_leaf.size() - 1;
      int right_idx = my_idx + 1 + size[n.left];
      st.push_back({n.right, miss});      // emitted after the left subtree
      st.push_back({n.left, right_idx});  // emitted next (hit successor)
    }
  }
}

Flat *g_flat = nullptr;

// ---------------------------------------------------------------------------
// Wide-BVH emission: collapse the binary tree into W-wide nodes, one
// packed row per node (CWBVH-flavored layout for single-gather TPU
// traversal; everything is SoA W-blocks so the consumer reads only
// lane-aligned [L,W] slices of the gathered block):
//   internal row: minx[W] miny[W] minz[W] maxx[W] maxy[W] maxz[W]
//     (SoA, cols 0..6W-1), child info i32 bitcast (cols 6W..7W-1;
//     0 = empty slot, bit30 = leaf), pad to ROW
//   leaf row: up to K woop triangles in SoA K-blocks p0x p0y p0z
//     e1x e1y e1z e2x e2y e2z (cols 0..9K-1), count (col 9K, i32),
//     packed tri base index (col 9K+1, i32)
//   ROW = max(7W, 9K+2)
// ---------------------------------------------------------------------------

constexpr int B8_LEAF_BIT = 1 << 30;
constexpr int B8_MAX_WIDE = 32;

struct Bvh8Out {
  std::vector<float> rows;
  std::vector<int32_t> prim_out;
  int row_len = 0;
};

struct Bvh8Emitter {
  const Builder &b;
  const float *verts;
  const int *faces;
  const int wide, max_tris, row_len;
  Bvh8Out out;

  Bvh8Emitter(const Builder &bb, const float *v, const int *f, int w, int k)
      : b(bb), verts(v), faces(f), wide(w), max_tris(k),
        row_len(std::max(7 * w, 9 * k + 2)) {
    out.row_len = row_len;
  }

  int alloc_row() {
    out.rows.resize(out.rows.size() + row_len, 0.0f);
    return (int)out.rows.size() / row_len - 1;
  }

  int emit_leaf(const BuildNode &n) {
    int r = alloc_row();
    float *row = out.rows.data() + (size_t)row_len * r;
    int base = (int)out.prim_out.size();
    for (int i = 0; i < n.count; ++i) {
      int id = b.prim_ids[n.first + i];
      const float *p0 = verts + 3 * faces[3 * id + 0];
      const float *p1 = verts + 3 * faces[3 * id + 1];
      const float *p2 = verts + 3 * faces[3 * id + 2];
      for (int k = 0; k < 3; ++k) {
        row[max_tris * k + i] = p0[k];                        // p0 blocks
        row[3 * max_tris + max_tris * k + i] = p1[k] - p0[k];  // e1 blocks
        row[6 * max_tris + max_tris * k + i] = p2[k] - p0[k];  // e2 blocks
      }
      out.prim_out.push_back(id);
    }
    int32_t cnt = n.count, bs = base;
    std::memcpy(row + 9 * max_tris, &cnt, 4);
    std::memcpy(row + 9 * max_tris + 1, &bs, 4);
    return r;
  }

  // Collapse: expand the internal node with the largest surface area until
  // all W slots are filled or all slots are leaves/unexpandable.
  int emit_node(const BuildNode &n) {
    if (n.left < 0) return emit_leaf(n);
    int slots[B8_MAX_WIDE];
    int n_slots = 0;
    slots[n_slots++] = n.left;
    slots[n_slots++] = n.right;
    while (n_slots < wide) {
      int pick = -1;
      float best = -1.f;
      for (int i = 0; i < n_slots; ++i) {
        const BuildNode &s = b.nodes[slots[i]];
        if (s.left < 0) continue;
        float a = s.box.area();
        if (a > best) {
          best = a;
          pick = i;
        }
      }
      if (pick < 0) break;
      const BuildNode &s = b.nodes[slots[pick]];
      slots[pick] = s.left;
      slots[n_slots++] = s.right;
    }
    int r = alloc_row();
    // recurse AFTER allocating this row so children land later; row data
    // written after children exist (need their row indices)
    int child_rows[B8_MAX_WIDE];
    for (int i = 0; i < n_slots; ++i)
      child_rows[i] = emit_node(b.nodes[slots[i]]);
    float *row = out.rows.data() + (size_t)row_len * r;  // vector reallocated
    for (int i = 0; i < wide; ++i) {
      if (i < n_slots) {
        const AABB &bx = b.nodes[slots[i]].box;
        row[0 * wide + i] = bx.lo.x;
        row[1 * wide + i] = bx.lo.y;
        row[2 * wide + i] = bx.lo.z;
        row[3 * wide + i] = bx.hi.x;
        row[4 * wide + i] = bx.hi.y;
        row[5 * wide + i] = bx.hi.z;
        int32_t info = child_rows[i];
        if (b.nodes[slots[i]].left < 0) info |= B8_LEAF_BIT;
        std::memcpy(row + 6 * wide + i, &info, 4);
      } else {
        // NaN boxes fail every slab comparison; info==0 marks empty
        // (row 0 is always the root, never a child)
        float qnan = std::numeric_limits<float>::quiet_NaN();
        row[0 * wide + i] = row[1 * wide + i] = row[2 * wide + i] = qnan;
        row[3 * wide + i] = row[4 * wide + i] = row[5 * wide + i] = qnan;
        int32_t zero = 0;
        std::memcpy(row + 6 * wide + i, &zero, 4);
      }
    }
    return r;
  }
};

Bvh8Out *g_bvh8 = nullptr;

}  // namespace

extern "C" {

// Builds the BVH; returns node count (0 on empty input). Results are
// held until the next call to ppg_bvh_copy/ppg_bvh_free.
int32_t ppg_bvh_build(const float *verts, int32_t n_verts, const int32_t *faces,
                      int32_t n_faces, int32_t max_leaf, int32_t n_threads) {
  (void)n_verts;
  delete g_flat;
  g_flat = new Flat();
  if (n_faces <= 0) return 0;

  Builder b;
  b.verts = verts;
  b.faces = faces;
  b.max_leaf = max_leaf;
  b.max_threads = std::max(1, (int)n_threads);
  b.centroid.resize(n_faces);
  b.prim_box.resize(n_faces);
  b.prim_ids.resize(n_faces);
  AABB root_box;
  for (int i = 0; i < n_faces; ++i) {
    b.prim_ids[i] = i;
    AABB bb;
    for (int k = 0; k < 3; ++k) {
      const float *p = verts + 3 * faces[3 * i + k];
      bb.grow(V3(p[0], p[1], p[2]));
    }
    b.prim_box[i] = bb;
    b.centroid[i] = V3(0.5f * (bb.lo.x + bb.hi.x), 0.5f * (bb.lo.y + bb.hi.y),
                       0.5f * (bb.lo.z + bb.hi.z));
    root_box.grow(bb);
  }
  b.nodes.reserve(2 * n_faces);
  int root = b.alloc_node();
  b.build_range(root, 0, n_faces, root_box, 0);

  int n_total = (int)b.nodes.size();  // exact: every alloc'd node is emitted
  g_flat->node_min.reserve(3 * n_total);
  flatten(b, root, n_total, *g_flat);
  return (int)g_flat->is_leaf.size();
}

// Builds a W-wide BVH (collapsed from a binary SAH build with
// <=max_tris-triangle leaves); returns the row count. Copy out with
// ppg_bvhw_copy; row length = max(7*wide, 9*max_tris+2).
int32_t ppg_bvhw_build(const float *verts, int32_t n_verts,
                       const int32_t *faces, int32_t n_faces,
                       int32_t n_threads, int32_t wide, int32_t max_tris) {
  (void)n_verts;
  delete g_bvh8;
  g_bvh8 = nullptr;
  if (n_faces <= 0) return 0;
  if (wide < 2 || wide > B8_MAX_WIDE || max_tris < 1) return -1;

  Builder b;
  b.verts = verts;
  b.faces = faces;
  b.max_leaf = max_tris;
  b.max_threads = std::max(1, (int)n_threads);
  b.centroid.resize(n_faces);
  b.prim_box.resize(n_faces);
  b.prim_ids.resize(n_faces);
  AABB root_box;
  for (int i = 0; i < n_faces; ++i) {
    b.prim_ids[i] = i;
    AABB bb;
    for (int k = 0; k < 3; ++k) {
      const float *p = verts + 3 * faces[3 * i + k];
      bb.grow(V3(p[0], p[1], p[2]));
    }
    b.prim_box[i] = bb;
    b.centroid[i] = V3(0.5f * (bb.lo.x + bb.hi.x), 0.5f * (bb.lo.y + bb.hi.y),
                       0.5f * (bb.lo.z + bb.hi.z));
    root_box.grow(bb);
  }
  b.nodes.reserve(2 * n_faces / max_tris + 16);
  int root = b.alloc_node();
  b.build_range(root, 0, n_faces, root_box, 0);

  Bvh8Emitter em(b, verts, faces, wide, max_tris);
  em.out.rows.reserve((size_t)b.nodes.size() * em.row_len / 2);
  em.out.prim_out.reserve(n_faces);
  if (b.nodes[root].left < 0) {
    em.emit_leaf(b.nodes[root]);
  } else {
    em.emit_node(b.nodes[root]);
  }
  int row_len = em.row_len;
  g_bvh8 = new Bvh8Out(std::move(em.out));
  return (int32_t)(g_bvh8->rows.size() / row_len);
}

void ppg_bvhw_copy(float *rows, int32_t *prim_ids) {
  std::memcpy(rows, g_bvh8->rows.data(), g_bvh8->rows.size() * 4);
  std::memcpy(prim_ids, g_bvh8->prim_out.data(),
              g_bvh8->prim_out.size() * 4);
  delete g_bvh8;
  g_bvh8 = nullptr;
}

void ppg_bvh_copy(float *node_min, float *node_max, uint8_t *is_leaf,
                  int32_t *leaf_off, int32_t *leaf_cnt, int32_t *miss,
                  int32_t *prim_ids) {
  Flat &f = *g_flat;
  std::memcpy(node_min, f.node_min.data(), f.node_min.size() * 4);
  std::memcpy(node_max, f.node_max.data(), f.node_max.size() * 4);
  std::memcpy(is_leaf, f.is_leaf.data(), f.is_leaf.size());
  std::memcpy(leaf_off, f.leaf_off.data(), f.leaf_off.size() * 4);
  std::memcpy(leaf_cnt, f.leaf_cnt.data(), f.leaf_cnt.size() * 4);
  std::memcpy(miss, f.miss.data(), f.miss.size() * 4);
  std::memcpy(prim_ids, f.prim_out.data(), f.prim_out.size() * 4);
  delete g_flat;
  g_flat = nullptr;
}

}  // extern "C"
