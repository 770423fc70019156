// The SD-tree descents of a guided bounce: K3, the spatial lookup with the
// dtree's per-bounce scalars, and K4, the quadtree sample-and-pdf walk.
//
// K3 (ppg_sd_lookup) replaces ppg_tpu/guiding/sdtree.py::lookup (:166),
// dtree_meta (:215) and sampling_fraction (:783); K4 (ppg_sd_sample_pdf)
// replaces sample_pdf_dir (:667) and pdf_dir2 (:770). ppg_tpu runs them as
// XLA scans over multi-level packed tables (4 spatial levels per [L,32]
// row, 2 quadtree levels per [L,52] row), which exist to cut the TPU's
// gather count; no Pallas version of them exists. The semantics are those
// of the plain versions in ppg_tpu_torch/guiding/sdtree.py, level for
// level:
// - K3: x = clamp((p - aabb_min) / aabb_size, 0, 1) (NaN stays NaN, as
//   torch.clamp keeps it), then from node 0 while s_dtree[node] < 0 and
//   fewer than s_depth levels: axis = level % 3, hi = x[axis] >= 0.5,
//   x[axis] = hi ? (x[axis] - 0.5) * 2 : x[axis] * 2, the voxel's side on
//   that axis halves, node = s_child[node][hi]. The id is s_dtree[node];
//   outside the optional mask it is -1. The meta of that id (clamped to 0
//   for the reads): root = ds_root, uniform = !(sum * INV_FOURPI /
//   max(statw, 1e-38) > 0) | statw <= 0 | id < 0, frac = id >= 0 ?
//   1 / (1 + expf(-opt_var)) : 0.5, ATen's sigmoid formula on a card. With
//   ids given, K3 writes the meta of those ids and does not descend.
// - K4: from root, while fewer than q_depth levels: the node's four sums
//   s (added ((s0 + s1) + s2) + s3, the plain version's order) and
//   children; a sum that is not > 0 is degenerate and kills the lane (pdf
//   0). A sampling lane picks the quadrant by the conditional CDF with
//   u[level]; a point lane (is_point, or every lane in point mode) by its
//   point, which it then rescales into the quadrant. acc *= 4 s_q / total
//   (0 where s_q <= 0), origin += scale * (bx, by) / 2, scale /= 2, and a
//   leaf quadrant (child < 0) ends the walk. pdf = dead ? 0 : acc *
//   INV_FOURPI; pfin = clamp(origin + scale * u[20:22], 0, 1). Uniform
//   lanes get pdf INV_FOURPI and pfin u[20:22], so they walk nothing.
// Both walks stop at the leaf, where the plain versions run every level:
// a lane that is done changes no state after that, so the results are the
// same. Every product, sum and quotient is rounded on its own (the file is
// built with --fmad=false, guiding/descent.py), each clamp is a compare
// and a select as torch.clamp behaves (fminf/fmaxf would drop a NaN), and
// no fast-math flag is set: the clamps to 1e-38 are subnormal and would
// flush to 0 under -ftz=true. So the ids, voxels, roots, uniform flags,
// canonical points and pdfs equal the plain versions' bit for bit; frac
// goes through the CUDA math library's expf, as torch.sigmoid on a card
// does.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s FP32), counted as
// chip_smoke.py does from what the plain walks need on a render's lanes:
// the FP32 operations are a few per spatial level and about 25 per
// quadtree level, the bytes each lane's inputs and outputs once (K3: 12 B
// of position and 1 of mask in, 21 B out; K4: 8 B of point, 4 of root, 2
// flags and one uniform per level walked plus two in, 12 B out) plus the
// distinct rows the walks read (12 B per spatial node, 32 per quadtree
// node, 16 per dtree's meta). Bytes bound both, at a few microseconds for
// L = 262,144. Neither kernel can come near that: a lane's levels are a
// chain of dependent loads (up to s_depth + q_depth of them, each from an
// address the previous one gave), served by L2, since the trees are far
// smaller than its 50 MB. So the time is the chain's latency, and the
// design is what hides latency: one thread per lane holding its whole
// state in registers (no local memory, no shared memory), small blocks so
// that many warps are resident to overlap their chains, a lane that stops
// at its leaf, uniform lanes that read no row, and one 16-byte __ldg for a
// node's four sums and one for its four children.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int U_COLS = 22;  // = sdtree.MAX_Q_DEPTH + 2
constexpr int U_LEAF = 20;  // the leaf cell's two uniforms
constexpr float CLAMP_MIN = 1e-38f;
constexpr float INV_FOURPI =
    static_cast<float>(1.0 / (4.0 * 3.14159265358979323846));

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;
}
// torch.clamp(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float x) {
    return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

struct LookupArgs {
    const float* p;          // [L,3], contiguous; unused with ids
    const float* aabb_min;   // [3]
    const float* aabb_size;  // one value, the cube's side
    const int32_t* s_child;  // [S,2]
    const int32_t* s_dtree;  // [S]
    int s_depth;
    const uint8_t* mask;     // [L] or null (every lane)
    const int32_t* ids;      // [L]: the meta of these ids, no descent; or null
    const int32_t* ds_root;  // [T]
    const float* ds_sum;     // [T]
    const float* ds_statw;   // [T]
    const float* opt_var;    // [T]
    int L;
    int32_t* out_id;         // [L] (not with ids)
    float* out_voxel;        // [L,3] (not with ids)
    int32_t* out_root;       // [L], or null: no meta
    uint8_t* out_uniform;    // [L]
    float* out_frac;         // [L]
};

__global__ void __launch_bounds__(BLOCK) lookup_kernel(const LookupArgs a) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= a.L) return;
    int id;
    if (a.ids != nullptr) {
        id = __ldg(a.ids + i);
    } else {
        const float side = __ldg(a.aabb_size);
        float x[3];
        for (int k = 0; k < 3; ++k)
            x[k] = clamp01((__ldg(a.p + 3 * i + k) - __ldg(a.aabb_min + k)) /
                           side);
        // the axis of the current level is always xa; the three rotate
        // after each level, so no register array is indexed at run time
        float xa = x[0], xb = x[1], xc = x[2];
        float sa = side, sb = side, sc = side;
        int node = 0, dt = __ldg(a.s_dtree), level = 0;
        for (; level < a.s_depth && dt < 0; ++level) {
            const bool hi = xa >= 0.5f;
            const float xn = hi ? (xa - 0.5f) * 2.0f : xa * 2.0f;
            const float sn = sa * 0.5f;
            node = __ldg(a.s_child + 2 * node + (hi ? 1 : 0));
            dt = __ldg(a.s_dtree + node);
            xa = xb, xb = xc, xc = xn;
            sa = sb, sb = sc, sc = sn;
        }
        // after `level` levels sa holds the side of axis level % 3
        const int r = level % 3;
        float* v = a.out_voxel + 3 * i;
        v[0] = r == 0 ? sa : (r == 1 ? sc : sb);
        v[1] = r == 0 ? sb : (r == 1 ? sa : sc);
        v[2] = r == 0 ? sc : (r == 1 ? sb : sa);
        if (a.mask != nullptr && a.mask[i] == 0) dt = -1;
        id = dt;
        a.out_id[i] = id;
    }
    if (a.out_root == nullptr) return;
    const int j = id < 0 ? 0 : id;
    const float statw = __ldg(a.ds_statw + j);
    const float mean =
        (__ldg(a.ds_sum + j) * INV_FOURPI) / clamp_min(statw, CLAMP_MIN);
    a.out_root[i] = __ldg(a.ds_root + j);
    a.out_uniform[i] = (!(mean > 0.0f) || statw <= 0.0f || id < 0) ? 1 : 0;
    a.out_frac[i] =
        id >= 0 ? 1.0f / (1.0f + expf(-__ldg(a.opt_var + j))) : 0.5f;
}

struct WalkArgs {
    const float4* qs_sum;    // [Q] rows of four sums, on 16 bytes
    const int4* qs_child;    // [Q] rows of four children, on 16 bytes
    int Q, q_depth;
    const float* u;          // [L,22], or null: point mode
    const uint8_t* is_point; // [L] (not in point mode)
    const float* pp;         // [L,2] canonical points
    const int32_t* root;     // [L]
    const uint8_t* uniform;  // [L]
    int L;
    float* out_p;            // [L,2] (not in point mode)
    float* out_pdf;          // [L]
};

__device__ __forceinline__ float pick(float4 s, bool bx, bool by) {
    return by ? (bx ? s.w : s.z) : (bx ? s.y : s.x);
}
__device__ __forceinline__ int pick(int4 k, bool bx, bool by) {
    return by ? (bx ? k.w : k.z) : (bx ? k.y : k.x);
}

__global__ void __launch_bounds__(BLOCK) walk_kernel(const WalkArgs a) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= a.L) return;
    const float* u = a.u != nullptr ? a.u + (size_t)U_COLS * i : nullptr;
    if (a.uniform[i] != 0) {
        a.out_pdf[i] = INV_FOURPI;
        if (u != nullptr) {
            a.out_p[2 * i] = __ldg(u + U_LEAF);
            a.out_p[2 * i + 1] = __ldg(u + U_LEAF + 1);
        }
        return;
    }
    const bool point = u == nullptr || a.is_point[i] != 0;
    float px = __ldg(a.pp + 2 * i), py = __ldg(a.pp + 2 * i + 1);
    float ox = 0.0f, oy = 0.0f, scale = 1.0f, acc = 1.0f;
    bool dead = false;
    int node = __ldg(a.root + i);
    for (int level = 0; level < a.q_depth; ++level) {
        // a root outside the pool (HostSDTree never makes one) ends the
        // walk as a degenerate node does
        if (node < 0 || node >= a.Q) {
            dead = true;
            break;
        }
        const float4 s = __ldg(a.qs_sum + node);
        const int4 k = __ldg(a.qs_child + node);
        const float total = ((s.x + s.y) + s.z) + s.w;
        if (!(total > 0.0f)) {  // degenerate: the lane dies where it is
            dead = true;
            break;
        }
        const float tc = clamp_min(total, CLAMP_MIN);
        bool bx, by;
        if (point) {
            bx = px >= 0.5f;
            by = py >= 0.5f;
            px = bx ? (px - 0.5f) * 2.0f : px * 2.0f;
            py = by ? (py - 0.5f) * 2.0f : py * 2.0f;
        } else {  // the conditional CDF: left/right, then bottom/top
            const float sm = __ldg(u + level);
            const float partial = s.x + s.z;
            const float boundary = partial / tc;
            bx = sm >= boundary;
            const float sm1 =
                bx ? (sm - boundary) / clamp_min(1.0f - boundary, CLAMP_MIN)
                   : sm / clamp_min(boundary, CLAMP_MIN);
            const float part2 = bx ? total - partial : partial;
            const float bnd2 = (bx ? s.y : s.x) / clamp_min(part2, CLAMP_MIN);
            by = sm1 >= bnd2;
        }
        const float sq = pick(s, bx, by);
        acc = acc * (sq > 0.0f ? (4.0f * sq) / tc : 0.0f);
        ox = ox + scale * (bx ? 0.5f : 0.0f);
        oy = oy + scale * (by ? 0.5f : 0.0f);
        scale = scale * 0.5f;
        const int child = pick(k, bx, by);
        if (child < 0) break;  // a leaf quadrant
        node = child;
    }
    a.out_pdf[i] = dead ? 0.0f : acc * INV_FOURPI;
    if (u != nullptr) {
        a.out_p[2 * i] = clamp01(ox + scale * __ldg(u + U_LEAF));
        a.out_p[2 * i + 1] = clamp01(oy + scale * __ldg(u + U_LEAF + 1));
    }
}

int grid_for(int L) { return (L + BLOCK - 1) / BLOCK; }

// Runs on card `device` and returns cudaGetLastError() as an int.
template <class F>
int on_device(int device, F launch) {
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    launch();
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}

}  // namespace

// K3 on `stream` of card `device`; returns cudaGetLastError() as an int
// (0 = launched). Every array is contiguous; see LookupArgs for shapes.
// With ids non-null it writes only root, uniform and frac of those ids;
// with out_root null it writes only the id and the voxel.
extern "C" int ppg_sd_lookup(const float* p, const float* aabb_min,
                             const float* aabb_size, const int32_t* s_child,
                             const int32_t* s_dtree, int s_depth,
                             const uint8_t* mask, const int32_t* ids,
                             const int32_t* ds_root, const float* ds_sum,
                             const float* ds_statw, const float* opt_var,
                             int L, int32_t* out_id, float* out_voxel,
                             int32_t* out_root, uint8_t* out_uniform,
                             float* out_frac, int device, void* stream) {
    if (L <= 0) return 0;
    const LookupArgs a{p,      aabb_min, aabb_size, s_child,  s_dtree,
                       s_depth, mask,    ids,       ds_root,  ds_sum,
                       ds_statw, opt_var, L,        out_id,   out_voxel,
                       out_root, out_uniform, out_frac};
    const int grid = grid_for(L);
    return on_device(device, [&] {
        lookup_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    });
}

// K4 on `stream` of card `device`; returns cudaGetLastError() as an int.
// qs_sum and qs_child: [Q,4] contiguous, each on 16 bytes. With u null
// (point mode) every lane descends at its point and only the pdf is
// written; is_point and out_p are then unused.
extern "C" int ppg_sd_sample_pdf(const float* qs_sum, const int32_t* qs_child,
                                 int Q, int q_depth, const float* u,
                                 const uint8_t* is_point, const float* pp,
                                 const int32_t* root, const uint8_t* uniform,
                                 int L, float* out_p, float* out_pdf,
                                 int device, void* stream) {
    if (L <= 0) return 0;
    const WalkArgs a{reinterpret_cast<const float4*>(qs_sum),
                     reinterpret_cast<const int4*>(qs_child),
                     Q, q_depth, u, is_point, pp, root, uniform, L, out_p,
                     out_pdf};
    const int grid = grid_for(L);
    return on_device(device, [&] {
        walk_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    });
}
