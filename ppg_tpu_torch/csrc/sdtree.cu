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
//   children (its row of qs_row); a sum that is not > 0 is degenerate and kills the lane (pdf
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
// at its leaf, and uniform lanes that read no row.
//
// K4's design. With every lane resident at once, K4's chains are
// short (3.85 levels on average on phase 9's tree, at most 8), and what
// took its time was the L2 sectors its scattered loads touch: a level
// read the node's sums and children from two tables (two 32-byte sectors)
// and the lane's uniform from a row of 88 bytes ([L,22]), so the 32 lanes
// of a warp touched 32 sectors for 32 floats. Now a node is one 32-byte
// row, qs_row (its sums' bits, then its children; built where the tree
// reaches the card), read with two 16-byte loads of one sector, and the
// uniforms are level-major ([22, L], read through the strides given):
// a warp's uniforms of one level are one 128-byte line. Alone on phase 9's
// 262,144 lanes (k1_compare.py --kernel k4, NVIDIA H100 80GB HBM3,
// 700 W, parent and this design in turns in one run): 0.0216 ms before,
// 0.0184 with the row alone, 0.0148 with the row and level-major
// uniforms (bound 0.0040); point mode, which reads no uniforms, 0.0098
// → 0.0082 (bound 0.0018). 40 registers, no spill, per level two 16-byte
// loads of the row and one 4-byte load of a uniform, as before.
//
// K3's design. A spatial level used to be two dependent 4-byte loads, the
// child (s_child) and then its dtree id (s_dtree), whose sign decides
// whether the walk goes on; phase 9's lanes walk 11.5 levels on average
// (at most 16). Now a node is one 16-byte row, s_row {child 0, child 1,
// the dtree id of each}, so a level is one load; and since the levels'
// axes cycle x, y, z, the halves of the next three levels are known
// before any load, so a walk takes three levels a load from s_oct: eight
// 8-byte entries a node, one per octant of those halves, each the node
// three levels down (or the leaf where the walk stopped) times 4 plus the
// levels taken, and its dtree id. Only the axes of the levels taken are
// rescaled, in the levels' order, so every rounding is the plain
// version's; while fewer than three levels remain before s_depth, the
// walk goes on a level a load. The meta is one 16-byte row, ds_row
// {ds_root, bits of ds_sum, bits of ds_statw, 0}, and opt_var, which the
// Adam batches replace while the tree is sampled. guiding/descent.py
// builds the rows where the tree reaches the card. Phase 9's lanes then
// make 4.16 loads on average for the walk (at most 6). Alone on them
// (k1_compare.py --kernel k3, NVIDIA H100 80GB HBM3, 700 W, the former
// design and this one in turns in one run): with the meta 0.0103-0.0104
// ms before, 0.0065-0.0066 now (bound 0.0030), and 0.0093 with the rows
// alone, a level a load, as measured before the octant entries were
// kept; the lookup alone 0.0089 → 0.0050 (0.0078 with the rows alone);
// the meta of given ids 0.0036-0.0038 either way. 25 registers, no
// spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
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
    const int4* s_row;       // [S] {child 0, child 1, s_dtree of each}
    const int2* s_oct;       // [S,8] octant entries
    const int32_t* s_dtree;  // [S]: only the root's entry is read
    int s_depth;
    const uint8_t* mask;     // [L] or null (every lane)
    const int32_t* ids;      // [L]: the meta of these ids, no descent; or null
    const int4* ds_row;      // [T] {ds_root, bits of ds_sum, of ds_statw, 0}
    const float* opt_var;    // [T]
    int L;
    int32_t* out_id;         // [L] (not with ids)
    float* out_voxel;        // [L,3] (not with ids)
    int32_t* out_root;       // [L], or null: no meta
    uint8_t* out_uniform;    // [L]
    float* out_frac;         // [L]
};

// one spatial level on the axis of xa: the coordinate rescaled into the
// half it falls in, the side halved
__device__ __forceinline__ float rescale(float x) {
    return x >= 0.5f ? (x - 0.5f) * 2.0f : x * 2.0f;
}

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
        // three levels a load: the three levels' axes differ, so their
        // halves are known before the load; the entry says how many of
        // them the walk took. Fewer than three end at a leaf, and the
        // walk with it: then only the sides of the levels taken halve
        while (dt < 0 && level + 3 <= a.s_depth) {
            const int o = (xa >= 0.5f ? 1 : 0) | (xb >= 0.5f ? 2 : 0) |
                          (xc >= 0.5f ? 4 : 0);
            const int2 e = __ldg(a.s_oct + 8 * node + o);
            const int taken = e.x & 3;
            node = e.x >> 2;
            dt = e.y;
            level += taken;
            const float ha = sa * 0.5f, hb = sb * 0.5f;
            if (taken == 3) {
                xa = rescale(xa), xb = rescale(xb), xc = rescale(xc);
                sa = ha, sb = hb, sc = sc * 0.5f;
            } else if (taken == 2) {
                sa = sc, sb = ha, sc = hb;
            } else {
                sa = sb, sb = sc, sc = ha;
            }
        }
        // the levels left before s_depth, a level a load: the node's row
        // gives the child and its dtree id
        for (; level < a.s_depth && dt < 0; ++level) {
            const bool hi = xa >= 0.5f;
            const int4 r = __ldg(a.s_row + node);
            node = hi ? r.y : r.x;
            dt = hi ? r.w : r.z;
            const float xn = rescale(xa), sn = sa * 0.5f;
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
    const int4 m = __ldg(a.ds_row + j);  // the dtree's meta: one load
    const float statw = __int_as_float(m.z);
    const float mean =
        (__int_as_float(m.y) * INV_FOURPI) / clamp_min(statw, CLAMP_MIN);
    a.out_root[i] = m.x;
    a.out_uniform[i] = (!(mean > 0.0f) || statw <= 0.0f || id < 0) ? 1 : 0;
    a.out_frac[i] =
        id >= 0 ? 1.0f / (1.0f + expf(-__ldg(a.opt_var + j))) : 0.5f;
}

struct WalkArgs {
    const int4* qs_row;      // [Q] rows of 32 bytes: the four sums' bits,
                             // then the four children
    int Q, q_depth;
    const float* u;          // lane i's uniform of level k at
                             // u[k * u_level + i * u_lane], or null: point
                             // mode
    long long u_level, u_lane;
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
    const float* u = a.u != nullptr ? a.u + a.u_lane * i : nullptr;
    if (a.uniform[i] != 0) {
        a.out_pdf[i] = INV_FOURPI;
        if (u != nullptr) {
            a.out_p[2 * i] = __ldg(u + U_LEAF * a.u_level);
            a.out_p[2 * i + 1] = __ldg(u + (U_LEAF + 1) * a.u_level);
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
        // the node's row: two 16-byte loads of one 32-byte sector
        const int4 sb = __ldg(a.qs_row + 2 * node);
        const int4 k = __ldg(a.qs_row + 2 * node + 1);
        const float4 s = {__int_as_float(sb.x), __int_as_float(sb.y),
                          __int_as_float(sb.z), __int_as_float(sb.w)};
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
            const float sm = __ldg(u + level * a.u_level);
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
        a.out_p[2 * i] = clamp01(ox + scale * __ldg(u + U_LEAF * a.u_level));
        a.out_p[2 * i + 1] =
            clamp01(oy + scale * __ldg(u + (U_LEAF + 1) * a.u_level));
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
// s_row [S,4] int32 on 16 bytes, s_oct [S,16] int32 on 8 bytes, ds_row
// [T,4] int32 on 16 bytes (guiding/descent.py builds them). With
// ids non-null it writes only root, uniform and frac of those ids; with
// out_root null it writes only the id and the voxel.
extern "C" int ppg_sd_lookup(const float* p, const float* aabb_min,
                             const float* aabb_size, const int32_t* s_row,
                             const int32_t* s_oct, const int32_t* s_dtree,
                             int s_depth, const uint8_t* mask,
                             const int32_t* ids, const int32_t* ds_row,
                             const float* opt_var, int L, int32_t* out_id,
                             float* out_voxel, int32_t* out_root,
                             uint8_t* out_uniform, float* out_frac,
                             int device, void* stream) {
    if (L <= 0) return 0;
    const LookupArgs a{p,
                       aabb_min,
                       aabb_size,
                       reinterpret_cast<const int4*>(s_row),
                       reinterpret_cast<const int2*>(s_oct),
                       s_dtree,
                       s_depth,
                       mask,
                       ids,
                       reinterpret_cast<const int4*>(ds_row),
                       opt_var,
                       L,
                       out_id,
                       out_voxel,
                       out_root,
                       out_uniform,
                       out_frac};
    const int grid = grid_for(L);
    return on_device(device, [&] {
        lookup_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    });
}

// K4 on `stream` of card `device`; returns cudaGetLastError() as an int.
// qs_row: [Q,8] int32 on 32 bytes, a node's four sums (float bits) then
// its four children. Lane i's uniform of level k (k < 22) is
// u[k * u_level + i * u_lane]: the wrapper passes the level-major
// [22, L] storage (u_level = L, u_lane = 1). With u null (point mode)
// every lane descends at its point and only the pdf is written; is_point
// and out_p are then unused.
extern "C" int ppg_sd_sample_pdf(const int32_t* qs_row, int Q, int q_depth,
                                 const float* u, long long u_level,
                                 long long u_lane, const uint8_t* is_point,
                                 const float* pp, const int32_t* root,
                                 const uint8_t* uniform, int L, float* out_p,
                                 float* out_pdf, int device, void* stream) {
    if (L <= 0) return 0;
    const WalkArgs a{reinterpret_cast<const int4*>(qs_row), Q, q_depth, u,
                     u_level, u_lane, is_point, pp, root, uniform, L, out_p,
                     out_pdf};
    const int grid = grid_for(L);
    return on_device(device, [&] {
        walk_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    });
}
