// The ordered BVH16 walk of a ray wavefront: closest hit, and any hit with
// an early exit.
//
// Replaces ppg_tpu's XLA walk: ppg_tpu/accel/traverse.py::bvh_step_factory
// (:333, the step body) driven by bvh_closest (:241, a while_loop over the
// whole wavefront; stop_on_hit gives any_hit, :549). ppg_tpu has no Pallas
// version of it: a fused Pallas step was 3.7x slower on the TPU. The
// semantics are those of the plain version,
// ppg_tpu_torch/accel/traverse.py::bvh_closest_plain, step for step:
// - A ray starts at row 0 only where t_max > t_min (a parked ray never
//   hits) and takes at most MAX_STEPS steps; each step reads one row.
// - Leaf step: the row's cnt <= 16 triangles (SoA p0, e1, e2 at columns
//   0..9W-1, cnt and the packed base as int32 bits at 9W and 9W+1),
//   Moeller-Trumbore in the plain version's operation order; a triangle is
//   taken if inv = 1/det != 0 (|det| >= 1e-12), u, v >= 0, u + v <= 1 and
//   t_min < t < min(best_t, t_max); the first of the nearest taken wins
//   (argmin), and it replaces the best hit only if strictly nearer. u and
//   v are stored + 0.0, as the reference's sum of selects stores them
//   (-0.0 becomes +0.0).
// - Node step: the slab test of the 16 children (AABBs SoA at columns
//   0..6W-1, infos at 6W..7W-1: 0 empty, bit 30 leaf, low bits the row),
//   with NaN-propagating min and max as torch.minimum / torch.maximum (an
//   empty slot's NaN box is never hit); a child is hit if tn <= tf,
//   tf >= t_min, tn <= min(best_t, t_max), its info is not 0 and its bit
//   is in the ray's pending mask (all 16 unless this is a parent
//   revisit). The ray descends into the first nearest hit child; with two
//   or more hit children the first nearest of the rest goes on the stack
//   as a direct entry (its info, mask 0, its tn), with three or more the
//   parent goes below it with the mask of the others.
// - A ray that did not descend pops: a direct top whose tn exceeds
//   min(best_t, t_max) is discarded for free, then the next entry is
//   taken (a direct entry descends into its child, a parent entry
//   revisits the parent under its mask); an empty stack ends the walk.
//   Any-hit also ends it at the first accepted hit. Stack reads and
//   writes past the stack depth SD read 0 and are dropped, as the
//   reference's one-hot selects do (the depth rule of
//   traverse.stack_depth_for makes that never happen).
// Every product and sum is rounded on its own: the file is built with
// --fmad=false (accel/bvh_walk.py), the reciprocals are __frcp_rn, and no
// fast-math flag is set. So best_i, t, u and v equal the plain version's
// bit for bit, and any-hit answers as the plain walk with stop_on_hit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s FP32): counted from
// what the plain walk's steps need (chip_smoke.py phase 7), the
// arithmetic is 25 FP32 operations per child slab test on each child a
// node step must test and 32 per triangle of each leaf step; the bytes are
// the rays and results once and, from each distinct row the walk reads,
// 28 B per non-empty child and 36 B per triangle. At the renders' shapes
// (camera and shadow rays on a 10^6-triangle scene) the bytes are the
// larger term; on a deep soup that every ray crosses, the arithmetic. The
// walk stays far from either: each step reads one row at an address known
// only after the previous step, from a table (66 MB at 10^6 triangles)
// larger than the 50 MB L2. One thread per ray (the first version) made
// every load instruction of a warp touch 32 rows, about 28 L1 wavefronts
// per ray step, and the lanes of a warp diverged in step counts and kinds.
// This design reads a row in coalesced slices and issues instructions
// instead: a node step is about 150 warp instructions for at most two
// rays (the collectives and the checks the compiler puts around a
// collective whose mask is known only at run time), so the time now
// follows the issue rate and the divergence of a warp's two rays
// (PERF.md).
//
// Design: one group of 16 lanes (a half-warp) per ray, four groups in a
// block of 64. Lane c owns child c or triangle c of the current row, so a
// node step is 7 loads per lane, each field a 64-byte slice of the row that
// the group reads together (against 28 scattered float4 loads per
// thread), and a leaf step 9 on the lanes below cnt. Each lane runs the
// plain version's per-child or per-triangle arithmetic; the group then
// picks the first nearest with __reduce_min_sync over an order-preserving
// unsigned key of t (-0.0 taken as +0.0) and __ballot_sync of the lanes
// holding the minimum, whose lowest set bit is the plain scan's first
// minimum with a strict <: ties go to the lowest index, -0.0 ties +0.0,
// and with no hit every lane holds INF's key and the index is 0, as the
// scan leaves it. (A hit child's tn and a taken triangle's t are never
// NaN, and lanes without one hold INF.) The winner's info, t, u and v come
// by __shfl_sync. Every lane of a group holds the ray's whole state and
// takes the same branch, so a ray never diverges; only the two rays of a
// warp can.
// - The walk stack (node, mask and entry t: STACK entries and a spare slot
//   that takes the writes past the depth) lies in shared memory, a slice
//   per group. Every lane of the group writes the same entries and reads
//   back its own writes, so no lane waits on another's.
// - A lane holds one child or one triangle, not sixteen: 40 (any-hit) and
//   47 (closest) registers, no local memory, 3,120 B of shared memory per
//   block; 42 warps resident per SM, against 20 for one thread per ray.
// - The grid is persistent: as many blocks as the card holds at once. A
//   group whose ray ends takes the next ray from a counter (one atomicAdd
//   by lane 0, broadcast by __shfl_sync; the wrapper passes the counter
//   zeroed), so no group idles while another ray of its block walks on.
//   Groups past L leave whole, before any collective.
//
// The group-mask rule: the two groups of a warp may be in different
// branches, so every __shfl_sync, __ballot_sync and __reduce_min_sync
// names the group's 16 lanes (0xffff << 16 * half), and a shuffle's width
// is 16; a full-warp mask in divergent code is undefined.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 16;            // children per node, triangles per leaf
constexpr int STACK = 64;        // = accel/bvh_walk.STACK_CAP
constexpr int MAX_STEPS = 8192;  // = accel/traverse.MAX_STEPS
constexpr int BLOCK = 64;        // threads per block
constexpr int GROUPS = BLOCK / W;  // rays walked at once per block
constexpr float INF = 3.4e38f;   // miss sentinel, as in the reference
constexpr int LEAF_BIT = 1 << 30;
constexpr int IDX_MASK = (1 << 30) - 1;
constexpr int FULL_MASK = (1 << W) - 1;

// Where a wavefront's rays lie: element strides of o and d (row, column)
// and of t_min and t_max.
struct Rays {
    const float* o;
    const float* d;
    const float* t_min;
    const float* t_max;
    long long os0, os1, ds0, ds1, ts0, ts1;
};

__device__ __forceinline__ float safe_inv(float x) {
    return __frcp_rn(fabsf(x) < 1e-20f ? (x >= 0.0f ? 1e-20f : -1e-20f)
                                       : x);
}

// An unsigned key in the order of the floats (not NaN): -0.0 is taken as
// +0.0, and a negative float's bits are flipped so that it sorts below.
__device__ __forceinline__ unsigned order_key(float x) {
    const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The lowest lane of the group holding the group's least key: the plain
// version's argmin, a scan with a strict < from index 0.
__device__ __forceinline__ int first_min(unsigned gmask, int shift,
                                         unsigned key) {
    const unsigned least = __reduce_min_sync(gmask, key);
    return __ffs(__ballot_sync(gmask, key == least) >> shift) - 1;
}

// A stack entry's slot: writes past the depth sd go to the spare slot
// STACK, which no read returns (read gives 0 there, as the reference's
// one-hot selects do).
__device__ __forceinline__ int slot(int p, int sd) {
    return p < sd ? p : STACK;
}
__device__ __forceinline__ int read(const int* s, int p, int sd) {
    const int v = s[slot(p, sd)];
    return p < sd ? v : 0;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
walk_kernel(const float* __restrict__ rows, long long stride, int sd,
            const Rays w, int L, void* __restrict__ out,
            int* __restrict__ taken) {
    __shared__ int s_node[GROUPS][STACK + 1];
    __shared__ int s_mask[GROUPS][STACK + 1];
    __shared__ float s_t[GROUPS][STACK + 1];
    const int c = threadIdx.x % W;        // this lane's child or triangle
    const int g = threadIdx.x / W;        // this group in the block
    const int shift = threadIdx.x & W;    // the group's first warp lane
    const unsigned gmask = 0xffffu << shift;
    const int first = gridDim.x * GROUPS;  // rays given out at the start
    int* const nst = s_node[g];
    int* const mst = s_mask[g];
    float* const tst = s_t[g];

    // a group walks ray i, then takes the next ray not yet taken; a group
    // past L leaves whole, so no collective sees it
    for (int i = blockIdx.x * GROUPS + g; i < L;) {
        // every lane of the group holds the ray and the walk's state
        const float* o = w.o + i * w.os0;
        const float* d = w.d + i * w.ds0;
        const float ox = __ldg(o), oy = __ldg(o + w.os1),
                    oz = __ldg(o + 2 * w.os1);
        const float dx = __ldg(d), dy = __ldg(d + w.ds1),
                    dz = __ldg(d + 2 * w.ds1);
        const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
        const float t_min = __ldg(w.t_min + i * w.ts0);
        const float t_max = __ldg(w.t_max + i * w.ts1);

        int cur = t_max > t_min ? 0 : -1;
        bool leaf = false;
        int pend = 0, sp = 0;
        float best_t = INF, best_u = 0.0f, best_v = 0.0f;
        int best_i = -1;

        for (int it = 0; cur >= 0 && it < MAX_STEPS; ++it) {
            const float* row = rows + cur * stride;
            const float limit = fminf(best_t, t_max);
            if (leaf) {
                const int cnt = __float_as_int(__ldg(row + 9 * W));
                float tt = INF, uu = 0.0f, vv = 0.0f;
                bool take = false;
                if (c < cnt) {
                    const float p0x = __ldg(row + c),
                                p0y = __ldg(row + W + c),
                                p0z = __ldg(row + 2 * W + c);
                    const float e1x = __ldg(row + 3 * W + c),
                                e1y = __ldg(row + 4 * W + c),
                                e1z = __ldg(row + 5 * W + c);
                    const float e2x = __ldg(row + 6 * W + c),
                                e2y = __ldg(row + 7 * W + c),
                                e2z = __ldg(row + 8 * W + c);
                    const float pvx = dy * e2z - dz * e2y;
                    const float pvy = dz * e2x - dx * e2z;
                    const float pvz = dx * e2y - dy * e2x;
                    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
                    const float inv =
                        fabsf(det) < 1e-12f ? 0.0f : __frcp_rn(det);
                    const float tvx = ox - p0x, tvy = oy - p0y,
                                tvz = oz - p0z;
                    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
                    const float qvx = tvy * e1z - tvz * e1y;
                    const float qvy = tvz * e1x - tvx * e1z;
                    const float qvz = tvx * e1y - tvy * e1x;
                    vv = (dx * qvx + dy * qvy + dz * qvz) * inv;
                    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
                    take = (inv != 0.0f) & (uu >= 0.0f) & (vv >= 0.0f) &
                           (uu + vv <= 1.0f) & (tt > t_min) & (tt < limit);
                }
                if (ANY) {
                    // a taken t lies below limit <= best_t = INF: occluded
                    if (__ballot_sync(gmask, take) != 0) best_i = 0;
                } else {
                    const float tm = take ? tt : INF;
                    const int kb = first_min(gmask, shift, order_key(tm));
                    const float tb = __shfl_sync(gmask, tm, kb, W);
                    const float ub = __shfl_sync(gmask, uu, kb, W);
                    const float vb = __shfl_sync(gmask, vv, kb, W);
                    if (tb < best_t) {
                        best_i = __float_as_int(__ldg(row + 9 * W + 1)) + kb;
                        best_u = __fadd_rn(ub, 0.0f);
                        best_v = __fadd_rn(vb, 0.0f);
                        best_t = tb;
                    }
                }
            } else {
                const float x0 = __ldg(row + c), y0 = __ldg(row + W + c),
                            z0 = __ldg(row + 2 * W + c);
                const float x1 = __ldg(row + 3 * W + c),
                            y1 = __ldg(row + 4 * W + c),
                            z1 = __ldg(row + 5 * W + c);
                const int info = __float_as_int(__ldg(row + 6 * W + c));
                const int pmask = pend == 0 ? FULL_MASK : pend;
                const float t0x = (x0 - ox) * ix;
                const float t1x = (x1 - ox) * ix;
                const float t0y = (y0 - oy) * iy;
                const float t1y = (y1 - oy) * iy;
                const float t0z = (z0 - oz) * iz;
                const float t1z = (z1 - oz) * iz;
                // torch.minimum / torch.maximum propagate NaN, so the
                // plain version's tn and tf are NaN, and the child missed,
                // where one of the six is (an empty slot's NaN box);
                // elsewhere fminf and fmaxf give its values
                const bool nan = (t0x != t0x) | (t1x != t1x) |
                                 (t0y != t0y) | (t1y != t1y) |
                                 (t0z != t0z) | (t1z != t1z);
                const float tn = fmaxf(
                    fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
                const float tf = fminf(
                    fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
                const bool hit = !nan & (tn <= tf) & (tf >= t_min) &
                                 (tn <= limit) & (info != 0) &
                                 (((pmask >> c) & 1) != 0);
                const float tnm = hit ? tn : INF;
                const int hit_mask = __ballot_sync(gmask, hit) >> shift;
                if (hit_mask != 0 && !(ANY && best_i >= 0)) {
                    // the first nearest child, then the first nearest of
                    // the rest
                    const unsigned key = order_key(tnm);
                    const int kn = first_min(gmask, shift, key);
                    const int chosen = __shfl_sync(gmask, info, kn, W);
                    const int rem = hit_mask & ~(1 << kn);
                    if (rem != 0) {
                        const int kn2 = first_min(
                            gmask, shift, c == kn ? order_key(INF) : key);
                        const float tn2 = __shfl_sync(gmask, tnm, kn2, W);
                        const int info2 = __shfl_sync(gmask, info, kn2, W);
                        const int rem2 = rem & ~(1 << kn2);
                        // every lane writes the same entries and reads its
                        // own
                        if (rem2 != 0) {  // the parent, below the direct entry
                            nst[slot(sp, sd)] = cur;
                            mst[slot(sp, sd)] = rem2;
                            ++sp;
                        }
                        // the second-nearest child, direct
                        nst[slot(sp, sd)] = info2;
                        mst[slot(sp, sd)] = 0;
                        tst[slot(sp, sd)] = tn2;
                        ++sp;
                    }
                    cur = chosen & IDX_MASK;
                    leaf = (chosen & LEAF_BIT) != 0;
                    pend = 0;
                    continue;
                }
            }
            // pop
            if (ANY && best_i >= 0) break;
            const float limit1 = fminf(best_t, t_max);
            int spe = sp;
            // a direct entry (mask 0) was written with its t
            if (sp > 0 && read(mst, sp - 1, sd) == 0 &&
                (sp - 1 < sd ? tst[sp - 1] : 0.0f) > limit1)
                spe = sp - 1;
            if (spe > 0) {
                const int top_n = read(nst, spe - 1, sd);
                const int top_m = read(mst, spe - 1, sd);
                sp = spe - 1;
                if (top_m == 0) {
                    cur = top_n & IDX_MASK;
                    leaf = (top_n & LEAF_BIT) != 0;
                    pend = 0;
                } else {
                    cur = top_n;
                    leaf = false;
                    pend = top_m;
                }
            } else {
                sp = spe;
                cur = -1;
            }
        }
        if (ANY) {
            if (c == 0) static_cast<uint8_t*>(out)[i] = best_i >= 0 ? 1 : 0;
        } else if (c < 4) {  // lanes 0-3: best_i, then the bits of t, u, v
            const int v = c == 0   ? best_i
                          : c == 1 ? __float_as_int(best_t)
                          : c == 2 ? __float_as_int(best_u)
                                   : __float_as_int(best_v);
            static_cast<int32_t*>(out)[c * (size_t)L + i] = v;
        }
        int n = 0;
        if (c == 0) n = atomicAdd(taken, 1);
        i = first + __shfl_sync(gmask, n, 0, W);
    }
}

template <bool ANY>
int launch(const float* rows, long long stride, int sd, const Rays& w,
           int L, void* out, int* taken, int device, void* stream) {
    if (L <= 0) return 0;
    if (sd < 1 || sd > STACK) return static_cast<int>(cudaErrorInvalidValue);
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    // a persistent grid: as many blocks as the card holds at once
    static int resident[64];  // per device index, found once
    int& cap = resident[device & 63];
    if (cap == 0) {
        int per_sm = 0, sms = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      walk_kernel<ANY>,
                                                      BLOCK, 0);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        cap = per_sm * sms > 0 ? per_sm * sms : 1;
    }
    const int need = (L + GROUPS - 1) / GROUPS;
    const int grid = need < cap ? need : cap;
    walk_kernel<ANY><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, stride, sd, w, L, out, taken);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}

}  // namespace

// Launch the walks on `stream` of card `device` and return
// cudaGetLastError() as an int (0 = launched). rows: [N, 146] f32 rows of
// a W = 16 tree, row stride `stride` elements (a multiple of 4, the base on
// 16 bytes); sd: the walk stack's depth (1..64); o, d: [L, 3] f32 with
// element strides (s0, s1); t_min, t_max: [L] f32 with element strides.
// ppg_bvh_closest writes out [4, L] int32: best_i (packed order), then the
// bits of t, u, v. ppg_bvh_any_hit writes out [L] bytes: 1 where occluded.
extern "C" int ppg_bvh_closest(const float* rows, long long stride, int sd,
                               const float* o, long long os0, long long os1,
                               const float* d, long long ds0, long long ds1,
                               const float* t_min, long long ts0,
                               const float* t_max, long long ts1, int L,
                               int32_t* out, int32_t* taken, int device,
                               void* stream) {
    const Rays w{o, d, t_min, t_max, os0, os1, ds0, ds1, ts0, ts1};
    return launch<false>(rows, stride, sd, w, L, out, taken, device, stream);
}

extern "C" int ppg_bvh_any_hit(const float* rows, long long stride, int sd,
                               const float* o, long long os0, long long os1,
                               const float* d, long long ds0, long long ds1,
                               const float* t_min, long long ts0,
                               const float* t_max, long long ts1, int L,
                               uint8_t* out, int32_t* taken, int device,
                               void* stream) {
    const Rays w{o, d, t_min, t_max, os0, os1, ds0, ds1, ts0, ts1};
    return launch<true>(rows, stride, sd, w, L, out, taken, device, stream);
}
