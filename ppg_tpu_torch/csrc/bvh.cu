// The ordered BVH16 walk of a ray wavefront: closest hit, and any hit with
// an early exit.
//
// Replaces ppg_tpu's XLA walk: ppg_tpu/accel/traverse.py::bvh_step_factory
// (:333, the step body) driven by bvh_closest (:241, a while_loop over the
// whole wavefront; stop_on_hit gives any_hit, :549). ppg_tpu has no Pallas
// version of it: a fused Pallas step was 3.7x slower on the TPU. The
// semantics are those of the plain version,
// ppg_tpu_torch/accel/traverse.py::bvh_closest_plain, step for step:
// - A lane starts at row 0 only where t_max > t_min (a parked lane never
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
//   is in the lane's pending mask (all 16 unless this is a parent
//   revisit). The lane descends into the first nearest hit child; with two
//   or more hit children the first nearest of the rest goes on the stack
//   as a direct entry (its info, mask 0, its tn), with three or more the
//   parent goes below it with the mask of the others.
// - A lane that did not descend pops: a direct top whose tn exceeds
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
// Design (a first, simple one): one thread per ray, blocks of 128, the
// ragged last block masked; each thread runs the reference's step body,
// one step per loop turn. The walk stack (node, mask and entry t, STACK
// entries each) lives in local memory. A row is read with __ldg in 16-byte
// loads: an internal row's first 7W floats (7 float4 per 4 children), a
// leaf row's 9 float4 per 4 triangles it holds and its two int fields; the
// rows are padded to 148 floats so every row starts on 16 bytes
// (traverse.padded_rows).
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s FP32): counted from
// what the plain walk's steps need (chip_smoke.py phase 7), the
// arithmetic is 25 FP32 operations per child slab test (6 sub, 6 mul, 10
// min/max, 3 compares) on each child a node step must test (non-empty and
// pending) and 32 per triangle of each leaf step; the bytes are the rays
// (32 B) and results once and, from each distinct row the walk reads,
// 28 B per non-empty child and 36 B per triangle (8 B more per leaf).
// At the renders' shapes (camera and shadow rays on a 10^6-triangle
// scene, where most rays end after a few steps) the bytes are the larger
// term; on a deep soup whose rows all fit in L2 and that every ray
// crosses, the arithmetic is. But a walk is latency-bound in practice:
// each step is a dependent row read at an address known only after the
// previous step, scattered over a table (66 MB at 10^6 triangles) larger
// than the 50 MB L2, and the lanes of a warp diverge in step counts and
// phases. This design does nothing about that
// beyond one ray per thread and many resident warps; treelet layouts, a
// persistent grid, ray sorting and compressed nodes are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 16;           // children per node, triangles per leaf
constexpr int Q = W / 4;        // float4 per SoA block of W
constexpr int STACK = 64;       // = accel/bvh_walk.STACK_CAP
constexpr int MAX_STEPS = 8192;  // = accel/traverse.MAX_STEPS
constexpr int BLOCK = 128;
constexpr float INF = 3.4e38f;  // miss sentinel, as in the reference
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

// torch.minimum / torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float nmin(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float lane(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float safe_inv(float x) {
    return __frcp_rn(fabsf(x) < 1e-20f ? (x >= 0.0f ? 1e-20f : -1e-20f)
                                       : x);
}

// One ray's registers.
struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min, t_max;
};

// The leaf step: intersects the row's triangles and updates the best hit.
__device__ __forceinline__ void leaf_step(const float* __restrict__ row,
                                          const Ray& r, float limit,
                                          float& best_t, int& best_i,
                                          float& best_u, float& best_v) {
    const int cnt = __float_as_int(__ldg(row + 9 * W));
    const int base = __float_as_int(__ldg(row + 9 * W + 1));
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float tb = INF, ub = 0.0f, vb = 0.0f;
    int kb = 0;
    for (int g = 0; g < Q && 4 * g < cnt; ++g) {
        float4 c[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) c[k] = __ldg(r4 + k * Q + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int w = 4 * g + j;
            const float p0x = lane(c[0], j), p0y = lane(c[1], j),
                        p0z = lane(c[2], j);
            const float e1x = lane(c[3], j), e1y = lane(c[4], j),
                        e1z = lane(c[5], j);
            const float e2x = lane(c[6], j), e2y = lane(c[7], j),
                        e2z = lane(c[8], j);
            const float pvx = r.dy * e2z - r.dz * e2y;
            const float pvy = r.dz * e2x - r.dx * e2z;
            const float pvz = r.dx * e2y - r.dy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            const float inv = fabsf(det) < 1e-12f ? 0.0f : __frcp_rn(det);
            const float tvx = r.ox - p0x, tvy = r.oy - p0y,
                        tvz = r.oz - p0z;
            const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
            const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
            const bool take = w < cnt && inv != 0.0f && uu >= 0.0f &&
                              vv >= 0.0f && uu + vv <= 1.0f &&
                              tt > r.t_min && tt < limit;
            // the first minimum, as argmin
            if (take && tt < tb) {
                tb = tt;
                kb = w;
                ub = uu;
                vb = vv;
            }
        }
    }
    if (tb < best_t) {
        best_i = base + kb;
        best_u = __fadd_rn(ub, 0.0f);
        best_v = __fadd_rn(vb, 0.0f);
        best_t = tb;
    }
}

__device__ __forceinline__ int read(const int* s, int p, int sd) {
    return (p >= 0 && p < sd) ? s[p] : 0;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
walk_kernel(const float* __restrict__ rows, long long stride, int sd,
            const Rays w, int L, void* __restrict__ out) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= L) return;
    Ray r;
    const float* o = w.o + i * w.os0;
    const float* d = w.d + i * w.ds0;
    r.ox = __ldg(o);
    r.oy = __ldg(o + w.os1);
    r.oz = __ldg(o + 2 * w.os1);
    r.dx = __ldg(d);
    r.dy = __ldg(d + w.ds1);
    r.dz = __ldg(d + 2 * w.ds1);
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    r.t_min = __ldg(w.t_min + i * w.ts0);
    r.t_max = __ldg(w.t_max + i * w.ts1);

    int nst[STACK], mst[STACK];
    float tst[STACK];
    int cur = r.t_max > r.t_min ? 0 : -1;
    bool leaf = false;
    int pend = 0, sp = 0;
    float best_t = INF, best_u = 0.0f, best_v = 0.0f;
    int best_i = -1;

    for (int it = 0; cur >= 0 && it < MAX_STEPS; ++it) {
        const float* row = rows + cur * stride;
        const float limit = fminf(best_t, r.t_max);
        if (leaf) {
            leaf_step(row, r, limit, best_t, best_i, best_u, best_v);
        } else {
            const float4* r4 = reinterpret_cast<const float4*>(row);
            const int pmask = pend == 0 ? FULL_MASK : pend;
            float tnm[W];
            int hit_mask = 0;
#pragma unroll
            for (int g = 0; g < Q; ++g) {
                const float4 x0 = __ldg(r4 + 0 * Q + g);
                const float4 y0 = __ldg(r4 + 1 * Q + g);
                const float4 z0 = __ldg(r4 + 2 * Q + g);
                const float4 x1 = __ldg(r4 + 3 * Q + g);
                const float4 y1 = __ldg(r4 + 4 * Q + g);
                const float4 z1 = __ldg(r4 + 5 * Q + g);
                const float4 nf = __ldg(r4 + 6 * Q + g);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = 4 * g + j;
                    const float t0x = (lane(x0, j) - r.ox) * r.ix;
                    const float t1x = (lane(x1, j) - r.ox) * r.ix;
                    const float t0y = (lane(y0, j) - r.oy) * r.iy;
                    const float t1y = (lane(y1, j) - r.oy) * r.iy;
                    const float t0z = (lane(z0, j) - r.oz) * r.iz;
                    const float t1z = (lane(z1, j) - r.oz) * r.iz;
                    const float tn = nmax(nmax(nmin(t0x, t1x),
                                               nmin(t0y, t1y)),
                                          nmin(t0z, t1z));
                    const float tf = nmin(nmin(nmax(t0x, t1x),
                                               nmax(t0y, t1y)),
                                          nmax(t0z, t1z));
                    const bool hit = tn <= tf && tf >= r.t_min &&
                                     tn <= limit &&
                                     __float_as_int(lane(nf, j)) != 0 &&
                                     ((pmask >> c) & 1);
                    tnm[c] = hit ? tn : INF;
                    hit_mask |= int(hit) << c;
                }
            }
            // the first nearest child, then the first nearest of the rest
            int kn = 0;
            float v1 = tnm[0];
#pragma unroll
            for (int c = 1; c < W; ++c)
                if (tnm[c] < v1) {
                    v1 = tnm[c];
                    kn = c;
                }
            int kn2 = 0;
            float tn2 = kn == 0 ? INF : tnm[0];
#pragma unroll
            for (int c = 1; c < W; ++c) {
                const float x = c == kn ? INF : tnm[c];
                if (x < tn2) {
                    tn2 = x;
                    kn2 = c;
                }
            }
            const bool descend = hit_mask != 0 && !(ANY && best_i >= 0);
            if (descend) {
                const int chosen = __float_as_int(__ldg(row + 6 * W + kn));
                const int rem = hit_mask & ~(1 << kn);
                const int rem2 = rem & ~(1 << kn2);
                if (rem2 != 0) {  // the parent, below the direct entry
                    if (sp < sd) {
                        nst[sp] = cur;
                        mst[sp] = rem2;
                    }
                    ++sp;
                }
                if (rem != 0) {  // the second-nearest child, direct
                    if (sp < sd) {
                        nst[sp] = __float_as_int(__ldg(row + 6 * W + kn2));
                        mst[sp] = 0;
                        tst[sp] = tn2;
                    }
                    ++sp;
                }
                cur = chosen & IDX_MASK;
                leaf = (chosen & LEAF_BIT) != 0;
                pend = 0;
                continue;
            }
        }
        // pop
        if (ANY && best_i >= 0) {
            cur = -1;
            break;
        }
        const float limit1 = fminf(best_t, r.t_max);
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
        static_cast<uint8_t*>(out)[i] = best_i >= 0 ? 1 : 0;
    } else {
        int32_t* o32 = static_cast<int32_t*>(out);
        o32[i] = best_i;
        o32[L + i] = __float_as_int(best_t);
        o32[2 * (size_t)L + i] = __float_as_int(best_u);
        o32[3 * (size_t)L + i] = __float_as_int(best_v);
    }
}

template <bool ANY>
int launch(const float* rows, long long stride, int sd, const Rays& w,
           int L, void* out, int device, void* stream) {
    if (L <= 0) return 0;
    if (sd < 1 || sd > STACK) return static_cast<int>(cudaErrorInvalidValue);
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const int grid = (L + BLOCK - 1) / BLOCK;
    walk_kernel<ANY><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, stride, sd, w, L, out);
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
                               int32_t* out, int device, void* stream) {
    const Rays w{o, d, t_min, t_max, os0, os1, ds0, ds1, ts0, ts1};
    return launch<false>(rows, stride, sd, w, L, out, device, stream);
}

extern "C" int ppg_bvh_any_hit(const float* rows, long long stride, int sd,
                               const float* o, long long os0, long long os1,
                               const float* d, long long ds0, long long ds1,
                               const float* t_min, long long ts0,
                               const float* t_max, long long ts1, int L,
                               uint8_t* out, int device, void* stream) {
    const Rays w{o, d, t_min, t_max, os0, os1, ds0, ds1, ts0, ts1};
    return launch<true>(rows, stride, sd, w, L, out, device, stream);
}
