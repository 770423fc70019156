// Triangle sweep of a ray wavefront over every triangle of a small scene:
// closest hit, and any hit with an early exit.
//
// Replaces the Pallas TPU kernel ppg_tpu/accel/pallas_brute.py (_kernel,
// launched by _call / brute_pallas), which serves every closest-hit and
// any-hit ray of a scene with at most BRUTE_MAX = 1024 triangles. The
// semantics are those of the plain version,
// ppg_tpu_torch/accel/brute.py::brute_sweep_plain: Moeller-Trumbore per
// triangle in packed order, every product and sum rounded on its own; a
// hit needs inv = 1/det != 0 (|det| >= 1e-12), u, v >= 0, u + v <= 1 and
// t_min < t < min(best_t, t_max); a later triangle wins only if it is
// strictly nearer. A miss leaves best_i = -1, t = 3.4e38, u = v = 0; a
// lane with t_max < t_min (parked) always misses. Any-hit answers whether
// the closest-hit sweep would hit (the first hit under t_max decides).
//
// Design for Hopper:
// - Two-stage test. Every pair first goes through a cheap test with FMA
//   contraction in det-scaled space, with the division deferred: with
//   n = e1 x e2 computed once per triangle, det = -d.n, t' = tv.n,
//   u' = -e2.(d x tv) and v' = e1.(d x tv), 21 FP32 instructions for the
//   triple products. The test is widened by an error bound E (below) so
//   that it passes every pair the plain version accepts. Only a pair that
//   passes it (a few per ray, not T) is evaluated again exactly in the
//   plain version's operation order with non-contractible __fmul_rn /
//   __fadd_rn and the IEEE reciprocal __frcp_rn, and the plain version's
//   own predicate on those values decides. So best_i, t, u and v equal
//   the plain version's bit for bit, and no pair pays a division unless
//   it is a candidate. The cheap test is branch-free: a thread runs it for
//   its R rays against one triangle (about 38 issued instructions per
//   pair, sign flips and compares included) and branches only if one of
//   them is a candidate. The bound terms of each ray are pinned in
//   registers (keep()); the compiler would otherwise recompute them per
//   pair.
// - The bound. Both evaluations of each triple product (det, t', u', v')
//   err by at most about 31 and 30 units of roundoff (2^-24) times M, the
//   largest product of three magnitudes that enters them:
//   M = S * max(A, Dm) * max(S, Dm), with A = |o|inf + max |p0|inf,
//   Dm = |d|inf and S = max(|e1|inf, |e2|inf) over the tile. The test uses
//   E = 2^-16 M, four times their sum. A pair whose |det| <= E (its sign
//   not certain) is always a candidate.
// - Triangles staged per tile of TILE in shared memory as three float4
//   (p0 | n.x, e1 | n.y, e2 | n.z), so a pair costs 3 LDS.128 shared by
//   the R rays each thread holds in registers.
// - Rays read where they lie: o, d [L,3] and t_min, t_max [L] with their
//   strides (a camera wavefront's o is one origin expanded); the
//   closest-hit result goes to one [4, L] 32-bit buffer (best_i, then the
//   bits of t, u, v), the any-hit result to one byte per ray. Ray r of a
//   thread is lane base + r * BLOCK + threadIdx.x, so every row is read
//   and written coalesced; the ragged end is a bounds check.
// - Any-hit stops a ray at its first exact hit, a parked ray before it
//   starts, and a block once all its rays are done.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s FP32). The function needs 32
// FP32 operations per pair (tv 3, d.n 5, d x tv 9, three dot products
// 15; n = e1 x e2 is 9 per triangle, not per pair). Closest-hit moves
// 32 B in and 16 B out per ray; at T = 12, L = 262,144 that is 12.6 MB,
// 3.76 us from memory against 1.5 us of arithmetic, so memory binds. At
// T = 1024 the 268 M pairs are 8.6 GFLOP, 0.128 ms from FP32, which
// binds. In issued instructions (one per lane per cycle, 3.35e13/s at
// 1980 MHz) the cheap test alone needs about 0.30 ms at T = 1024 and
// about 4 us at T = 12, where it is as long as the memory traffic: a
// block loads its rays and then computes, so the two add up rather than
// overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF = 3.4e38f;  // miss sentinel, as in the reference
constexpr int TILE = 256;       // triangles staged per shared-memory tile
constexpr float BOUND = 1.0f / 65536.0f;  // E = 2^-16 M
// Up to SMALL_T triangles a thread holds one ray in a block of 128, the
// most threads to hide the memory latency; above it each staged triangle
// serves several rays of a thread (the fastest pairs tried on an H100).
constexpr int SMALL_T = 64;

__device__ __forceinline__ float flip(float x, uint32_t sign) {
    return __uint_as_float(__float_as_uint(x) ^ sign);
}

// Keeps x in a register: without it the compiler recomputes a ray's
// bound terms from their inputs inside the pair loop.
__device__ __forceinline__ float keep(float x) {
    asm volatile("" : "+f"(x));
    return x;
}

// Stages triangles [base, base + n) as (p0 | n.x, e1 | n.y, e2 | n.z) and
// gathers P = max |p0|inf and S = max(|e1|, |e2|)inf into s_max, which
// must be zero. The caller synchronises before reading them.
__device__ __forceinline__ void stage(const float* __restrict__ tri,
                                      int base, int n, float4* s_tri,
                                      unsigned* s_max) {
    float p = 0.0f, s = 0.0f;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const float* r = tri + (size_t)(base + k) * 12;
        const float p0x = r[0], p0y = r[1], p0z = r[2];
        const float e1x = r[3], e1y = r[4], e1z = r[5];
        const float e2x = r[6], e2y = r[7], e2z = r[8];
        const float nx = e1y * e2z - e1z * e2y;
        const float ny = e1z * e2x - e1x * e2z;
        const float nz = e1x * e2y - e1y * e2x;
        s_tri[3 * k + 0] = make_float4(p0x, p0y, p0z, nx);
        s_tri[3 * k + 1] = make_float4(e1x, e1y, e1z, ny);
        s_tri[3 * k + 2] = make_float4(e2x, e2y, e2z, nz);
        p = fmaxf(p, fmaxf(fabsf(p0x), fmaxf(fabsf(p0y), fabsf(p0z))));
        s = fmaxf(s, fmaxf(fmaxf(fabsf(e1x), fmaxf(fabsf(e1y), fabsf(e1z))),
                           fmaxf(fabsf(e2x), fmaxf(fabsf(e2y), fabsf(e2z)))));
    }
    // non-negative floats order as their bit patterns
    const unsigned pb = __reduce_max_sync(0xffffffffu, __float_as_uint(p));
    const unsigned sb = __reduce_max_sync(0xffffffffu, __float_as_uint(s));
    if ((threadIdx.x & 31) == 0) {
        atomicMax(&s_max[0], pb);
        atomicMax(&s_max[1], sb);
    }
}

// Per-tile maxima, double-buffered: tile j gathers into slot j & 1 while
// the slot of tile j + 1 is cleared once every thread has read tile j's.
struct TileMax {
    unsigned v[2][2];
    __device__ void init() {
        if (threadIdx.x < 4) v[threadIdx.x >> 1][threadIdx.x & 1] = 0u;
    }
};

// Where a wavefront's rays lie: element strides of o and d (row, column)
// and of t_min and t_max.
struct Rays {
    const float* o;
    const float* d;
    const float* t_min;
    const float* t_max;
    long long os0, os1, ds0, ds1, ts0, ts1;
};

// One ray's registers.
struct Ray {
    float ox, oy, oz, dx, dy, dz, t_min, t_max;
    float dm;      // |d|inf
    float e, e2, elo, ehi;  // E, 2E, E (1 + |t_min|), E (1 + |m|)
    float m;       // min(best_t, t_max)
    float best_t, best_u, best_v;
    int best_i;
    bool live;
};

__device__ __forceinline__ void load_ray(Ray& q, int i, int L,
                                         const Rays& w) {
    q.live = i < L;
    const float* o = w.o + i * w.os0;
    const float* d = w.d + i * w.ds0;
    q.ox = q.live ? __ldg(o) : 0.0f;
    q.oy = q.live ? __ldg(o + w.os1) : 0.0f;
    q.oz = q.live ? __ldg(o + 2 * w.os1) : 0.0f;
    q.dx = q.live ? __ldg(d) : 0.0f;
    q.dy = q.live ? __ldg(d + w.ds1) : 0.0f;
    q.dz = q.live ? __ldg(d + 2 * w.ds1) : 0.0f;
    q.t_min = q.live ? __ldg(w.t_min + i * w.ts0) : 0.0f;
    q.t_max = q.live ? __ldg(w.t_max + i * w.ts1) : -1.0f;
    q.dm = fmaxf(fabsf(q.dx), fmaxf(fabsf(q.dy), fabsf(q.dz)));
    q.best_t = INF;
    q.best_u = 0.0f;
    q.best_v = 0.0f;
    q.best_i = -1;
    q.m = fminf(INF, q.t_max);
}

// The error bound for this ray against the tile with maxima P and S. An
// absent lane gets NaN, which fails every comparison of the test.
__device__ __forceinline__ void bound(Ray& q, float P, float S) {
    const float a = fmaxf(fabsf(q.ox), fmaxf(fabsf(q.oy), fabsf(q.oz))) + P;
    const float e = BOUND * S * fmaxf(a, q.dm) * fmaxf(S, q.dm);
    q.e = keep(q.live ? e : __int_as_float(0x7fffffff));
    q.e2 = keep(2.0f * q.e);
    q.elo = keep(q.e * (1.0f + fabsf(q.t_min)));
    q.ehi = keep(q.e * (1.0f + fabsf(q.m)));
}

// The cheap test: false only for pairs the plain version rejects. It is
// branch-free (bitwise &, |), so the R rays of a thread interleave.
__device__ __forceinline__ bool candidate(const Ray& q, float4 A, float4 B,
                                          float4 C) {
    const float tvx = q.ox - A.x;
    const float tvy = q.oy - A.y;
    const float tvz = q.oz - A.z;
    const float dn = fmaf(q.dz, C.w, fmaf(q.dy, B.w, q.dx * A.w));  // -det
    const float wx = fmaf(q.dy, tvz, -q.dz * tvy);                  // d x tv
    const float wy = fmaf(q.dz, tvx, -q.dx * tvz);
    const float wz = fmaf(q.dx, tvy, -q.dy * tvx);
    const float a = fmaf(C.z, wz, fmaf(C.y, wy, C.x * wx));    // -u'
    const float b = fmaf(B.z, wz, fmaf(B.y, wy, B.x * wx));    //  v'
    const float c = fmaf(tvz, C.w, fmaf(tvy, B.w, tvx * A.w));  //  t'
    // with s = sign(det) = -sign(dn): s u' = a^s', s v' = -(b^s'),
    // s t' = -(c^s'), where x^s' flips x's sign when dn < 0
    const uint32_t sg = __float_as_uint(dn) & 0x80000000u;
    const float su = flip(a, sg), nsv = flip(b, sg), nst = flip(c, sg);
    const float ad = fabsf(dn);
    const bool pass = (su >= -q.e) & (nsv <= q.e) &
                      (su - nsv <= ad + q.e2) &
                      (nst < fmaf(-q.t_min, ad, q.elo)) &
                      (nst > -fmaf(q.m, ad, q.ehi));
    return pass | (ad <= q.e);
}

// The plain version's evaluation and predicate, op for op. On a hit it
// returns true with t, u, v.
__device__ __forceinline__ bool exact(const Ray& q, float4 A, float4 B,
                                      float4 C, float& t, float& u,
                                      float& v) {
    const float tvx = __fsub_rn(q.ox, A.x);
    const float tvy = __fsub_rn(q.oy, A.y);
    const float tvz = __fsub_rn(q.oz, A.z);
    const float e1x = B.x, e1y = B.y, e1z = B.z;
    const float e2x = C.x, e2y = C.y, e2z = C.z;
    const float pvx = __fsub_rn(__fmul_rn(q.dy, e2z), __fmul_rn(q.dz, e2y));
    const float pvy = __fsub_rn(__fmul_rn(q.dz, e2x), __fmul_rn(q.dx, e2z));
    const float pvz = __fsub_rn(__fmul_rn(q.dx, e2y), __fmul_rn(q.dy, e2x));
    const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, pvx),
                                          __fmul_rn(e1y, pvy)),
                                __fmul_rn(e1z, pvz));
    const float inv = fabsf(det) < 1e-12f ? 0.0f : __frcp_rn(det);
    u = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(tvx, pvx),
                                      __fmul_rn(tvy, pvy)),
                            __fmul_rn(tvz, pvz)), inv);
    const float qvx = __fsub_rn(__fmul_rn(tvy, e1z), __fmul_rn(tvz, e1y));
    const float qvy = __fsub_rn(__fmul_rn(tvz, e1x), __fmul_rn(tvx, e1z));
    const float qvz = __fsub_rn(__fmul_rn(tvx, e1y), __fmul_rn(tvy, e1x));
    v = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(q.dx, qvx),
                                      __fmul_rn(q.dy, qvy)),
                            __fmul_rn(q.dz, qvz)), inv);
    t = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(e2x, qvx),
                                      __fmul_rn(e2y, qvy)),
                            __fmul_rn(e2z, qvz)), inv);
    return inv != 0.0f && u >= 0.0f && v >= 0.0f &&
           __fadd_rn(u, v) <= 1.0f && t > q.t_min && t < q.m;
}

template <int BLOCK, int R>
__global__ void __launch_bounds__(BLOCK)
closest_kernel(const float* __restrict__ tri, int T, const Rays w, int L,
               int32_t* __restrict__ out) {
    __shared__ float4 s_tri[3 * TILE];
    __shared__ TileMax s_max;
    const int base = blockIdx.x * (BLOCK * R) + threadIdx.x;
    Ray ray[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
        load_ray(ray[r], base + r * BLOCK, L, w);
    s_max.init();

    for (int tb = 0, j = 0; tb < T; tb += TILE, ++j) {
        const int n = min(TILE, T - tb);
        __syncthreads();  // the previous tile is no longer read
        stage(tri, tb, n, s_tri, s_max.v[j & 1]);
        __syncthreads();
        const float P = __uint_as_float(s_max.v[j & 1][0]);
        const float S = __uint_as_float(s_max.v[j & 1][1]);
        if (threadIdx.x < 2) s_max.v[(j + 1) & 1][threadIdx.x] = 0u;
#pragma unroll
        for (int r = 0; r < R; ++r) bound(ray[r], P, S);
#pragma unroll(R >= 4 ? 1 : 4 / R)
        for (int k = 0; k < n; ++k) {
            const float4 A = s_tri[3 * k], B = s_tri[3 * k + 1],
                         C = s_tri[3 * k + 2];
            bool cand[R];
            bool any = false;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                cand[r] = candidate(ray[r], A, B, C);
                any |= cand[r];
            }
            if (!any) continue;  // the common case: no exact test at all
#pragma unroll
            for (int r = 0; r < R; ++r) {
                Ray& q = ray[r];
                float t, u, v;
                if (cand[r] && exact(q, A, B, C, t, u, v)) {
                    q.best_t = t;
                    q.best_u = u;
                    q.best_v = v;
                    q.best_i = tb + k;
                    q.m = fminf(t, q.t_max);
                    q.ehi = keep(q.e * (1.0f + fabsf(q.m)));
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const Ray& q = ray[r];
        if (!q.live) continue;
        const size_t i = base + r * BLOCK;
        out[i] = q.best_i;
        out[L + i] = __float_as_int(q.best_i < 0 ? INF : q.best_t);
        out[2 * (size_t)L + i] = __float_as_int(q.best_u);
        out[3 * (size_t)L + i] = __float_as_int(q.best_v);
    }
}

template <int BLOCK, int R>
__global__ void __launch_bounds__(BLOCK)
any_hit_kernel(const float* __restrict__ tri, int T, const Rays w, int L,
               uint8_t* __restrict__ out) {
    __shared__ float4 s_tri[3 * TILE];
    __shared__ TileMax s_max;
    const int base = blockIdx.x * (BLOCK * R) + threadIdx.x;
    Ray ray[R];
    bool done[R];
    bool hit[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        load_ray(ray[r], base + r * BLOCK, L, w);
        hit[r] = false;
        // a parked (or absent) ray is never occluded
        done[r] = !ray[r].live || !(ray[r].t_max > ray[r].t_min);
    }
    s_max.init();
    for (int tb = 0, j = 0; tb < T; tb += TILE, ++j) {
        bool busy = false;
#pragma unroll
        for (int r = 0; r < R; ++r) busy |= !done[r];
        if (!__syncthreads_or(busy)) break;  // also: last tile unread
        const int n = min(TILE, T - tb);
        stage(tri, tb, n, s_tri, s_max.v[j & 1]);
        __syncthreads();
        const float P = __uint_as_float(s_max.v[j & 1][0]);
        const float S = __uint_as_float(s_max.v[j & 1][1]);
        if (threadIdx.x < 2) s_max.v[(j + 1) & 1][threadIdx.x] = 0u;
#pragma unroll
        for (int r = 0; r < R; ++r) bound(ray[r], P, S);
        for (int k = 0; k < n && busy; ++k) {
            const float4 A = s_tri[3 * k], B = s_tri[3 * k + 1],
                         C = s_tri[3 * k + 2];
            bool cand[R];
            bool any = false;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                cand[r] = !done[r] & candidate(ray[r], A, B, C);
                any |= cand[r];
            }
            if (!any) continue;
            busy = false;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float t, u, v;
                if (cand[r] && exact(ray[r], A, B, C, t, u, v)) {
                    hit[r] = true;
                    done[r] = true;
                }
                busy |= !done[r];
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (ray[r].live) out[base + r * BLOCK] = hit[r] ? 1 : 0;
}

template <typename Out>
int launch(void (*kernel)(const float*, int, const Rays, int, Out*),
           int block, int rays_per_thread, int device, void* stream,
           const float* tri, int T, const Rays& w, int L, Out* out) {
    if (L <= 0) return 0;
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const int grid = (L + block * rays_per_thread - 1) /
                     (block * rays_per_thread);
    kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(tri, T, w,
                                                                  L, out);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}

}  // namespace

// Launch the sweeps on `stream` of card `device` and return
// cudaGetLastError() as an int (0 = launched). tri: [T, 12] f32 (p0, e1,
// e2, pad), contiguous; o, d: [L, 3] f32 with element strides (s0, s1);
// t_min, t_max: [L] f32 with element strides.
// ppg_brute_closest writes out [4, L] int32: best_i, then the bits of t,
// u, v. ppg_brute_any_hit writes out [L] bytes: 1 where occluded.
extern "C" int ppg_brute_closest(const float* tri, int T, const float* o,
                                 long long os0, long long os1, const float* d,
                                 long long ds0, long long ds1,
                                 const float* t_min, long long ts0,
                                 const float* t_max, long long ts1, int L,
                                 int32_t* out, int device, void* stream) {
    const Rays w{o, d, t_min, t_max, os0, os1, ds0, ds1, ts0, ts1};
    return T <= SMALL_T
        ? launch(closest_kernel<128, 1>, 128, 1, device, stream, tri, T, w, L,
                 out)
        : launch(closest_kernel<256, 2>, 256, 2, device, stream, tri, T, w, L,
                 out);
}

extern "C" int ppg_brute_any_hit(const float* tri, int T, const float* o,
                                 long long os0, long long os1, const float* d,
                                 long long ds0, long long ds1,
                                 const float* t_min, long long ts0,
                                 const float* t_max, long long ts1, int L,
                                 uint8_t* out, int device, void* stream) {
    const Rays w{o, d, t_min, t_max, os0, os1, ds0, ds1, ts0, ts1};
    return T <= SMALL_T
        ? launch(any_hit_kernel<128, 1>, 128, 1, device, stream, tri, T, w, L,
                 out)
        : launch(any_hit_kernel<256, 4>, 256, 4, device, stream, tri, T, w, L,
                 out);
}
