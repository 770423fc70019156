// K11: Woodcock (delta) tracking and ratio tracking through grid media.
//
// It replaces ppg_tpu/media.py::woodcock_sample (:256; its 64-event
// lax.scan blocks at :298 under the while_loop at :301) and
// ratio_transmittance (:309; the scan at :343 under the while_loop at
// :346): XLA loops, no Pallas original. In eager PyTorch an event is
// some 60 launches (the counter hash, the log, the world-to-grid affine,
// eight grid gathers, the trilinear blend, the selects), a block 64
// events and one host read; here one launch a call:
//   - mode 0 (track): woodcock_sample. A lane walks o + t d through its
//     medium's density grid against the majorant until an event is
//     accepted (a scatter: is_med, t, the albedo as weight), the flight
//     passes t_end (the surface, or inf: no event, t_end, weight 1) or
//     it reaches the cap of events (no event, as ppg_tpu);
//   - mode 1 (ratio): ratio_transmittance over [0, t_end]: the product
//     of 1 - density / majorant over the events before t_end, 1 on lanes
//     outside a grid medium; at the cap the product as it stands.
// The semantics are those of the plain version,
// ppg_tpu_torch/media.py::woodcock_sample_plain and
// ratio_transmittance_plain: a lane is gated in where mid >= 0, its
// row's hetero flag is set and its majorant is positive, and every other
// lane gets the plain version's values, so the gate adds no launch.
// Event k of lane i draws counter k * channels + c (channels 2 tracking,
// 1 ratio) from render/samplers.py's hash keyed by _hash(i, seed), the
// seed the int64 the wrapper's caller drew on the card, read here from
// memory; a uniform is the hash's top 24 bits times 2^-24. Every float
// operation is the plain version's, in its order: the flight
// t - logf(max(1 - u, 1e-38)) / max(maj, 1e-38) with the CUDA math
// library's logf (ATen's torch.log on a card), the point o + t d, the
// affine's products summed left to right, the insideness test on the
// continuous grid coordinate, the clamped cell, the trilinear blend in
// density's order, the acceptance u1 * maj < density * scale; clamps as
// compare and select. Built with --fmad=false, so no product is fused
// into a sum: the kernel equals the plain version bit for bit. A lane
// outside the grid reads no corner (its density is 0 whatever they
// hold); a corner's flat index is clamped into the grid, as ppg_tpu's
// gather clamps it.
//
// One thread a lane, looping over its events; this is the first, simple
// version. Each event is a dependent chain (the hash and logf, then eight
// corner loads from a grid that may exceed the L2, then the blend), and
// the lanes of a warp take different numbers of events.
//
// What bounds it on an H100 (chip_smoke.media_bound_ms): bytes. Every
// lane reads its medium id and t_end and writes its outputs; a gated-in
// lane reads o and d; the call reads each distinct grid float its live
// events inside the grid need once (4 B). The events' FP32 operations
// (about 70 a tracking event) take longer only on small grids.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int TRACK = 0, RATIO = 1;
constexpr int ROW_W = 36;
// Python floats as ATen rounds them: the double to float
constexpr float TINY = static_cast<float>(1e-38);
constexpr float INV24 = static_cast<float>(1.0 / 16777216.0);

struct Args {
    const float* rows;  // [M, 36]
    int M;
    const float* grid;  // [G]
    long long G;
    const float* o;
    long long o_s0, o_s1;
    const float* d;
    long long d_s0, d_s1;
    const float* t_end;
    long long t_s;
    const int32_t* mid;
    long long mid_s;
    const long long* seed;  // [1], in [0, 2^32)
    int cap;                // events a lane takes at most
    uint8_t* is_med;        // track: [L]
    float* t;               // track: [L]
    float* w;               // track: [L, 3]
    float* T;               // ratio: [L]
    int L;
};

__device__ __forceinline__ uint32_t finish(uint32_t x) {
    x ^= x >> 16;
    x *= 0x21F0AAADu;
    x ^= x >> 15;
    x *= 0x735A2D97u;
    return x ^ (x >> 15);
}

// render/samplers.py::_to_float of counter c's hash under a lane's key
// (kmul = key * 0x9E3779B9)
__device__ __forceinline__ float uniform(uint32_t kmul, uint32_t c) {
    return static_cast<float>(finish(c + kmul) >> 8) * INV24;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;  // torch.clamp(min=): NaN stays NaN
}

// media.py::density at p through the row's grid, times nothing: the
// trilinear value, or 0 outside the grid
__device__ float density(const Args& a, const float* row, float p0,
                         float p1, float p2) {
    const float* w = row + 14;
    const float g0 = w[0] * p0 + w[1] * p1 + w[2] * p2 + w[3];
    const float g1 = w[4] * p0 + w[5] * p1 + w[6] * p2 + w[7];
    const float g2 = w[8] * p0 + w[9] * p1 + w[10] * p2 + w[11];
    const float r0 = row[11], r1 = row[12], r2 = row[13];
    const bool inside = g0 >= 0.0f && g0 <= r0 - 1.0f && g1 >= 0.0f &&
                        g1 <= r1 - 1.0f && g2 >= 0.0f && g2 <= r2 - 1.0f;
    if (!inside) return 0.0f;
    const int nx = static_cast<int>(r0), ny = static_cast<int>(r1),
              nz = static_cast<int>(r2);
    auto cell = [](float g, int n) {
        int x = static_cast<int>(floorf(g));
        const int hi = n - 2 < 0 ? 0 : n - 2;
        x = x < 0 ? 0 : x;
        return x > hi ? hi : x;
    };
    const int x = cell(g0, nx), y = cell(g1, ny), z = cell(g2, nz);
    const float fx = g0 - static_cast<float>(x);
    const float fy = g1 - static_cast<float>(y);
    const float fz = g2 - static_cast<float>(z);
    const long long off = static_cast<long long>(row[10]);
    float c[8];
    for (int k = 0; k < 8; ++k) {
        const long long dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
        long long idx = off + ((z + dz) * ny + (y + dy)) * nx + (x + dx);
        idx = idx < 0 ? 0 : idx > a.G - 1 ? a.G - 1 : idx;
        c[k] = __ldg(a.grid + idx);
    }
    const float ux = 1.0f - fx, uy = 1.0f - fy, uz = 1.0f - fz;
    return ((c[0] * ux + c[1] * fx) * uy + (c[2] * ux + c[3] * fx) * fy) *
               uz +
           ((c[4] * ux + c[5] * fx) * uy + (c[6] * ux + c[7] * fx) * fy) *
               fz;
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK) media_kernel(const Args a) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= a.L) return;
    const int m = a.mid[i * a.mid_s];
    const float t_end = a.t_end[i * a.t_s];
    const int mc = m < 0 ? 0 : m > a.M - 1 ? a.M - 1 : m;
    const float* row = a.rows + static_cast<long long>(mc) * ROW_W;
    const float maj = row[8];
    const bool gated_in = m >= 0 && row[7] > 0.0f && maj > 0.0f;
    bool hit = false;
    float t = 0.0f, T = 1.0f;
    if (gated_in) {
        const float o0 = a.o[i * a.o_s0], o1 = a.o[i * a.o_s0 + a.o_s1],
                    o2 = a.o[i * a.o_s0 + 2 * a.o_s1];
        const float d0 = a.d[i * a.d_s0], d1 = a.d[i * a.d_s0 + a.d_s1],
                    d2 = a.d[i * a.d_s0 + 2 * a.d_s1];
        const float scale = row[9];
        const float maj_c = clamp_min(maj, TINY);
        const uint32_t seed = static_cast<uint32_t>(*a.seed & 0xffffffffLL);
        const uint32_t key =
            finish(static_cast<uint32_t>(i) + seed * 0x9E3779B9u);
        const uint32_t kmul = key * 0x9E3779B9u;
        constexpr uint32_t NCH = MODE == TRACK ? 2u : 1u;
        for (int k = 0; k < a.cap; ++k) {
            const float u0 = uniform(kmul, NCH * static_cast<uint32_t>(k));
            const float t2 = t - logf(clamp_min(1.0f - u0, TINY)) / maj_c;
            if (t2 >= t_end) break;
            const float dens =
                density(a, row, o0 + t2 * d0, o1 + t2 * d1, o2 + t2 * d2) *
                scale;
            t = t2;
            if (MODE == TRACK) {
                const float u1 =
                    uniform(kmul, NCH * static_cast<uint32_t>(k) + 1u);
                if (u1 * maj < dens) {
                    hit = true;
                    break;
                }
            } else {
                float r = 1.0f - dens / maj_c;
                r = r < 0.0f ? 0.0f : r;
                T = T * r;
            }
        }
    }
    if (MODE == TRACK) {
        a.is_med[i] = hit ? 1 : 0;
        a.t[i] = hit ? t : t_end;
        for (int c = 0; c < 3; ++c) a.w[3 * i + c] = hit ? row[3 + c] : 1.0f;
    } else {
        a.T[i] = T;
    }
}

}  // namespace

// K11 on `stream` of card `device`, in `mode` (0 track, 1 ratio), over L
// lanes: the medium rows [M, 36] and the concatenated grids [G]; o and d
// [L,3] through their element strides, t_end [L] (t_surf tracking, dist
// in ratio mode) and mid [L] int32 through theirs; seed, one int64 on
// the card; cap, the events a lane takes at most. Writes is_med [L]
// (bool), t [L] and w [L,3] tracking, T [L] in ratio mode (contiguous).
// Returns cudaGetLastError() as an int (0 = launched), or
// cudaErrorInvalidValue for L of 2^31 or more, a bad mode or an empty
// table.
extern "C" int ppg_media_track(int mode, const float* rows, int M,
                               const float* grid, long long G,
                               const float* o, long long o_s0,
                               long long o_s1, const float* d,
                               long long d_s0, long long d_s1,
                               const float* t_end, long long t_s,
                               const int32_t* mid, long long mid_s,
                               const long long* seed, int cap,
                               uint8_t* is_med, float* t, float* w,
                               float* T, long long L, int device,
                               void* stream) {
    if (L <= 0) return 0;
    if (L > 0x7fffffffLL - BLOCK || (mode != TRACK && mode != RATIO) ||
        M <= 0 || G <= 0 || cap <= 0)
        return cudaErrorInvalidValue;
    const Args a{rows, M,     grid,  G,   o, o_s0,   o_s1,
                 d,    d_s0,  d_s1,  t_end, t_s, mid, mid_s,
                 seed, cap,   is_med, t,   w, T,      static_cast<int>(L)};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const int grid_n = static_cast<int>((L + BLOCK - 1) / BLOCK);
    if (mode == TRACK)
        media_kernel<TRACK><<<grid_n, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    else
        media_kernel<RATIO><<<grid_n, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
