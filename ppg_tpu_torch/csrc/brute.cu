// Closest-hit sweep of a ray wavefront over every triangle of a small scene.
//
// Replaces the Pallas TPU kernel ppg_tpu/accel/pallas_brute.py (_kernel,
// launched by _call / brute_pallas), which serves every closest-hit ray of
// a scene with at most BRUTE_MAX = 1024 triangles. Semantics are those of
// the plain version, ppg_tpu_torch/accel/brute.py::brute_sweep_plain:
// Moeller-Trumbore per triangle in packed order; a hit needs inv != 0,
// u, v >= 0, u + v <= 1 and t_min < t < min(best_t, t_max); |det| < 1e-12
// is degenerate; a later triangle wins only if it is strictly nearer.
// A miss leaves best_i = -1 and t = 3.4e38; a lane with t_max < t_min
// (parked) always misses.
//
// Design: one thread per ray. Rays arrive as SoA [8, L] f32 (ox oy oz dx dy
// dz tmin tmax), so each of the 8 loads is coalesced across the warp. The
// triangles are staged through shared memory in tiles of TILE, keeping only
// the 9 floats the test uses (p0, e1, e2) out of each [T, 12] record; every
// thread of the block then reads the same triangle, a broadcast. The best
// hit lives in registers and is written with four stores. The ragged end
// of the wavefront is a bounds check, not padding.
//
// What bounds it on an H100: at the slice's T = 12 it moves 32 B in and
// 16 B out per ray for about 12 x 40 flops, so it is launch- and
// memory-bound; at T = 1024 it does about 40k flops per ray and is bound by
// FP32 throughput. There is no matrix product in it, so wgmma and TMA do
// not apply.
//
// Numerics: built with --fmad=false and without --use_fast_math, and the
// expressions below follow the plain version's operation order, so every
// product and sum is rounded exactly as PyTorch's one-op-per-kernel
// elementwise arithmetic rounds it. 1.0f / det is the correctly rounded
// IEEE division (-prec-div=true is nvcc's default), the same quotient as
// torch.reciprocal. best_i therefore matches the plain version exactly and
// t/u/v match bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;          // triangles staged per shared-memory tile
constexpr int BLOCK = 256;         // threads (rays) per block
constexpr float INF = 3.4e38f;     // miss sentinel, as in the reference

__global__ void __launch_bounds__(BLOCK)
brute_closest_kernel(const float* __restrict__ tri, int T,
                     const float* __restrict__ rays, int L,
                     int* __restrict__ best_i_out, float* __restrict__ t_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ float s_tri[TILE * 9];

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < L;
    const float ox = live ? rays[0 * (size_t)L + i] : 0.0f;
    const float oy = live ? rays[1 * (size_t)L + i] : 0.0f;
    const float oz = live ? rays[2 * (size_t)L + i] : 0.0f;
    const float dx = live ? rays[3 * (size_t)L + i] : 0.0f;
    const float dy = live ? rays[4 * (size_t)L + i] : 0.0f;
    const float dz = live ? rays[5 * (size_t)L + i] : 0.0f;
    const float t_min = live ? rays[6 * (size_t)L + i] : 0.0f;
    const float t_max = live ? rays[7 * (size_t)L + i] : -1.0f;

    float best_t = INF;
    int best_i = -1;
    float best_u = 0.0f;
    float best_v = 0.0f;

    for (int base = 0; base < T; base += TILE) {
        const int n = min(TILE, T - base);
        __syncthreads();  // the previous tile is no longer read
        for (int j = threadIdx.x; j < n * 9; j += blockDim.x) {
            const int k = j / 9;
            s_tri[j] = tri[(size_t)(base + k) * 12 + (j - 9 * k)];
        }
        __syncthreads();
        for (int k = 0; k < n; ++k) {
            const float* r = s_tri + 9 * k;
            const float p0x = r[0], p0y = r[1], p0z = r[2];
            const float e1x = r[3], e1y = r[4], e1z = r[5];
            const float e2x = r[6], e2y = r[7], e2z = r[8];
            const float pvx = dy * e2z - dz * e2y;
            const float pvy = dz * e2x - dx * e2z;
            const float pvz = dx * e2y - dy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            const float inv = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
            const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
            const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
            const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
            const bool hit = (inv != 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
                             (u + v <= 1.0f) && (t > t_min) &&
                             (t < fminf(best_t, t_max));
            if (hit) {
                best_t = t;
                best_i = base + k;
                best_u = u;
                best_v = v;
            }
        }
    }
    if (live) {
        best_i_out[i] = best_i;
        t_out[i] = best_i < 0 ? INF : best_t;
        u_out[i] = best_u;
        v_out[i] = best_v;
    }
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() as an int
// (0 = launched). tri: [T, 12] f32; rays: [8, L] f32; outputs: [L] each.
extern "C" int ppg_brute_closest(const float* tri, int T, const float* rays,
                                 int L, int* best_i, float* t, float* u,
                                 float* v, void* stream) {
    if (L <= 0) return 0;
    const int grid = (L + BLOCK - 1) / BLOCK;
    brute_closest_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        tri, T, rays, L, best_i, t, u, v);
    return static_cast<int>(cudaGetLastError());
}
