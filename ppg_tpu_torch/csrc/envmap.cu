// K10: the environment map's sampling and lookup.
//
// It replaces ppg_tpu/emitters/envmap.py::sample_direct (:208), whose
// _sample_cdf (:180) inverts the row and column luminance CDFs by two
// unrolled binary searches (ceil(log2 n) + 1 rounds each: 12 and 13 on a
// 4096 x 2048 map), with eval_env (:166) and pdf_direct (:260): an XLA
// chain, no Pallas original. In eager PyTorch those are about 470
// launches a bounce; here one launch a call:
//   - mode 0 (sample): sample_direct from a point ref_p with the
//     uniforms (ux, uy): both CDF inversions, the tent jitter, the
//     bilinear value and pdf, the direction through rot and the far hit
//     on the scene's bounding sphere; writes d, dist, pdf and value;
//   - mode 1 (lookup): eval_env and pdf_direct for directions d; writes
//     value and pdf.
// The semantics are those of the plain version,
// ppg_tpu_torch/emitters/envmap.py::sample_direct_plain and lookup_plain:
// a lane is computed where the gate lets it in (its int32 key equals
// key_val where a key is given, and its masks are set where they are
// given) and gets zeros elsewhere; pdf is multiplied by 1 / n and value by
// n (the emitter-slot count, as ATen divides and multiplies by a Python
// number on a card). The binary search is _sample_cdf's: lo moves up to
// mid where u >= cdf[mid], hi down to mid elsewhere, until hi - lo <= 1;
// the plain version runs a fixed number of rounds, but once hi - lo <= 1
// mid = lo and lo cannot move, so the index is the same. Every other
// operation is the plain version's, in its order: the rotations' products
// summed left to right, clamps as compare and select (which pass a NaN
// on), the texel wrap a floor modulo, floats to int32 saturating with NaN
// to 0 (XLA's conversion), the constants as ATen rounds a Python float
// (the double cast to float), and the CUDA math library's atan2f, acosf,
// sinf, cosf and sqrtf, which ATen's atan2, acos, sin, cos and sqrt call
// on a card. Built with --fmad=false, so no product is fused into a sum:
// the kernel equals the plain version bit for bit.
//
// One thread a lane. This is the first, simple version: the searches'
// loads are dependent, one CDF entry a round from a row of W + 1 floats
// that a warp's lanes seldom share.
//
// What bounds it on an H100 (chip_smoke.env_bound_ms): bytes. Each lane
// reads its gate's key and masks and writes its outputs; a gated-in lane
// reads its inputs, and the call reads each distinct CDF entry (4 B) and
// each distinct texel (12 B) its lanes need once. On chip_smoke phase
// 17's calls (the sky box, a 4096 x 2048 sunsky; NVIDIA H100 80GB HBM3,
// 700 W), alone: the last NEE call, 25,858 of 262,144 lanes gated in,
// 0.0138 ms, a quarter of its bound (0.0034 ms); the last bounce's
// escaped lanes, 7,288 gated in, 0.0064-0.0067 ms (bound 0.0018 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int SAMPLE = 0, LOOKUP = 1;

// Python floats as ATen rounds them: the double to float
constexpr float INV_TWOPI = static_cast<float>(0.15915494309189535);
constexpr float INV_PI = static_cast<float>(0.3183098861837907);
constexpr float EPS = static_cast<float>(1e-4);
constexpr float TINY_STEP = static_cast<float>(1e-20);
constexpr float TINY_PDF = static_cast<float>(1e-30);
constexpr float LUM_R = static_cast<float>(0.212671);
constexpr float LUM_G = static_cast<float>(0.715160);
constexpr float LUM_B = static_cast<float>(0.072169);

struct Args {
    const float* img;      // [H*W, 3]
    const float* row_cdf;  // [H+1]
    const float* col_cdf;  // [H*(W+1)]
    const float* row_w;    // [H]
    const float* consts;   // norm, rot[9], rot_inv[9], center[3], r^2
    int H, W;
    float phi_scale, theta_scale, n, inv_n;
    const float* x;  // d (lookup) or ref_p (sample), [L,3]
    long long x_s0, x_s1;
    const float* ux;
    long long ux_s;
    const float* uy;
    long long uy_s;
    const int32_t* key;  // null: no key
    long long key_s;
    int key_val;
    const uint8_t* m1;  // null: no mask
    long long m1_s;
    const uint8_t* m2;
    long long m2_s;
    float* d;      // [L,3] (sample)
    float* dist;   // [L] (sample)
    float* pdf;    // [L]
    float* value;  // [L,3]
    int L;
};

// max(x, c) as the plain version's compare and select
__device__ __forceinline__ float at_least(float x, float c) {
    return x < c ? c : x;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
    x = x < lo ? lo : x;
    return x > hi ? hi : x;
}

// floor(x) as int32, saturating, NaN to 0 (the plain version's
// _floor_i32)
__device__ __forceinline__ int floor_i32(float x) {
    const float f = floorf(x);
    if (f != f) return 0;
    if (f >= 2147483648.0f) return 2147483647;
    if (f < -2147483648.0f) return -2147483647 - 1;
    return static_cast<int>(f);
}

// int32 addition that wraps, as the plain version's int32 tensors do
__device__ __forceinline__ int add_i32(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
}

__device__ __forceinline__ float lum(const float* v) {
    return v[0] * LUM_R + v[1] * LUM_G + v[2] * LUM_B;
}

// one bilinear row: texel(x0, y) (1 - dx1) + texel(x0 + 1, y) dx1, x
// wrapped by a floor modulo, y clamped to [0, H-1]
__device__ __forceinline__ void bilerp_row(const Args& a, int x0, int y,
                                           float dx1, float* out) {
    const int yi = y < 0 ? 0 : (y > a.H - 1 ? a.H - 1 : y);
    int xa = x0 % a.W;
    if (xa < 0) xa += a.W;
    int xb = add_i32(x0, 1) % a.W;
    if (xb < 0) xb += a.W;
    const float* pa = a.img + 3 * (static_cast<long long>(yi) * a.W + xa);
    const float* pb = a.img + 3 * (static_cast<long long>(yi) * a.W + xb);
    const float w0 = 1.0f - dx1;
    for (int c = 0; c < 3; ++c)
        out[c] = __ldg(pa + c) * w0 + __ldg(pb + c) * dx1;
}

// v1 = row y0's value times 1 - dy, v2 = row y0 + 1's times dy, at texel
// coordinates (x, y); returns y0
__device__ __forceinline__ int bilinear_parts(const Args& a, float x,
                                              float y, float* v1, float* v2) {
    const int x0 = floor_i32(x), y0 = floor_i32(y);
    const float dx1 = x - static_cast<float>(x0);
    const float dy1 = y - static_cast<float>(y0);
    bilerp_row(a, x0, y0, dx1, v1);
    bilerp_row(a, x0, add_i32(y0, 1), dx1, v2);
    const float wy = 1.0f - dy1;
    for (int c = 0; c < 3; ++c) {
        v1[c] = v1[c] * wy;
        v2[c] = v2[c] * dy1;
    }
    return y0;
}

// lum(v1) rowWeight(y0) + lum(v2) rowWeight(y0 + 1)
__device__ __forceinline__ float row_pdf(const Args& a, const float* v1,
                                         const float* v2, int y0) {
    const int y1 = add_i32(y0, 1);
    const int r0 = y0 < 0 ? 0 : (y0 > a.H - 1 ? a.H - 1 : y0);
    const int r1 = y1 < 0 ? 0 : (y1 > a.H - 1 ? a.H - 1 : y1);
    return lum(v1) * __ldg(a.row_w + r0) + lum(v2) * __ldg(a.row_w + r1);
}

// the inversion of cdf[base : base + size + 1] at u: the index, and the
// rescaled remainder in *rem
__device__ __forceinline__ int sample_cdf(const float* cdf, long long base,
                                          int size, float u, float* rem) {
    int lo = 0, hi = size;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (u >= __ldg(cdf + base + mid))
            lo = mid;
        else
            hi = mid;
    }
    const int idx = lo > size - 1 ? size - 1 : lo;
    const float c0 = __ldg(cdf + base + idx);
    const float c1 = __ldg(cdf + base + idx + 1);
    *rem = clip((u - c0) / at_least(c1 - c0, TINY_STEP), 0.0f, 1.0f);
    return idx;
}

// warp::intervalToTent
__device__ __forceinline__ float interval_to_tent(float x) {
    const bool neg = x < 0.5f;
    const float x2 = neg ? 1.0f - 2.0f * x : 2.0f * x - 1.0f;
    const float t = 1.0f - sqrtf(clip(1.0f - x2, 0.0f, 1.0f));
    return neg ? -t : t;
}

__device__ __forceinline__ bool gated_in(const Args& a, int i) {
    return (a.key == nullptr || a.key[i * a.key_s] == a.key_val) &&
           (a.m1 == nullptr || a.m1[i * a.m1_s] != 0) &&
           (a.m2 == nullptr || a.m2[i * a.m2_s] != 0);
}

__device__ __forceinline__ void lookup(const Args& a, int i) {
    const float* c = a.consts;
    const float* xi = a.x + i * a.x_s0;
    const float d0 = xi[0], d1 = xi[a.x_s1], d2 = xi[2 * a.x_s1];
    const float* r = c + 10;  // rot_inv
    const float dl0 = d0 * r[0] + d1 * r[1] + d2 * r[2];
    const float dl1 = d0 * r[3] + d1 * r[4] + d2 * r[5];
    const float dl2 = d0 * r[6] + d1 * r[7] + d2 * r[8];
    float u = atan2f(dl0, -dl2) * INV_TWOPI;
    u = u < 0.0f ? u + 1.0f : u;
    const float v = acosf(clip(dl1, -1.0f, 1.0f)) * INV_PI;
    float v1[3], v2[3];
    const int y0 = bilinear_parts(a, u * static_cast<float>(a.W) - 0.5f,
                                  v * static_cast<float>(a.H) - 0.5f, v1,
                                  v2);
    const float st = sqrtf(clip(1.0f - dl1 * dl1, 0.0f, 1.0f));
    const float pdf = row_pdf(a, v1, v2, y0) * c[0] / at_least(st, EPS);
    a.pdf[i] = pdf * a.inv_n;
    for (int k = 0; k < 3; ++k) a.value[3 * i + k] = v1[k] + v2[k];
}

__device__ __forceinline__ void sample(const Args& a, int i) {
    const float* c = a.consts;
    const float ux = a.ux[i * a.ux_s], uy = a.uy[i * a.uy_s];
    float ry, rx;
    const int row = sample_cdf(a.row_cdf, 0, a.H, uy, &ry);
    const int col = sample_cdf(a.col_cdf,
                               static_cast<long long>(row) * (a.W + 1), a.W,
                               ux, &rx);
    const float px = static_cast<float>(col) + interval_to_tent(rx);
    const float py = static_cast<float>(row) + interval_to_tent(ry);
    float v1[3], v2[3];
    const int y0 = bilinear_parts(a, px, py, v1, v2);
    float value[3];
    for (int k = 0; k < 3; ++k) value[k] = v1[k] + v2[k];
    float pdf = row_pdf(a, v1, v2, y0) * c[0];
    const float phi = (px + 0.5f) * a.phi_scale;
    const float theta = (py + 0.5f) * a.theta_scale;
    const float st = sinf(theta), ct = cosf(theta);
    const float sp = sinf(phi), cp = cosf(phi);
    pdf = pdf / at_least(fabsf(st), EPS);
    const float dl0 = sp * st, dl1 = ct, dl2 = -cp * st;
    const float* r = c + 1;  // rot
    const float d0 = dl0 * r[0] + dl1 * r[1] + dl2 * r[2];
    const float d1 = dl0 * r[3] + dl1 * r[4] + dl2 * r[5];
    const float d2 = dl0 * r[6] + dl1 * r[7] + dl2 * r[8];
    // the far hit on the scene's bounding sphere
    const float* p = a.x + i * a.x_s0;
    const float oc0 = p[0] - c[19], oc1 = p[a.x_s1] - c[20],
                oc2 = p[2 * a.x_s1] - c[21];
    const float b = oc0 * d0 + oc1 * d1 + oc2 * d2;
    const float cc = (oc0 * oc0 + oc1 * oc1 + oc2 * oc2) - c[22];
    const float disc = b * b - cc;
    const float sq = sqrtf(disc < 0.0f ? 0.0f : disc);
    const float near = -b - sq, far = -b + sq;
    const bool ok = disc > 0.0f && near < 0.0f && far > 0.0f && pdf > 0.0f;
    pdf = ok ? pdf : 0.0f;
    const float den = at_least(pdf, TINY_PDF);
    a.d[3 * i] = d0;
    a.d[3 * i + 1] = d1;
    a.d[3 * i + 2] = d2;
    a.dist[i] = far;
    a.pdf[i] = pdf * a.inv_n;
    for (int k = 0; k < 3; ++k)
        a.value[3 * i + k] = (ok ? value[k] / den : 0.0f) * a.n;
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK) env_kernel(const Args a) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= a.L) return;
    if (!gated_in(a, i)) {
        a.pdf[i] = 0.0f;
        for (int k = 0; k < 3; ++k) a.value[3 * i + k] = 0.0f;
        if (MODE == SAMPLE) {
            a.dist[i] = 0.0f;
            for (int k = 0; k < 3; ++k) a.d[3 * i + k] = 0.0f;
        }
        return;
    }
    if (MODE == SAMPLE)
        sample(a, i);
    else
        lookup(a, i);
}

}  // namespace

// K10 on `stream` of card `device`, in `mode` (0 sample, 1 lookup), over
// L lanes: the map's tables (img [H*W,3], row_cdf [H+1], col_cdf
// [H*(W+1)], row_w [H], consts [23]: norm, rot, rot_inv, the bounding
// sphere's centre and squared radius), the scales of a pixel centre to
// phi and theta, the slot count n and 1 / n (float32); x [L,3] (the
// directions in lookup mode, the points in sample mode) through its
// element strides, ux and uy [L] (sample mode) through theirs; the gate:
// key [L] int32 (or null) compared with key_val, masks m1 and m2 [L] (or
// null), each through its stride. Writes value [L,3] and pdf [L], and in
// sample mode d [L,3] and dist [L] (all contiguous). Returns
// cudaGetLastError() as an int (0 = launched), or cudaErrorInvalidValue
// for L of 2^31 or more.
extern "C" int ppg_env(int mode, const float* img, const float* row_cdf,
                       const float* col_cdf, const float* row_w,
                       const float* consts, int H, int W, float phi_scale,
                       float theta_scale, float n, float inv_n,
                       const float* x, long long x_s0, long long x_s1,
                       const float* ux, long long ux_s, const float* uy,
                       long long uy_s, const int32_t* key, long long key_s,
                       int key_val, const uint8_t* m1, long long m1_s,
                       const uint8_t* m2, long long m2_s, float* d,
                       float* dist, float* pdf, float* value, long long L,
                       int device, void* stream) {
    if (L <= 0) return 0;
    if (L > 0x7fffffffLL - BLOCK || (mode != SAMPLE && mode != LOOKUP))
        return cudaErrorInvalidValue;
    const Args a{img,   row_cdf, col_cdf, row_w, consts, H,     W,
                 phi_scale, theta_scale, n, inv_n, x,   x_s0,  x_s1,
                 ux,    ux_s,    uy,      uy_s,  key,    key_s, key_val,
                 m1,    m1_s,    m2,      m2_s,  d,      dist,  pdf,
                 value, static_cast<int>(L)};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const int grid = static_cast<int>((L + BLOCK - 1) / BLOCK);
    if (mode == SAMPLE)
        env_kernel<SAMPLE><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    else
        env_kernel<LOOKUP><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
