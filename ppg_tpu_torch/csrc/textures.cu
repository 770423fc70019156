// K9: the texture atlas lookup.
//
// It replaces ppg_tpu/scene/textures.py::sample_atlas (:309) with
// _sample_ewa (:352; the taps loop at :418), _trilinear (:297) and
// _bilinear (:273): an XLA chain of small elementwise operations and
// gathers, no Pallas original. Its plain version, the specification, is
// ppg_tpu_torch/scene/textures.py::sample_atlas_plain. One thread does
// one lookup in one of four modes:
// - BASE: the base level's repeat-wrapped bilinear lookup;
// - FOOT: the isotropic trilinear lookup at lod = log2 of the footprint
//   in texels, clipped to [0, 12];
// - DUV: the texture's filterType from the uv Jacobian (duv/dx, duv/dy):
//   ewa (4 trilinear taps along the ellipse's major axis at the clamped
//   minor axis's level, weights exp(-2 t^2)), trilinear at the major
//   axis's level, bilinear, or nearest (uv snapped to the base level's
//   texel centre);
// - BUMP: perturb_normal's taps, base level, at uv, uv + (eps_u, 0) and
//   uv + (0, eps_v) of each lane (lookups i, i + M, i + 2M).
// A lookup's slot id (a spec index plus one) is read per lookup, its uv
// and differentials per lane (lookup i reads lane i % M), so one launch
// serves every textured row of a shading site; a slot id <= 0 returns
// white. Every tap is one 24-byte row of the float16 atlas (the texel and
// its right, down and diagonal neighbours), converted with __half2float.
//
// Bit for bit with the plain version on a card: every operation is the
// plain version's, in its order, each rounded on its own (--fmad=false);
// the float-to-int floors saturate with NaN to 0, as the plain version
// spells out; clamps and maxima are compare and select, passing a NaN on
// as ATen's do; sqrtf, log2f, hypotf and floorf are what ATen's sqrt,
// log2, hypot and floor call on a card; the taps' weights and the
// reciprocal of their sum come from the caller as float32, and the sum is
// a product by that reciprocal, as ATen computes a quotient by a Python
// float on a card.
//
// What bounds it on an H100 (chip_smoke.atlas_bound_ms): bytes. A lookup
// reads its slot id, its lane's uv and differentials, and writes 12 B;
// the atlas rows it reads count once each (24 B), as the plain version's
// distinct rows. Its FP32 work (about 40 operations a bilinear tap, 450
// an EWA lookup) is a few percent of that. A simple kernel: the lanes of
// a warp take their own taps wherever they fall.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int LMAX = 13;
enum { BASE = 0, FOOT = 1, DUV = 2, BUMP = 3 };
constexpr float F_EWA = 0.0f, F_BILINEAR = 2.0f, F_NEAREST = 3.0f;

struct Args {
    const uint2* pixels;  // [P, 12] float16 as [P, 3] uint2
    const int32_t* meta;  // [S, 3] offset, W, H
    const int32_t* mip_meta;  // [S * LMAX, 3]
    const float* uvx;     // [S, 4]
    const float* filt;    // [S, 2]
    int n_slots;
    const float* eps;     // [S, 2]
    const int32_t* tex_id;
    long long tid_n, tid_s;
    const float* uv;
    long long uv_s0, uv_s1;
    const float* d0;
    const float* d1;
    long long d_s0, d_s1;
    long long M;
    int mode;
    float w_outer, w_inner, inv_wsum;
    float* out;
    long long N;
};

// floor(x) as int32: saturating, NaN to 0 (cvt.rmi.s32.f32, and the plain
// version's _floor_i32)
__device__ __forceinline__ int floor_i32(float x) {
    const float f = floorf(x);
    if (f != f) return 0;
    if (f >= 2147483648.0f) return 2147483647;
    if (f < -2147483648.0f) return -2147483647 - 1;
    return static_cast<int>(f);
}

// ATen's clamp(x, min=c): a NaN passes
__device__ __forceinline__ float clamp_min(float x, float c) {
    return x < c ? c : x;
}

// ATen's maximum: a NaN in either wins
__device__ __forceinline__ float maximum(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

__device__ __forceinline__ float clamp_lod(float x) {
    if (x != x) return x;
    return x < 0.0f ? 0.0f : (x > LMAX - 1.0f ? LMAX - 1.0f : x);
}

__device__ __forceinline__ float half_lo(unsigned w) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}

__device__ __forceinline__ float half_hi(unsigned w) {
    return __half2float(
        __ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// repeat-wrapped bilinear lookup at one level (offset, W, H)
__device__ void bilinear(const Args& a, int off, int W, int H,
                         const float* x4, float u_in, float v_in,
                         float* o) {
    const float u = u_in * x4[0] + x4[2];
    const float v = v_in * x4[1] + x4[3];
    const float x = u * static_cast<float>(W) - 0.5f;
    const float y = v * static_cast<float>(H) - 0.5f;
    const int x0 = floor_i32(x);
    const int y0 = floor_i32(y);
    const float dx = x - static_cast<float>(x0);
    const float dy = y - static_cast<float>(y0);
    int xi = x0 % W;
    if (xi < 0) xi += W;
    int yi = y0 % H;
    if (yi < 0) yi += H;
    const long long r = static_cast<long long>(off) +
                        static_cast<long long>(yi) * W + xi;
    const uint2 q0 = __ldg(a.pixels + 3 * r);
    const uint2 q1 = __ldg(a.pixels + 3 * r + 1);
    const uint2 q2 = __ldg(a.pixels + 3 * r + 2);
    const float t[12] = {half_lo(q0.x), half_hi(q0.x), half_lo(q0.y),
                         half_hi(q0.y), half_lo(q1.x), half_hi(q1.x),
                         half_lo(q1.y), half_hi(q1.y), half_lo(q2.x),
                         half_hi(q2.x), half_lo(q2.y), half_hi(q2.y)};
    const float ex = 1.0f - dx, ey = 1.0f - dy;
    for (int c = 0; c < 3; ++c) {
        const float top = t[c] * ex + t[3 + c] * dx;
        const float bot = t[6 + c] * ex + t[9 + c] * dx;
        o[c] = top * ey + bot * dy;
    }
}

// two-level MIP blend at lod in [0, 12] (or NaN: level 0)
__device__ void trilinear(const Args& a, int tid, const float* x4, float u,
                          float v, float lod, float* o) {
    const int l0 = floor_i32(lod);
    const float frac = lod - static_cast<float>(l0);
    const int l1 = l0 + 1 < LMAX - 1 ? l0 + 1 : LMAX - 1;
    const int32_t* ma = a.mip_meta + 3 * (tid * LMAX + l0);
    const int32_t* mb = a.mip_meta + 3 * (tid * LMAX + l1);
    float va[3], vb[3];
    bilinear(a, __ldg(ma), __ldg(ma + 1), __ldg(ma + 2), x4, u, v, va);
    bilinear(a, __ldg(mb), __ldg(mb + 1), __ldg(mb + 2), x4, u, v, vb);
    const float ef = 1.0f - frac;
    for (int c = 0; c < 3; ++c) o[c] = va[c] * ef + vb[c] * frac;
}

__device__ void ewa(const Args& a, int tid, const float* x4, float u,
                    float v, float d0u, float d0v, float d1u, float d1v,
                    float* o) {
    const float W0 = static_cast<float>(__ldg(a.meta + 3 * tid + 1));
    const float H0 = static_cast<float>(__ldg(a.meta + 3 * tid + 2));
    const float mode = __ldg(a.filt + 2 * tid);
    const float max_aniso = clamp_min(__ldg(a.filt + 2 * tid + 1), 1.0f);
    const float su = x4[0] * W0;
    const float sv = x4[1] * H0;
    const float du0 = d0u * su, dv0 = d0v * sv;
    const float du1 = d1u * su, dv1 = d1v * sv;
    const float A = dv0 * dv0 + dv1 * dv1;
    const float B = -2.0f * (du0 * dv0 + du1 * dv1);
    const float C = du0 * du0 + du1 * du1;
    const float F = A * C - 0.25f * B * B;
    const float root = hypotf(A - C, B);
    const float Ap = 0.5f * (A + C - root);
    const float Cp = 0.5f * (A + C + root);
    const float Fp = clamp_min(F, 0.0f);
    const float major = sqrtf(Fp / clamp_min(Ap, 1e-20f));
    const float minor = sqrtf(Fp / clamp_min(Cp, 1e-20f));
    const bool is_ewa = (mode == F_EWA) & (F > 0.0f) & (minor > 0.0f) &
                        (major > 0.0f);
    const float minor_c = maximum(minor, major / max_aniso);
    const float lod_tri = log2f(clamp_min(major, 1e-9f));
    const float lod_ewa = log2f(clamp_min(minor_c, 1e-9f));
    float lod = is_ewa ? lod_ewa : lod_tri;
    if (mode >= F_BILINEAR) lod = 0.0f;
    lod = clamp_lod(lod);

    if (mode == F_NEAREST) {
        const float ut = u * x4[0] + x4[2];
        const float vt = v * x4[1] + x4[3];
        u = ((floorf(ut * W0) + 0.5f) / W0 - x4[2]) /
            (x4[0] == 0.0f ? 1.0f : x4[0]);
        v = ((floorf(vt * H0) + 0.5f) / H0 - x4[3]) /
            (x4[1] == 0.0f ? 1.0f : x4[1]);
    }

    const float v1x = 0.5f * B, v1y = Ap - A;
    const float v2x = Ap - C, v2y = 0.5f * B;
    const bool pick = (v1x * v1x + v1y * v1y) >= (v2x * v2x + v2y * v2y);
    float axx = pick ? v1x : v2x;
    float axy = pick ? v1y : v2y;
    const float nrm = sqrtf(axx * axx + axy * axy);
    const float nrm_c = clamp_min(nrm, 1e-20f);
    if (nrm > 1e-20f) {
        axx = axx / nrm_c;
        axy = axy / nrm_c;
    } else {
        axx = 1.0f;
        axy = 0.0f;
    }
    const float ext = is_ewa ? clamp_min(major - minor_c, 0.0f) : 0.0f;
    const float off_u = axx * ext / clamp_min(su, 1e-20f);
    const float off_v = axy * ext / clamp_min(sv, 1e-20f);

    const float ts[4] = {-0.75f, -0.25f, 0.25f, 0.75f};
    const float ws[4] = {a.w_outer, a.w_inner, a.w_inner, a.w_outer};
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 4; ++k) {
        float tap[3];
        trilinear(a, tid, x4, u + off_u * ts[k], v + off_v * ts[k], lod,
                  tap);
        for (int c = 0; c < 3; ++c) acc[c] = acc[c] + ws[k] * tap[c];
    }
    for (int c = 0; c < 3; ++c) o[c] = acc[c] * a.inv_wsum;
}

__global__ void __launch_bounds__(BLOCK) atlas_kernel(const Args a) {
    const long long i = static_cast<long long>(blockIdx.x) * BLOCK +
                        threadIdx.x;
    if (i >= a.N) return;
    const long long lane = i % a.M;
    float* o = a.out + 3 * i;
    const int raw = __ldg(a.tex_id + (i % a.tid_n) * a.tid_s);
    if (raw <= 0) {
        o[0] = o[1] = o[2] = 1.0f;
        return;
    }
    const int tid = raw < a.n_slots ? raw : a.n_slots - 1;
    const float4 x4v = __ldg(reinterpret_cast<const float4*>(a.uvx) + tid);
    const float x4[4] = {x4v.x, x4v.y, x4v.z, x4v.w};
    float u = __ldg(a.uv + lane * a.uv_s0);
    float v = __ldg(a.uv + lane * a.uv_s0 + a.uv_s1);
    float val[3];
    if (a.mode == DUV) {
        const long long d = lane * a.d_s0;
        ewa(a, tid, x4, u, v, __ldg(a.d0 + d), __ldg(a.d0 + d + a.d_s1),
            __ldg(a.d1 + d), __ldg(a.d1 + d + a.d_s1), val);
    } else if (a.mode == FOOT) {
        const long long d = lane * a.d_s0;
        const float fu = __ldg(a.d0 + d), fv = __ldg(a.d0 + d + a.d_s1);
        const float W0 = static_cast<float>(__ldg(a.meta + 3 * tid + 1));
        const float H0 = static_cast<float>(__ldg(a.meta + 3 * tid + 2));
        const float texels = maximum(fabsf(fu * x4[0]) * W0,
                                     fabsf(fv * x4[1]) * H0);
        const float lod = clamp_lod(log2f(clamp_min(texels, 1e-9f)));
        trilinear(a, tid, x4, u, v, lod, val);
    } else {
        if (a.mode == BUMP) {
            const long long kind = i / a.M;
            if (kind == 1) {
                u = u + __ldg(a.eps + 2 * tid);
                v = v + 0.0f;
            } else if (kind == 2) {
                u = u + 0.0f;
                v = v + __ldg(a.eps + 2 * tid + 1);
            }
        }
        const int32_t* m = a.meta + 3 * tid;
        bilinear(a, __ldg(m), __ldg(m + 1), __ldg(m + 2), x4, u, v, val);
    }
    o[0] = val[0];
    o[1] = val[1];
    o[2] = val[2];
}

}  // namespace

// K9 on `stream` of card `device`: out [N, 3] (contiguous) of N lookups.
// The atlas (pixels [P, 12] float16, meta [S, 3] and mip_meta [S * 13, 3]
// int32, uvx [S, 4], filt [S, 2] and eps [S, 2] float32) is contiguous;
// tex_id (int32, tid_n entries, stride tid_s) is read at i % tid_n, uv and
// the differentials (M rows each, through their strides; d0 = d1 = the
// footprint in FOOT mode, null in BASE and BUMP) at lane i % M; mode is
// BASE, FOOT, DUV or BUMP (N = 3M). Returns cudaGetLastError() as an int
// (0 = launched), or cudaErrorInvalidValue for an argument out of range.
extern "C" int ppg_atlas_sample(
    const void* pixels, const int32_t* meta, const int32_t* mip_meta,
    const float* uvx, const float* filt, int n_slots, const float* eps,
    const int32_t* tex_id, long long tid_n, long long tid_s, const float* uv,
    long long uv_s0, long long uv_s1, const float* d0, const float* d1,
    long long d_s0, long long d_s1, long long M, int mode, float w_outer,
    float w_inner, float inv_wsum, float* out, long long N, int device,
    void* stream) {
    if (N <= 0) return 0;
    if (M <= 0 || tid_n <= 0 || n_slots <= 0 || mode < BASE ||
        mode > BUMP || N > 0x7fffffffLL * BLOCK ||
        ((mode == FOOT || mode == DUV) && (d0 == nullptr || d1 == nullptr)))
        return cudaErrorInvalidValue;
    const Args a{static_cast<const uint2*>(pixels), meta, mip_meta, uvx,
                 filt, n_slots, eps, tex_id, tid_n, tid_s, uv, uv_s0,
                 uv_s1, d0, d1, d_s0, d_s1, M, mode, w_outer, w_inner,
                 inv_wsum, out, N};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const unsigned grid = static_cast<unsigned>((N + BLOCK - 1) / BLOCK);
    atlas_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
