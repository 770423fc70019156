// K9: the texture atlas lookup.
//
// It replaces ppg_tpu/scene/textures.py::sample_atlas (:309) with
// _sample_ewa (:352; the taps loop at :418), _trilinear (:297) and
// _bilinear (:273): an XLA chain of small elementwise operations and
// gathers, no Pallas original. Its plain version, the specification, is
// ppg_tpu_torch/scene/textures.py::sample_atlas_plain. A lookup is in one
// of four modes:
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
// Rows read: only those a lookup's value depends on. A trilinear lookup
// at fraction 0 blends va * 1 + vb * 0; on a slot whose texels are all
// finite and sign-clear (the atlas's tap_safe, built once with it), with
// level l1's texel coordinates where the floor is exact, vb is finite and
// +0 or more, so vb * 0 is a zero of the fraction's sign, as (+0) * 0 is:
// l1's row is not read and vb is +0 (the argument in full:
// textures.py::_level_one_unread). A NaN lod has a NaN fraction and reads
// both. Where a Jacobian's taps all coincide (their offsets both zero,
// which NaN is not), one trilinear lookup stands for the four: a signed
// zero in a tap's u cannot reach the value, since x = u * W - 0.5 absorbs
// it, and the four are still summed in the plain version's order and
// weights. A lookup at a later bounce (zero differentials) reads one row,
// not eight.
//
// The design. Most lookups are untextured (phase 16's last calls:
// 375,418 of the first bounce's site call's 524,288 lookups, 296,262 of a
// later bounce's, 223,556 of a walk crossing's 262,144, 774,111 of a bump
// call's 786,432), and a thread a lookup left their lanes idle beside
// the textured ones. A persistent grid's blocks take tiles of BLOCK
// lookups in turn. A thread reads its lookup's slot id first: an
// untextured lookup writes white and loads nothing else. A textured one
// joins the block's queue in shared memory (16-lane ballots, their counts
// scanned by the first group, tile order kept). Once the queue holds
// BLOCK lookups every thread computes one of them, so every warp runs
// full; what is left when the block runs out of tiles is computed in one
// pass. A queued lookup's inputs are read where it is computed. A lookup
// is a chain of dependent loads (slot id; its slot's rows and its lane's
// uv and differentials; the level's row), so the kernel runs at eight
// blocks an SM (32 registers, 96 bytes spilled) to keep more of them in
// flight.
//
// Held against others on phase 16's last call of each kind (k1_compare.py
// --kernel k9, each in turns with this one and the first design in one
// run, NVIDIA H100 80GB HBM3, 700 W, ms alone over copies of the inputs
// and the atlas above the L2; the bump map, the first bounce's site call,
// a walk crossing, a later bounce's site call): the first design, one
// thread a lookup reading every row the plain version reads, 0.0093,
// 0.0171-0.0172, 0.0053-0.0054, 0.0404-0.0407; this one 0.0076,
// 0.0160-0.0161, 0.0046, 0.0154-0.0155. One thread a lookup reading only
// the rows above: 0.0082, 0.0152-0.0153, 0.0048, 0.0198-0.0199 (40
// registers); at eight blocks an SM 0.0076-0.0077, 0.0137-0.0138,
// 0.0046-0.0047, 0.0191-0.0192. The queue at the compiler's 48 registers
// (five blocks an SM) 0.0078-0.0081, 0.0212-0.0215, 0.0046-0.0048,
// 0.0160-0.0161, at six blocks 0.0080, 0.0222-0.0231, 0.0046, 0.0162.
// Three queues, by class (one row, one tap at two levels, four EWA taps;
// the class found before queueing, which computes the ellipse twice; 62
// registers): 0.0109, 0.0258-0.0259, 0.0057-0.0058, 0.0309-0.0310; with
// blocks of 128 0.0107, 0.0321-0.0326, 0.0059-0.0061, 0.0320, of 512
// 0.0114, 0.0263-0.0264, 0.0059-0.0060, 0.0310. Blocks of 128 at 16 an SM
// 0.0078-0.0079, 0.0185, 0.0047, 0.0162. A grid of half the tiles,
// scheduled by the card: 0.0096, 0.0163-0.0167, 0.0051, 0.0143-0.0144;
// one tile a block 0.0122-0.0123, 0.0171, 0.0058, 0.0196; four
// consecutive tiles a block 0.0116, 0.0320-0.0322, 0.0065-0.0066,
// 0.0236-0.0238 (both at 48 registers, with the next variant). A skipped
// level's tap loading level l0's row again, with no branch: a later
// bounce 0.0175 against 0.0160 queued, 0.0234 against 0.0198-0.0199 a
// thread a lookup.
//
// What bounds it on an H100 (chip_smoke.atlas_bound_ms): bytes. A lookup
// reads its slot id, its lane's uv and differentials, and writes 12 B;
// the atlas rows its value depends on count once each (24 B). Its FP32
// work (about 40 operations a bilinear tap, 450 an EWA lookup) is a few
// percent of that.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // a block's threads, a tile's lookups
constexpr int GROUP = 16;   // the lanes of one ballot
constexpr int GROUPS = BLOCK / GROUP;
static_assert(GROUPS == GROUP, "a group scans the tile's group counts");
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
    const int32_t* tap_safe;  // [S]
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
    int N;
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

// floor(x) is an int32: x finite and floor(x) in [-2^31, 2^31), so the
// weight x - floor(x) is exact and in [0, 1) (_exact_floor)
__device__ __forceinline__ bool exact_floor(float x) {
    const float f = floorf(x);
    return f >= -2147483648.0f && f < 2147483648.0f;
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

// a lookup's texel coordinates at a level W x H (_texel_xy)
__device__ __forceinline__ void texel_xy(const float* x4, float u_in,
                                         float v_in, int W, int H, float* x,
                                         float* y) {
    const float u = u_in * x4[0] + x4[2];
    const float v = v_in * x4[1] + x4[3];
    *x = u * static_cast<float>(W) - 0.5f;
    *y = v * static_cast<float>(H) - 0.5f;
}

// repeat-wrapped bilinear lookup at one level (offset, W, H)
__device__ __forceinline__ void bilinear(const Args& a, int off, int W,
                                         int H, const float* x4, float u_in,
                                         float v_in, float* o) {
    float x, y;
    texel_xy(x4, u_in, v_in, W, H, &x, &y);
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

// A trilinear lookup's levels l0 and l1 (their mip_meta rows) and its
// fraction; returns whether level l1's row is left unread
// (_level_one_unread): fraction 0 (false for NaN), the slot tap-safe and
// l1's texel coordinates where the floor is exact.
__device__ bool levels(const Args& a, int tid, bool safe, const float* x4,
                       float u, float v, float lod, const int32_t** ma,
                       const int32_t** mb, float* frac) {
    const int l0 = floor_i32(lod);
    *frac = lod - static_cast<float>(l0);
    const int l1 = l0 + 1 < LMAX - 1 ? l0 + 1 : LMAX - 1;
    *ma = a.mip_meta + 3 * (tid * LMAX + l0);
    *mb = a.mip_meta + 3 * (tid * LMAX + l1);
    if (!(*frac == 0.0f && safe)) return false;
    float x, y;
    texel_xy(x4, u, v, __ldg(*mb + 1), __ldg(*mb + 2), &x, &y);
    return exact_floor(x) && exact_floor(y);
}

// two-level MIP blend at lod in [0, 12] (or NaN: level 0)
__device__ __forceinline__ void trilinear(const Args& a, int tid, bool safe,
                                          const float* x4, float u, float v,
                                          float lod, float* o) {
    const int32_t *ma, *mb;
    float frac;
    const bool skip = levels(a, tid, safe, x4, u, v, lod, &ma, &mb, &frac);
    float va[3], vb[3] = {0.0f, 0.0f, 0.0f};
    bilinear(a, __ldg(ma), __ldg(ma + 1), __ldg(ma + 2), x4, u, v, va);
    if (!skip)
        bilinear(a, __ldg(mb), __ldg(mb + 1), __ldg(mb + 2), x4, u, v, vb);
    const float ef = 1.0f - frac;
    for (int c = 0; c < 3; ++c) o[c] = va[c] * ef + vb[c] * frac;
}

// a textured lookup's inputs, up to its taps
struct Lookup {
    int tid;
    bool safe;
    float x4[4];
    float u, v;           // BASE, BUMP: the tap; FOOT, DUV: the centre
    float lod;            // FOOT, DUV
    float off_u, off_v;   // DUV: the taps at uv + off * t
};

// DUV: the ellipse of the uv Jacobian (d0u, d0v), (d1u, d1v): the lod, the
// nearest snap and the taps' offsets (_ellipse)
__device__ void ellipse(const Args& a, float d0u, float d0v, float d1u,
                        float d1v, Lookup& p) {
    const int tid = p.tid;
    const float* x4 = p.x4;
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
    p.lod = clamp_lod(lod);

    if (mode == F_NEAREST) {
        const float ut = p.u * x4[0] + x4[2];
        const float vt = p.v * x4[1] + x4[3];
        p.u = ((floorf(ut * W0) + 0.5f) / W0 - x4[2]) /
              (x4[0] == 0.0f ? 1.0f : x4[0]);
        p.v = ((floorf(vt * H0) + 0.5f) / H0 - x4[3]) /
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
    p.off_u = axx * ext / clamp_min(su, 1e-20f);
    p.off_v = axy * ext / clamp_min(sv, 1e-20f);
}

__device__ __forceinline__ int slot_id(const Args& a, int i) {
    return __ldg(a.tex_id + (i % a.tid_n) * a.tid_s);
}

// lookup i's inputs (slot id raw > 0)
__device__ void prepare(const Args& a, int i, int raw, Lookup& p) {
    const long long lane = i % a.M;
    const int tid = raw < a.n_slots ? raw : a.n_slots - 1;
    p.tid = tid;
    p.safe = false;
    const float4 x4v = __ldg(reinterpret_cast<const float4*>(a.uvx) + tid);
    p.x4[0] = x4v.x;
    p.x4[1] = x4v.y;
    p.x4[2] = x4v.z;
    p.x4[3] = x4v.w;
    p.u = __ldg(a.uv + lane * a.uv_s0);
    p.v = __ldg(a.uv + lane * a.uv_s0 + a.uv_s1);
    if (a.mode == BUMP) {
        const long long kind = i / a.M;
        if (kind == 1) {
            p.u = p.u + __ldg(a.eps + 2 * tid);
            p.v = p.v + 0.0f;
        } else if (kind == 2) {
            p.u = p.u + 0.0f;
            p.v = p.v + __ldg(a.eps + 2 * tid + 1);
        }
        return;
    }
    if (a.mode == BASE) return;
    p.safe = __ldg(a.tap_safe + tid) != 0;
    const long long d = lane * a.d_s0;
    if (a.mode == DUV) {
        ellipse(a, __ldg(a.d0 + d), __ldg(a.d0 + d + a.d_s1),
                __ldg(a.d1 + d), __ldg(a.d1 + d + a.d_s1), p);
        return;
    }
    const float fu = __ldg(a.d0 + d), fv = __ldg(a.d0 + d + a.d_s1);
    const float W0 = static_cast<float>(__ldg(a.meta + 3 * tid + 1));
    const float H0 = static_cast<float>(__ldg(a.meta + 3 * tid + 2));
    const float texels = maximum(fabsf(fu * p.x4[0]) * W0,
                                 fabsf(fv * p.x4[1]) * H0);
    p.lod = clamp_lod(log2f(clamp_min(texels, 1e-9f)));
}

// lookup i (slot id raw > 0): its value written to out
__device__ void compute(const Args& a, int i, int raw) {
    Lookup p;
    prepare(a, i, raw, p);
    float val[3];
    if (a.mode == BASE || a.mode == BUMP) {
        const int32_t* m = a.meta + 3 * p.tid;
        bilinear(a, __ldg(m), __ldg(m + 1), __ldg(m + 2), p.x4, p.u, p.v,
                 val);
    } else if (a.mode == FOOT) {
        trilinear(a, p.tid, p.safe, p.x4, p.u, p.v, p.lod, val);
    } else {
        const float ts[4] = {-0.75f, -0.25f, 0.25f, 0.75f};
        const float ws[4] = {a.w_outer, a.w_inner, a.w_inner, a.w_outer};
        float acc[3] = {0.0f, 0.0f, 0.0f};
        if (p.off_u == 0.0f && p.off_v == 0.0f) {
            // the four taps coincide: one lookup, summed four times
            float tap[3];
            trilinear(a, p.tid, p.safe, p.x4, p.u + p.off_u * ts[0],
                      p.v + p.off_v * ts[0], p.lod, tap);
            for (int k = 0; k < 4; ++k)
                for (int c = 0; c < 3; ++c) acc[c] = acc[c] + ws[k] * tap[c];
        } else {
            for (int k = 0; k < 4; ++k) {
                float tap[3];
                trilinear(a, p.tid, p.safe, p.x4, p.u + p.off_u * ts[k],
                          p.v + p.off_v * ts[k], p.lod, tap);
                for (int c = 0; c < 3; ++c) acc[c] = acc[c] + ws[k] * tap[c];
            }
        }
        for (int c = 0; c < 3; ++c) val[c] = acc[c] * a.inv_wsum;
    }
    float* o = a.out + 3 * static_cast<long long>(i);
    o[0] = val[0];
    o[1] = val[1];
    o[2] = val[2];
}

__device__ __forceinline__ void white(const Args& a, int i) {
    float* o = a.out + 3 * static_cast<long long>(i);
    o[0] = o[1] = o[2] = 1.0f;
}

__global__ void __launch_bounds__(BLOCK, 8) atlas_kernel(const Args a) {
    // the queue holds under BLOCK lookups between tiles, and a tile adds
    // at most BLOCK
    __shared__ int s_queue[2 * BLOCK];
    __shared__ unsigned s_in[GROUPS];  // a tile's textured lookups, by group
    __shared__ int s_at[GROUPS + 1];   // their offsets and total
    const int t = threadIdx.x, lane = t % GROUP, grp = t / GROUP;
    const unsigned gmask = 0xffffu << (t & GROUP);
    const int tiles = (a.N + BLOCK - 1) / BLOCK;
    int queued = 0;  // the same in every thread
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int i = tile * BLOCK + t;
        bool in = false;
        if (i < a.N) {
            if (slot_id(a, i) <= 0) white(a, i);
            else in = true;
        }
        const unsigned bits =
            (__ballot_sync(gmask, in) >> (t & GROUP)) & 0xffffu;
        if (lane == 0) s_in[grp] = bits;
        __syncthreads();
        // the first group scans the group counts
        if (t < GROUP) {
            const int c = __popc(s_in[lane]);
            int x = c;
            for (int d = 1; d < GROUP; d <<= 1) {
                const int y = __shfl_sync(gmask, x, lane - d, GROUP);
                if (lane >= d) x += y;
            }
            s_at[lane] = x - c;
            if (lane == GROUP - 1) s_at[GROUPS] = x;
        }
        __syncthreads();
        if (in)
            s_queue[queued + s_at[grp] +
                    __popc(bits & ((1u << lane) - 1u))] = i;
        queued += s_at[GROUPS];
        __syncthreads();
        // a full queue: every thread computes one of its lookups
        if (queued >= BLOCK) {
            const int j = s_queue[t];
            compute(a, j, slot_id(a, j));
            const int rest = queued - BLOCK;
            const int keep = t < rest ? s_queue[BLOCK + t] : 0;
            __syncthreads();
            if (t < rest) s_queue[t] = keep;
            __syncthreads();
            queued = rest;
        }
    }
    // the block's remainder
    if (t < queued) {
        const int j = s_queue[t];
        compute(a, j, slot_id(a, j));
    }
}

}  // namespace

// K9 on `stream` of card `device`: out [N, 3] (contiguous) of N lookups.
// The atlas (pixels [P, 12] float16, meta [S, 3] and mip_meta [S * 13, 3]
// int32, uvx [S, 4], filt [S, 2] and eps [S, 2] float32, tap_safe [S]
// int32) is contiguous; tex_id (int32, tid_n entries, stride tid_s) is
// read at i % tid_n, uv and the differentials (M rows each, through their
// strides; d0 = d1 = the footprint in FOOT mode, null in BASE and BUMP)
// at lane i % M; mode is BASE, FOOT, DUV or BUMP (N = 3M). Returns
// cudaGetLastError() as an int (0 = launched), or cudaErrorInvalidValue
// for an argument out of range.
extern "C" int ppg_atlas_sample(
    const void* pixels, const int32_t* meta, const int32_t* mip_meta,
    const float* uvx, const float* filt, int n_slots, const float* eps,
    const int32_t* tap_safe, const int32_t* tex_id, long long tid_n,
    long long tid_s, const float* uv, long long uv_s0, long long uv_s1,
    const float* d0, const float* d1, long long d_s0, long long d_s1,
    long long M, int mode, float w_outer, float w_inner, float inv_wsum,
    float* out, long long N, int device, void* stream) {
    if (N <= 0) return 0;
    if (M <= 0 || tid_n <= 0 || n_slots <= 0 || mode < BASE ||
        mode > BUMP || N > 0x7fffffffLL - BLOCK ||
        ((mode == FOOT || mode == DUV) && (d0 == nullptr || d1 == nullptr)))
        return cudaErrorInvalidValue;
    const Args a{static_cast<const uint2*>(pixels), meta, mip_meta, uvx,
                 filt, n_slots, eps, tap_safe, tex_id, tid_n, tid_s, uv,
                 uv_s0, uv_s1, d0, d1, d_s0, d_s1, M, mode, w_outer,
                 w_inner, inv_wsum, out, static_cast<int>(N)};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    // a persistent grid: as many blocks as the card holds at once, found
    // once per device index; a failed query is returned and not kept
    static int resident[64];
    const bool keep = device >= 0 && device < 64;
    int cap = keep ? resident[device] : 0;
    int err = 0;
    if (cap == 0) {
        int per_sm = 0, sms = 0;
        err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, atlas_kernel, BLOCK, 0));
        if (!err)
            err = static_cast<int>(cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, device));
        if (!err && per_sm * sms <= 0)
            err = static_cast<int>(cudaErrorInvalidValue);
        if (!err) {
            cap = per_sm * sms;
            if (keep) resident[device] = cap;
        }
    }
    if (!err) {
        const int tiles = static_cast<int>((N + BLOCK - 1) / BLOCK);
        const int grid = tiles < cap ? tiles : cap;
        atlas_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
    }
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
