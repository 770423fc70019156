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
// The design. Few lanes are gated in (chip_smoke phase 17's last NEE call:
// 25,858 of 262,144; its last escaped lanes 7,288), and each sample was a
// chain of about 25 dependent CDF loads. So:
//   - A persistent grid (as many blocks as the card holds at once) whose
//     blocks take tiles of BLOCK lanes in turn. A thread reads its lane's
//     gate (the key and masks together) and nothing else: the tile's
//     gated-out lanes get their zeros as coalesced stores over the tile's
//     rows of d and value, and the gated-in lanes join the block's queue
//     in shared memory in tile order (16-lane ballots, as K9). A full
//     queue is computed by every thread at once, what is left at the end
//     in one pass; a queued lane's inputs are read where it is computed.
//   - The row search reads shared memory. A block that holds a gated-in
//     sample lane stages row_cdf there once, while its first lanes' inputs
//     load: whole where H + 1 <= ROW_CAP floats, else the midpoints of the
//     search's first HEAP_LEVELS levels in heap order and its two ends,
//     after which the search goes on as the column search does.
//   - The column search takes KARY rounds a step: the 2^KARY - 1 entries
//     that those rounds can compare, known from lo and hi, are loaded
//     together (no entry of an interval that no longer splits), then the
//     rounds are resolved in registers. The midpoints and comparisons are
//     exactly the binary search's, so the index is the same on any table,
//     a NaN entry included (an inf texel leaves NaN in the CDFs); nothing
//     assumes that a CDF ascends. The search keeps cdf[lo] and cdf[hi],
//     which are the remainder's c0 and c1 at its end (hi = lo + 1, and lo
//     <= size - 1, so _sample_cdf's clamp of the index never binds).
//   - The four texels and two row weights of a bilinear lookup are loaded
//     together once its texel coordinates are known.
//
// Held against others on chip_smoke phase 17's last NEE call and last
// escaped lanes (k1_compare.py --kernel k10, each in turns with the first
// design in one run; NVIDIA H100 80GB HBM3, 700.00 W; ms alone over
// K10_SETS copies of the lanes, the tables shared above the L2; sample,
// lookup): the first design (one thread a lane over every lane, one
// dependent load a round) 0.0139, 0.0067; this one 0.0114, 0.0049, at 40
// registers, no spill (the 32-byte frame is sinf's and cosf's slow path,
// as in the first design), six blocks an SM. Three rounds a step beat
// four (0.0125, 60 registers), which loads 15 entries to read four, and
// two (0.0116-0.0117), a chain of six steps. The next tile's gate read
// before the current tile's queue is computed: 0.0118-0.0119; the
// direction read with the gate (12 B more a lane): lookup 0.0055-0.0056.
// In a first sweep, at four rounds a step with the step's entries in
// local memory (picked by index): 0.0141 with the row CDF staged whole,
// 0.0140 with only its first seven levels staged, 0.0152-0.0153 with the
// row search through the same steps from the L2, and 0.0294 at eight
// blocks an SM (32 registers, 202 B spilled).
//
// On the render's largest NEE call (66,004 lanes gated in) this design
// is no faster than the first (0.0163-0.0166 against 0.0165-0.0169): the
// steps' unread entries cost bandwidth there, and one round a step takes
// 0.0149-0.0151; one round in passes of 96 lanes or more and three below
// took 0.0113 and 0.0150, but the sky box's K10 time a wavefront did not
// tell one round (0.2093-0.2136 ms) from three (0.2080-0.2093).
//
// What bounds it on an H100 (chip_smoke.env_bound_ms): bytes. Each lane
// reads its gate's key and masks and writes its outputs; a gated-in lane
// reads its inputs, and the call reads each distinct CDF entry (4 B) and
// each distinct texel (12 B) its lanes need once: 0.00338 ms and 0.00175
// ms on those calls. What keeps a sample from it: the grid's floor (the
// launch, the gates and the zero rows alone take 0.0050 ms on the last
// NEE call) and a lane's chain of round trips to memory (its inputs, the
// staged row CDF, four column steps, the texels), 0.0063 ms more.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // a block's threads, a tile's lanes
constexpr int GROUP = 16;   // the lanes of one ballot
constexpr int GROUPS = BLOCK / GROUP;
static_assert(GROUPS == GROUP, "a group scans the tile's group counts");
constexpr int SAMPLE = 0, LOOKUP = 1;
// the rounds of a search resolved from one batch of loads
constexpr int KARY = 3;
constexpr int NODES = (1 << KARY) - 1;
// the row CDF in shared memory: whole where H + 1 <= ROW_CAP floats, else
// the first HEAP_LEVELS levels of its search (every node of them splits:
// H >= ROW_CAP) and cdf[0], cdf[H]
constexpr int ROW_CAP = 4096;
constexpr int HEAP_LEVELS = 11;
constexpr int HEAP = (1 << HEAP_LEVELS) - 1;
static_assert(HEAP + 2 <= ROW_CAP && ROW_CAP >> (HEAP_LEVELS - 1) >= 2,
              "the heap fits and its nodes split");

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

// the floats of the sample mode's dynamic shared memory
inline int row_floats(int H) {
    return H + 1 <= ROW_CAP ? H + 1 : HEAP + 2;
}

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

__device__ __forceinline__ int wrap(int x, int W) {
    const int r = x % W;
    return r < 0 ? r + W : r;
}

__device__ __forceinline__ int clamp_row(int y, int H) {
    return y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
}

// The bilinear lookup at texel coordinates (x, y): v1 = row y0's value
// times 1 - dy, v2 = row y0 + 1's times dy (each row texel(x0) (1 - dx) +
// texel(x0 + 1) dx, x wrapped by a floor modulo, the row clamped to
// [0, H-1]); returns lum(v1) rowWeight(y0) + lum(v2) rowWeight(y0 + 1).
// The four texels and two row weights are loaded together.
__device__ __forceinline__ float bilinear(const Args& a, float x, float y,
                                          float* v1, float* v2) {
    const int x0 = floor_i32(x), y0 = floor_i32(y);
    const float dx1 = x - static_cast<float>(x0);
    const float dy1 = y - static_cast<float>(y0);
    const int xa = wrap(x0, a.W), xb = wrap(add_i32(x0, 1), a.W);
    const int r0 = clamp_row(y0, a.H), r1 = clamp_row(add_i32(y0, 1), a.H);
    const float* p0 = a.img + 3 * (static_cast<long long>(r0) * a.W);
    const float* p1 = a.img + 3 * (static_cast<long long>(r1) * a.W);
    float t[4][3];
    for (int c = 0; c < 3; ++c) {
        t[0][c] = __ldg(p0 + 3 * xa + c);
        t[1][c] = __ldg(p0 + 3 * xb + c);
        t[2][c] = __ldg(p1 + 3 * xa + c);
        t[3][c] = __ldg(p1 + 3 * xb + c);
    }
    const float rw0 = __ldg(a.row_w + r0), rw1 = __ldg(a.row_w + r1);
    const float w0 = 1.0f - dx1, wy = 1.0f - dy1;
    for (int c = 0; c < 3; ++c) {
        v1[c] = (t[0][c] * w0 + t[1][c] * dx1) * wy;
        v2[c] = (t[2][c] * w0 + t[3][c] * dx1) * dy1;
    }
    return lum(v1) * rw0 + lum(v2) * rw1;
}

// The binary search's rounds on cdf[base : ...] from (lo, hi) until hi -
// lo <= 1, KARY rounds a step: the entries those rounds can compare (the
// midpoints of the step's tree of intervals, in heap order, where an
// interval still splits) are loaded together; then each round compares
// the root of what is left and keeps the subtree on its side, moved up a
// level by selects at fixed places (so the entries stay in registers).
// clo and chi hold cdf[base + lo] and cdf[base + hi] and follow lo and hi.
__device__ __forceinline__ void search(const float* cdf, long long base,
                                       float u, int& lo, int& hi,
                                       float& clo, float& chi) {
    while (hi - lo > 1) {
        int l[NODES], h[NODES];
        float v[NODES];
        l[0] = lo;
        h[0] = hi;
#pragma unroll
        for (int k = 0; k < NODES; ++k) {
            const int m = (l[k] + h[k]) >> 1;
            v[k] = 0.0f;
            if (h[k] - l[k] > 1) v[k] = __ldg(cdf + base + m);
            if (2 * k + 2 < NODES) {
                l[2 * k + 1] = l[k];
                h[2 * k + 1] = m;
                l[2 * k + 2] = m;
                h[2 * k + 2] = h[k];
            }
        }
#pragma unroll
        for (int r = 0; r < KARY; ++r) {
            if (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                const float c = v[0];
                const bool go = u >= c;
                lo = go ? mid : lo;
                clo = go ? c : clo;
                hi = go ? hi : mid;
                chi = go ? chi : c;
                // level e + 1 of the side taken becomes level e
#pragma unroll
                for (int e = 0; e < KARY - 1 - r; ++e)
#pragma unroll
                    for (int j = 0; j < (1 << e); ++j)
                        v[(1 << e) - 1 + j] =
                            go ? v[(2 << e) - 1 + (1 << e) + j]
                               : v[(2 << e) - 1 + j];
            }
        }
    }
}

// the rescaled remainder of an inversion at u between c0 and c1
__device__ __forceinline__ float remainder_at(float u, float c0, float c1) {
    return clip((u - c0) / at_least(c1 - c0, TINY_STEP), 0.0f, 1.0f);
}

// row_cdf into shared memory: whole, or the heap of the search's first
// levels and its two ends (see row_floats)
__device__ __forceinline__ void stage_rows(const Args& a, float* s) {
    const int t = threadIdx.x;
    if (a.H + 1 <= ROW_CAP) {
        for (int k = t; k <= a.H; k += BLOCK) s[k] = __ldg(a.row_cdf + k);
        return;
    }
    for (int k = t; k < HEAP; k += BLOCK) {
        // node k's interval: the path from the root in the bits of k + 1
        // below its leading one (1 goes up)
        int lo = 0, hi = a.H;
        for (int b = 30 - __clz(k + 1); b >= 0; --b) {
            const int mid = (lo + hi) >> 1;
            if (((k + 1) >> b) & 1) lo = mid;
            else hi = mid;
        }
        s[k] = __ldg(a.row_cdf + ((lo + hi) >> 1));
    }
    if (t == 0) {
        s[HEAP] = __ldg(a.row_cdf);
        s[HEAP + 1] = __ldg(a.row_cdf + a.H);
    }
}

// the row search on the staged row CDF: the index, and the rescaled
// remainder in *rem
__device__ __forceinline__ int row_search(const Args& a, const float* s,
                                          float u, float* rem) {
    int lo = 0, hi = a.H;
    if (a.H + 1 <= ROW_CAP) {
        while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (u >= s[mid]) lo = mid;
            else hi = mid;
        }
        *rem = remainder_at(u, s[lo], s[lo + 1]);
        return lo;
    }
    float clo = s[HEAP], chi = s[HEAP + 1];
    int k = 0;
    for (int r = 0; r < HEAP_LEVELS; ++r) {
        const int mid = (lo + hi) >> 1;
        const float c = s[k];
        const bool go = u >= c;
        lo = go ? mid : lo;
        clo = go ? c : clo;
        hi = go ? hi : mid;
        chi = go ? chi : c;
        k = 2 * k + 1 + (go ? 1 : 0);
    }
    search(a.row_cdf, 0, u, lo, hi, clo, chi);
    *rem = remainder_at(u, clo, chi);
    return lo;
}

// warp::intervalToTent
__device__ __forceinline__ float interval_to_tent(float x) {
    const bool neg = x < 0.5f;
    const float x2 = neg ? 1.0f - 2.0f * x : 2.0f * x - 1.0f;
    const float t = 1.0f - sqrtf(clip(1.0f - x2, 0.0f, 1.0f));
    return neg ? -t : t;
}

// the gate's key and masks, loaded together
__device__ __forceinline__ bool gated_in(const Args& a, int i) {
    const bool k = a.key == nullptr || __ldg(a.key + i * a.key_s) ==
                                           a.key_val;
    const bool m1 = a.m1 == nullptr || __ldg(a.m1 + i * a.m1_s) != 0;
    const bool m2 = a.m2 == nullptr || __ldg(a.m2 + i * a.m2_s) != 0;
    return k & m1 & m2;
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
    const float rp = bilinear(a, u * static_cast<float>(a.W) - 0.5f,
                              v * static_cast<float>(a.H) - 0.5f, v1, v2);
    const float st = sqrtf(clip(1.0f - dl1 * dl1, 0.0f, 1.0f));
    const float pdf = rp * c[0] / at_least(st, EPS);
    const long long o = i;
    a.pdf[o] = pdf * a.inv_n;
    for (int k = 0; k < 3; ++k) a.value[3 * o + k] = v1[k] + v2[k];
}

// a sample lane's inputs: the uniforms and the point
struct SampleIn {
    float ux, uy, p0, p1, p2;
};

__device__ __forceinline__ SampleIn sample_in(const Args& a, int i) {
    const float* p = a.x + i * a.x_s0;
    return SampleIn{a.ux[i * a.ux_s], a.uy[i * a.uy_s], p[0], p[a.x_s1],
                    p[2 * a.x_s1]};
}

__device__ __forceinline__ void sample(const Args& a, int i,
                                       const SampleIn& in, const float* s) {
    const float* c = a.consts;
    float ry, rx;
    const int row = row_search(a, s, in.uy, &ry);
    const long long base = static_cast<long long>(row) * (a.W + 1);
    int lo = 0, hi = a.W;
    float clo = __ldg(a.col_cdf + base), chi = __ldg(a.col_cdf + base + a.W);
    search(a.col_cdf, base, in.ux, lo, hi, clo, chi);
    rx = remainder_at(in.ux, clo, chi);
    const int col = lo;
    const float px = static_cast<float>(col) + interval_to_tent(rx);
    const float py = static_cast<float>(row) + interval_to_tent(ry);
    float v1[3], v2[3];
    float pdf = bilinear(a, px, py, v1, v2) * c[0];
    float value[3];
    for (int k = 0; k < 3; ++k) value[k] = v1[k] + v2[k];
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
    const float oc0 = in.p0 - c[19], oc1 = in.p1 - c[20],
                oc2 = in.p2 - c[21];
    const float b = oc0 * d0 + oc1 * d1 + oc2 * d2;
    const float cc = (oc0 * oc0 + oc1 * oc1 + oc2 * oc2) - c[22];
    const float disc = b * b - cc;
    const float sq = sqrtf(disc < 0.0f ? 0.0f : disc);
    const float near = -b - sq, far = -b + sq;
    const bool ok = disc > 0.0f && near < 0.0f && far > 0.0f && pdf > 0.0f;
    pdf = ok ? pdf : 0.0f;
    const float den = at_least(pdf, TINY_PDF);
    const long long o = i;
    a.d[3 * o] = d0;
    a.d[3 * o + 1] = d1;
    a.d[3 * o + 2] = d2;
    a.dist[o] = far;
    a.pdf[o] = pdf * a.inv_n;
    for (int k = 0; k < 3; ++k)
        a.value[3 * o + k] = (ok ? value[k] / den : 0.0f) * a.n;
}

// Zeros into the [L,3] rows of the tile at lane i0 whose lanes are gated
// out (bit clear in `in`, by group): the tile's 3 * BLOCK floats, three a
// thread, neighbouring threads on neighbouring floats.
__device__ __forceinline__ void zero_rows(float* out, long long i0, int L,
                                          const unsigned* in) {
    for (int r = 0; r < 3; ++r) {
        const int k = r * BLOCK + static_cast<int>(threadIdx.x);
        const int l = k / 3;
        if (i0 + l < L && !((in[l / GROUP] >> (l % GROUP)) & 1u))
            out[3 * i0 + k] = 0.0f;
    }
}

// A pass over queued lanes: lane j (or none, j < 0) of each thread. In
// sample mode a block stages the row CDF before its first pass, while
// the pass's inputs load; every thread of the block takes part.
template <int MODE>
__device__ __forceinline__ void compute(const Args& a, int j, float* s_row,
                                        bool& staged) {
    if (MODE == SAMPLE) {
        SampleIn in{};
        if (j >= 0) in = sample_in(a, j);
        if (!staged) {
            stage_rows(a, s_row);
            __syncthreads();
            staged = true;
        }
        if (j >= 0) sample(a, j, in, s_row);
    } else if (j >= 0) {
        lookup(a, j);
    }
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK) env_kernel(const Args a) {
    extern __shared__ float s_row[];  // sample mode: row_floats(H)
    // the queue holds under BLOCK lanes between tiles, and a tile adds at
    // most BLOCK
    __shared__ int s_queue[2 * BLOCK];
    __shared__ unsigned s_in[GROUPS];  // a tile's gated-in lanes, by group
    __shared__ int s_at[GROUPS + 1];   // their offsets and total
    const int t = threadIdx.x, lane = t % GROUP, grp = t / GROUP;
    const unsigned gmask = 0xffffu << (t & GROUP);
    const int tiles = (a.L + BLOCK - 1) / BLOCK;
    int queued = 0;  // the same in every thread
    bool staged = false;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int i0 = tile * BLOCK, i = i0 + t;
        const bool in = i < a.L && gated_in(a, i);
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
        if (in) {
            s_queue[queued + s_at[grp] +
                    __popc(bits & ((1u << lane) - 1u))] = i;
        } else if (i < a.L) {
            a.pdf[i] = 0.0f;
            if (MODE == SAMPLE) a.dist[i] = 0.0f;
        }
        zero_rows(a.value, i0, a.L, s_in);
        if (MODE == SAMPLE) zero_rows(a.d, i0, a.L, s_in);
        queued += s_at[GROUPS];
        __syncthreads();
        // a full queue: every thread computes one of its lanes
        if (queued >= BLOCK) {
            compute<MODE>(a, s_queue[t], s_row, staged);
            const int rest = queued - BLOCK;
            const int keep = t < rest ? s_queue[BLOCK + t] : 0;
            __syncthreads();
            if (t < rest) s_queue[t] = keep;
            __syncthreads();
            queued = rest;
        }
    }
    // the block's remainder
    if (queued > 0) compute<MODE>(a, t < queued ? s_queue[t] : -1, s_row,
                                  staged);
}

// The blocks of a persistent grid in `mode` on card `device`: as many as
// the card holds at once, found once per mode and device index; a failed
// query is returned and not kept.
int resident_blocks(int mode, int device, int* cap) {
    static int resident[2][64];
    const bool keep = device >= 0 && device < 64;
    *cap = keep ? resident[mode][device] : 0;
    if (*cap > 0) return 0;
    int per_sm = 0, sms = 0;
    int err = static_cast<int>(
        mode == SAMPLE
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, env_kernel<SAMPLE>, BLOCK,
                  sizeof(float) * ROW_CAP)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, env_kernel<LOOKUP>, BLOCK, 0));
    if (!err)
        err = static_cast<int>(cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, device));
    if (!err && per_sm * sms <= 0)
        err = static_cast<int>(cudaErrorInvalidValue);
    if (err) return err;
    *cap = per_sm * sms;
    if (keep) resident[mode][device] = *cap;
    return 0;
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
// cudaGetLastError() as an int (0 = launched), the occupancy query's
// error, or cudaErrorInvalidValue for L of 2^31 or more or a map of no
// texel.
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
    if (L > 0x7fffffffLL - BLOCK || (mode != SAMPLE && mode != LOOKUP) ||
        H < 1 || W < 1)
        return cudaErrorInvalidValue;
    const Args a{img,   row_cdf, col_cdf, row_w, consts, H,     W,
                 phi_scale, theta_scale, n, inv_n, x,   x_s0,  x_s1,
                 ux,    ux_s,    uy,      uy_s,  key,    key_s, key_val,
                 m1,    m1_s,    m2,      m2_s,  d,      dist,  pdf,
                 value, static_cast<int>(L)};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    int cap = 0;
    int err = resident_blocks(mode, device, &cap);
    if (!err) {
        const int tiles = static_cast<int>((L + BLOCK - 1) / BLOCK);
        const int grid = tiles < cap ? tiles : cap;
        const size_t shared =
            mode == SAMPLE ? sizeof(float) * row_floats(H) : 0;
        if (mode == SAMPLE)
            env_kernel<SAMPLE><<<grid, BLOCK, shared, static_cast<cudaStream_t>(stream)>>>(a);
        else
            env_kernel<LOOKUP><<<grid, BLOCK, shared, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
    }
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
