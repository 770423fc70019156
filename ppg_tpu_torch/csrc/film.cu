// K7: the box filter's film splat of one contiguous pixel chunk.
//
// It replaces ppg_tpu/render/film.py::Film.splat_box_linear (:122), an
// XLA dynamic-slice add (no Pallas original), which the guided tracer
// calls twice a chunk (the values and their squares) and the unguided
// render once. The semantics are those of the plain version,
// ppg_tpu_torch/render/film.py::splat_box_linear_plain: for the C pixels
// from linear offset `start`, rgb += (valid ? value : 0) and w += (valid ?
// 1 : 0), and, where the second buffers are given, rgb2 += (valid ?
// value * value : 0) and w2 the same as w. Each pixel is one thread's, so
// no two threads add into one place, and each sum is one float add (the
// square rounded once before it, built with --fmad=false): the kernel
// equals the plain version bit for bit.
//
// What bounds it on an H100 (3.35 TB/s): bytes. A pixel's 12 B of value
// and its 1 B flag are read and its 16 B of film read and written, twice
// that with the squared film: some 3.5 us for a 262,144-pixel chunk. One
// thread per float of the chunk's [C,3] values, so a warp's loads and
// stores are 128 contiguous bytes; the first C threads also add the
// weights. One launch does what the plain version does in about nine.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

struct Args {
    float* rgb;   // [P,3]
    float* w;     // [P]
    float* rgb2;  // [P,3] or null
    float* w2;    // [P] or null
    const float* values;   // [C,3]
    const uint8_t* valid;  // [C]
    long long start;
    long long C;
};

__global__ void __launch_bounds__(BLOCK) film_splat_kernel(const Args a) {
    const long long k =
        static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
    if (k >= 3 * a.C) return;
    const bool ok = a.valid[k / 3] != 0;
    const float v = a.values[k];
    const long long o = 3 * a.start + k;
    a.rgb[o] = __fadd_rn(a.rgb[o], ok ? v : 0.0f);
    if (a.rgb2) a.rgb2[o] = __fadd_rn(a.rgb2[o], ok ? __fmul_rn(v, v) : 0.0f);
    if (k < a.C) {
        const float wk = a.valid[k] ? 1.0f : 0.0f;
        a.w[a.start + k] = __fadd_rn(a.w[a.start + k], wk);
        if (a.w2) a.w2[a.start + k] = __fadd_rn(a.w2[a.start + k], wk);
    }
}

}  // namespace

// K7 on `stream` of card `device`; rgb2 and w2 may both be null. Returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int ppg_film_splat(float* rgb, float* w, float* rgb2, float* w2,
                              long long start, const float* values,
                              const uint8_t* valid, long long C, int device,
                              void* stream) {
    if (C <= 0) return 0;
    const Args a{rgb, w, rgb2, w2, values, valid, start, C};
    const int grid = static_cast<int>((3 * C + BLOCK - 1) / BLOCK);
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    film_splat_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}

// K7s: the reconstruction filter's film splat of one pixel chunk, as a
// gather.
//
// It replaces ppg_tpu/render/film.py::Film.splat (:77-108), an XLA
// scatter (no Pallas original), for every filter but the box: tent
// (radius 1), gaussian, mitchell and catmullrom (radius 2) and lanczos
// (radius 3). ppg_tpu adds each sample into the n x n pixels (n =
// ceil(2r)) from bx = ceil(x - 0.5 - r), by = ceil(y - 0.5 - r), with the
// weight filter(px + 0.5 - x) * filter(py + 0.5 - y), 0 off the film.
// On the main path the chunk's lane i is pixel start + i, jittered inside
// it, so a sample lies in [qx, qx + 1] x [qy, qy + 1] of its own pixel q
// and its window lies in q's (2K+1)^2 neighbourhood, K = ceil(r). The
// kernel turns the scatter around: each film pixel p in the rows the
// chunk reaches, [row(start) - K, row(last) + K] clipped to the film,
// visits its neighbours q = p + (dx, dy), dy then dx from -K to K, and
// for each q inside the film and among the chunk's lanes (start .. last,
// last < W * H) whose window holds p adds value * w and w (and, into the
// squared film, (value * value) * w, the square rounded once, and w);
// every other neighbour adds +0. Each pixel sums its terms in that order
// from +0 and then does one read-modify-write of its film values, so no
// two threads write one place, no atomic is needed and a seed's render
// repeats bit for bit. The plain version,
// ppg_tpu_torch/render/film.py::splat_filter_plain, does the same adds in
// the same order (one shifted, masked add per neighbour), so with
// --fmad=false and the CUDA math library's expf and sinf on both sides
// the kernel equals it bit for bit. The filter's float32 constants come
// from the wrapper (render/film.py::filter_constants), rounded as
// ppg_tpu's float32 arithmetic rounds them.
//
// The design. A block owns a tile of TILE_W x TILE_H pixels of the rows
// reached (a warp a row of it; the grid is 1-D over the tiles) and first
// stages the samples of the tile's (TILE_W + 2K) x (TILE_H + 2K)
// neighbourhood in dynamic shared memory, one slot a sample, loaded
// coalesced. The filters are separable, so a sample's weights are its n
// x-weights filter(bx + i + 0.5 - x) and n y-weights, 2n evaluations
// where a pixel that evaluated its neighbours' weights itself took two a
// window term. Every radius is a whole number, so for a sample inside
// its pixel bx = qx - K + ex with ex 0 or 1 (x - 0.5 - r lies in
// [qx - r - 0.5, qx - r + 0.5], exact below 2^22), and the same for by:
// the slot keeps the weight of each of the 2K + 1 pixel columns and rows
// around q (the column outside the window unused), one bit for each of
// them that the window holds, and the value. A slot off the film or
// outside the chunk holds no bits. The filter kind is a template
// parameter, so K and n are constants, the loops unroll, and a
// neighbour's weights sit at a compile-time offset of its slot: the
// gather is loads, one test of two bits, selects and the sums. An
// out-of-window neighbour's value and weight are both selected to +0, so
// its terms are +0 * +0 = +0 and a sum begun at +0 (never -0) is
// unchanged, as in the plain version; a value is never multiplied by a
// zero weight where the plain version does not (inf * 0 is NaN).
//
// Precondition: the thread that stages a sample of the chunk checks that
// it lies inside its own pixel (NaN fails), and traps if not: its window
// would reach pixels the gather does not visit. Every lane of the chunk
// lies in some tile's neighbourhood, so each is checked. As K5 traps on
// an index outside its cells, a wrong input fails the launch and is
// never summed wrongly. Films of 2^22 pixels a side or more are refused.
//
// What bounds it on an H100 (3.35 TB/s): bytes. A sample's 8 B position
// and 12 B value are read once, and each pixel of the rows reached has
// its 16 B of film read and written, twice that with the squared film:
// about 6.6 us for a 512 x 512 chunk. The FP32 work, 2n filter
// evaluations a sample and up to 17 operations a window term (n^2 terms a
// sample), stays below that. What the tile costs beyond it: the samples
// of a tile's border are staged again by the neighbouring tiles (1.41
// times the chunk's samples for the gaussian at 32 x 16, 1.63 for
// lanczos) and each pixel reads (2K + 1)^2 slots of shared memory, a
// float4 and three words a slot, about as many cycles of shared-memory
// bandwidth as the gather's instructions take to issue. The taller tile
// cuts the border: on an H100, 32 x 8 tiles of 256 threads measured
// slower, and so did two pixels a thread sharing a slot's loads.

namespace {

constexpr int TILE_W = 32, FILTER_BLOCK = 512,
              TILE_H = FILTER_BLOCK / TILE_W;
enum { TENT = 1, GAUSSIAN = 2, MITCHELL = 3, LANCZOS = 4 };
constexpr int N_CONSTS = 10;
constexpr int MAX_SIDE = 1 << 22;  // the films the design is exact for

struct FilterArgs {
    float* rgb;   // [H,W,3]
    float* w;     // [H,W]
    float* rgb2;  // [H,W,3] or null
    float* w2;    // [H,W] or null
    const float* pos;     // [C,2] film positions of the chunk's lanes
    const float* values;  // [C,3]
    long long start;      // pixel of lane 0
    long long last;       // pixel of the last lane on the film
    int W, H, y0, rows;   // the rows reached: y0 .. y0 + rows - 1
    int tiles_x;          // tiles across the film
    float c[N_CONSTS];    // render/film.py::filter_constants
};

// A filter kind's constants: K = r and n = 2r. A tile stages HX x HY
// slots; each field is an array of SLOTS words (a multiple of 32, so that
// a warp's reads of one field at 32 neighbouring slots fall in 32 banks):
// the window bits (bit j: pixel column qx - K + j, bit 16 + j: row qy - K
// + j), the D x-weights, the D y-weights, and the value as a float4.
template <int KIND>
struct Tile {
    static constexpr int K = KIND == TENT ? 1 : KIND == LANCZOS ? 3 : 2;
    static constexpr int N = 2 * K, D = 2 * K + 1;
    static constexpr float R = static_cast<float>(K);
    static constexpr int HX = TILE_W + 2 * K, HY = TILE_H + 2 * K;
    static constexpr int SLOTS = (HX * HY + 31) / 32 * 32;
    static constexpr int WX = SLOTS, WY = WX + D * SLOTS,
                         VAL = WY + D * SLOTS;
    static constexpr int BYTES = (VAL + 4 * SLOTS) * 4;
};

// ppg_tpu/render/film.py::filter_eval for one offset; every product and
// sum rounded on its own (--fmad=false), the selects as in the plain
// version
template <int KIND>
__device__ __forceinline__ float filter_eval(const FilterArgs& a, float x) {
    const float ax = fabsf(x);
    if constexpr (KIND == TENT) {
        const float v = 1.0f - ax;
        return v < 0.0f ? 0.0f : v;
    } else if constexpr (KIND == GAUSSIAN) {
        // c[0] = alpha, c[1] = exp(alpha r^2)
        const float v = expf(a.c[0] * ax * ax) - a.c[1];
        return v < 0.0f ? 0.0f : v;
    } else if constexpr (KIND == MITCHELL) {
        // c[0..3]: the outer cubic from x^3 down, c[4..6]: the inner
        // cubic's x^3, x^2 and 1, c[7] = 1/6; x = |2 (ax / 2)| = ax
        const float x = ax, x2 = x * x, x3 = x * x * x;
        const float outer =
            (a.c[0] * x3 + a.c[1] * x2 + a.c[2] * x + a.c[3]) * a.c[7];
        const float inner = (a.c[4] * x3 + a.c[5] * x2 + a.c[6]) * a.c[7];
        const float m = x > 1.0f ? outer : inner;
        return ax <= 2.0f ? m : 0.0f;
    } else {
        // lanczos: c[0] = pi, c[1] = 1/3, c[2] = 1e-6, c[3] = 3;
        // sinc(x) = sin(pi x) / (pi x)
        const float px = a.c[0] * ax;
        const float t = ax * a.c[1];
        const float pt = a.c[0] * t;
        const float s = (sinf(px) / px) * (sinf(pt) / pt);
        const float v = ax < a.c[2] ? 1.0f : s;
        return ax <= a.c[3] ? v : 0.0f;
    }
}

// The n weights of a sample's window from b along one axis, stored at
// the D columns (or rows) around its pixel, the window e (0 or 1) of them
// in: slot field f, column j of D holds weight j - e.
template <int KIND>
__device__ __forceinline__ void stage_weights(const FilterArgs& a,
                                              float* f, int b, int e,
                                              float x) {
    using T = Tile<KIND>;
    float wt[T::N];
#pragma unroll
    for (int i = 0; i < T::N; ++i)
        wt[i] = filter_eval<KIND>(a, static_cast<float>(b + i) + 0.5f - x);
#pragma unroll
    for (int j = 0; j < T::D; ++j)
        f[j * T::SLOTS] = e ? (j > 0 ? wt[j - 1] : 0.0f)
                            : (j < T::N ? wt[j] : 0.0f);
}

template <int KIND>
__global__ void __launch_bounds__(FILTER_BLOCK)
splat_filter_kernel(const FilterArgs a) {
    using T = Tile<KIND>;
    constexpr int K = T::K, N = T::N;
    extern __shared__ float tile[];
    unsigned* bits = reinterpret_cast<unsigned*>(tile);
    float4* val = reinterpret_cast<float4*>(tile + T::VAL);
    const int tx0 = static_cast<int>(blockIdx.x % a.tiles_x) * TILE_W;
    const int ty0 =
        a.y0 + static_cast<int>(blockIdx.x / a.tiles_x) * TILE_H;

    // stage the neighbourhood's samples, a slot each
    for (int h = threadIdx.x; h < T::HX * T::HY; h += FILTER_BLOCK) {
        const int qx = tx0 - K + h % T::HX, qy = ty0 - K + h / T::HX;
        const long long qid = static_cast<long long>(qy) * a.W + qx;
        unsigned m = 0;
        if (qx >= 0 && qx < a.W && qy >= 0 && qy < a.H && qid >= a.start &&
            qid <= a.last) {
            const long long s = qid - a.start;
            const float x = __ldg(a.pos + 2 * s);
            const float y = __ldg(a.pos + 2 * s + 1);
            const float fx = static_cast<float>(qx);
            const float fy = static_cast<float>(qy);
            if (!(x >= fx && x <= fx + 1.0f && y >= fy && y <= fy + 1.0f))
                __trap();
            const int bx = static_cast<int>(ceilf(x - 0.5f - T::R));
            const int by = static_cast<int>(ceilf(y - 0.5f - T::R));
            const int ex = bx - (qx - K), ey = by - (qy - K);
            m = ((1u << N) - 1) << ex | ((1u << N) - 1) << (16 + ey);
            stage_weights<KIND>(a, tile + T::WX + h, bx, ex, x);
            stage_weights<KIND>(a, tile + T::WY + h, by, ey, y);
            const float* v = a.values + 3 * s;
            val[h] = float4{__ldg(v), __ldg(v + 1), __ldg(v + 2), 0.0f};
        }
        bits[h] = m;
    }
    __syncthreads();

    const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
    const bool squares = a.rgb2 != nullptr;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, sw = 0.0f;
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
#pragma unroll
    for (int dy = -K; dy <= K; ++dy) {
#pragma unroll
        for (int dx = -K; dx <= K; ++dx) {
            // the neighbour's slot; this pixel is its column K - dx and
            // row K - dy
            const int h = (ty + K + dy) * T::HX + tx + K + dx;
            const unsigned need = (1u << (K - dx)) | (1u << (16 + K - dy));
            const bool ok = (bits[h] & need) == need;
            const float w = __fmul_rn(tile[T::WX + (K - dx) * T::SLOTS + h],
                                      tile[T::WY + (K - dy) * T::SLOTS + h]);
            const float4 v = val[h];
            const float wk = ok ? w : 0.0f;
            const float v0 = ok ? v.x : 0.0f, v1 = ok ? v.y : 0.0f,
                        v2 = ok ? v.z : 0.0f;
            s0 = __fadd_rn(s0, __fmul_rn(v0, wk));
            s1 = __fadd_rn(s1, __fmul_rn(v1, wk));
            s2 = __fadd_rn(s2, __fmul_rn(v2, wk));
            sw = __fadd_rn(sw, wk);
            if (squares) {
                q0 = __fadd_rn(q0, __fmul_rn(__fmul_rn(v0, v0), wk));
                q1 = __fadd_rn(q1, __fmul_rn(__fmul_rn(v1, v1), wk));
                q2 = __fadd_rn(q2, __fmul_rn(__fmul_rn(v2, v2), wk));
            }
        }
    }
    const int px = tx0 + tx, py = ty0 + ty;
    if (px >= a.W || py >= a.y0 + a.rows) return;
    const long long pid = static_cast<long long>(py) * a.W + px;
    a.rgb[3 * pid] = __fadd_rn(a.rgb[3 * pid], s0);
    a.rgb[3 * pid + 1] = __fadd_rn(a.rgb[3 * pid + 1], s1);
    a.rgb[3 * pid + 2] = __fadd_rn(a.rgb[3 * pid + 2], s2);
    a.w[pid] = __fadd_rn(a.w[pid], sw);
    if (squares) {
        a.rgb2[3 * pid] = __fadd_rn(a.rgb2[3 * pid], q0);
        a.rgb2[3 * pid + 1] = __fadd_rn(a.rgb2[3 * pid + 1], q1);
        a.rgb2[3 * pid + 2] = __fadd_rn(a.rgb2[3 * pid + 2], q2);
        a.w2[pid] = __fadd_rn(a.w2[pid], sw);
    }
}

// The one launch line of K7s, for every filter kind; a tile above the
// 48 KB a block gets by default (lanczos) opts in.
template <int KIND>
int launch_filter(const FilterArgs& a, int grid, void* stream) {
    const int bytes = Tile<KIND>::BYTES;
    if (bytes > 48 * 1024)
        cudaFuncSetAttribute(splat_filter_kernel<KIND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    splat_filter_kernel<KIND><<<grid, FILTER_BLOCK, bytes, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7s on `stream` of card `device`: the chunk of C lanes from pixel
// `start` (its positions pos [C,2] and values [C,3]) into the [H,W] film
// and, if rgb2 and w2 are not null, the squared film. kind is 1 tent, 2
// gaussian, 3 mitchell or catmullrom, 4 lanczos, and radius the kind's
// (1, 2, 2, 3); consts points to N_CONSTS floats in host memory. Returns
// cudaGetLastError() as an int (0 = launched), or cudaErrorInvalidValue
// for an unknown kind, another radius, or a film of 2^22 pixels a side
// or more.
extern "C" int ppg_film_splat_filter(float* rgb, float* w, float* rgb2,
                                     float* w2, const float* pos,
                                     const float* values, long long start,
                                     long long C, int W, int H, int kind,
                                     float radius, const float* consts,
                                     int device, void* stream) {
    if (kind < TENT || kind > LANCZOS || W <= 0 || H <= 0 ||
        W >= MAX_SIDE || H >= MAX_SIDE)
        return cudaErrorInvalidValue;
    const int K = kind == TENT ? 1 : kind == LANCZOS ? 3 : 2;
    if (radius != static_cast<float>(K)) return cudaErrorInvalidValue;
    const long long n_pix = static_cast<long long>(W) * H;
    const long long last = (start + C < n_pix ? start + C : n_pix) - 1;
    if (C <= 0 || start < 0 || last < start) return 0;
    const int first_row = static_cast<int>(start / W) - K;
    const int last_row = static_cast<int>(last / W) + K;
    const int y0 = first_row < 0 ? 0 : first_row;
    const int rows = (last_row < H ? last_row : H - 1) - y0 + 1;
    FilterArgs a{rgb, w, rgb2, w2, pos, values, start, last, W, H, y0, rows,
                 (W + TILE_W - 1) / TILE_W, {}};
    for (int k = 0; k < N_CONSTS; ++k) a.c[k] = consts[k];
    const int grid = a.tiles_x * ((rows + TILE_H - 1) / TILE_H);
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    int err;
    switch (kind) {
        case TENT: err = launch_filter<TENT>(a, grid, stream); break;
        case GAUSSIAN: err = launch_filter<GAUSSIAN>(a, grid, stream); break;
        case MITCHELL: err = launch_filter<MITCHELL>(a, grid, stream); break;
        default: err = launch_filter<LANCZOS>(a, grid, stream); break;
    }
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
