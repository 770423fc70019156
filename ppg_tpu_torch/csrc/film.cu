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
// kernel turns the scatter around: one thread per film pixel p in the
// rows the chunk reaches, [row(start) - K, row(last) + K] clipped to the
// film, visits the neighbours q = p + (dx, dy), dy then dx from -K to K,
// and for each q inside the film and among the chunk's lanes (start ..
// last, last < W * H) recomputes that sample's bx, by as ppg_tpu does and
// adds value * w and w (and, into the squared film, (value * value) * w,
// the square rounded once, and w) if p lies in its window. Each pixel
// sums its terms in that order from +0 and then does one read-modify-
// write of its film values, so no two threads write one place, no atomic
// is needed and a seed's render repeats bit for bit. The plain version,
// ppg_tpu_torch/render/film.py::splat_filter_plain, does the same adds in
// the same order (one shifted, masked add per neighbour), so with
// --fmad=false and the CUDA math library's expf and sinf on both sides
// the kernel equals it bit for bit. The filter's float32 constants come
// from the wrapper (render/film.py::filter_constants), rounded as
// ppg_tpu's float32 arithmetic rounds them.
//
// Precondition: each thread checks its own lane's sample (the (0, 0)
// neighbour). A sample outside its own pixel (or NaN) would have a
// window the gather does not see, so the thread traps, as K5 traps on an
// index outside its cells: a wrong input fails the launch and is never
// summed wrongly.
//
// What bounds it on an H100 (3.35 TB/s): bytes. A sample's 8 B position
// and 12 B value are read once, and each pixel of the rows reached has
// its 16 B of film read and written, twice that with the squared film:
// about 6.6 us for a 512 x 512 chunk. The FP32 work, two filter
// evaluations and about 17 operations per window term (n^2 terms a
// sample), stays below that. A thread reads each neighbour's sample from
// L1/L2 ((2K+1)^2 reads a pixel), so a warp's reads of one neighbour
// offset are 32 neighbouring samples.

namespace {

constexpr int FILTER_BLOCK = 256;
enum { TENT = 1, GAUSSIAN = 2, MITCHELL = 3, LANCZOS = 4 };
constexpr int N_CONSTS = 10;

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
    int kind, K, n;
    float radius;
    float c[N_CONSTS];    // render/film.py::filter_constants
};

// ppg_tpu/render/film.py::filter_eval for one offset; every product and
// sum rounded on its own (--fmad=false), the selects as in the plain
// version
__device__ __forceinline__ float filter_eval(const FilterArgs& a, float x) {
    const float ax = fabsf(x);
    if (a.kind == TENT) {
        const float v = 1.0f - ax;
        return v < 0.0f ? 0.0f : v;
    }
    if (a.kind == GAUSSIAN) {  // c[0] = alpha, c[1] = exp(alpha r^2)
        const float v = expf(a.c[0] * ax * ax) - a.c[1];
        return v < 0.0f ? 0.0f : v;
    }
    if (a.kind == MITCHELL) {
        // c[0..3]: the outer cubic from x^3 down, c[4..6]: the inner
        // cubic's x^3, x^2 and 1, c[7] = 1/6; x = |2 (ax / 2)| = ax
        const float x = ax, x2 = x * x, x3 = x * x * x;
        const float outer =
            (a.c[0] * x3 + a.c[1] * x2 + a.c[2] * x + a.c[3]) * a.c[7];
        const float inner = (a.c[4] * x3 + a.c[5] * x2 + a.c[6]) * a.c[7];
        const float m = x > 1.0f ? outer : inner;
        return ax <= 2.0f ? m : 0.0f;
    }
    // lanczos: c[0] = pi, c[1] = 1/3, c[2] = 1e-6, c[3] = 3;
    // sinc(x) = sin(pi x) / (pi x)
    const float px = a.c[0] * ax;
    const float t = ax * a.c[1];
    const float pt = a.c[0] * t;
    const float s = (sinf(px) / px) * (sinf(pt) / pt);
    const float v = ax < a.c[2] ? 1.0f : s;
    return ax <= a.c[3] ? v : 0.0f;
}

__global__ void __launch_bounds__(FILTER_BLOCK)
splat_filter_kernel(const FilterArgs a) {
    const long long t =
        static_cast<long long>(blockIdx.x) * FILTER_BLOCK + threadIdx.x;
    if (t >= static_cast<long long>(a.rows) * a.W) return;
    const int py = a.y0 + static_cast<int>(t / a.W);
    const int px = static_cast<int>(t % a.W);
    const long long pid = static_cast<long long>(py) * a.W + px;
    const float fx = static_cast<float>(px), fy = static_cast<float>(py);
    if (pid >= a.start && pid <= a.last) {
        const long long s = pid - a.start;
        const float x = __ldg(a.pos + 2 * s), y = __ldg(a.pos + 2 * s + 1);
        if (!(x >= fx && x <= fx + 1.0f && y >= fy && y <= fy + 1.0f))
            __trap();
    }
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, sw = 0.0f;
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
    for (int dy = -a.K; dy <= a.K; ++dy) {
        const int qy = py + dy;
        if (qy < 0 || qy >= a.H) continue;
        for (int dx = -a.K; dx <= a.K; ++dx) {
            const int qx = px + dx;
            if (qx < 0 || qx >= a.W) continue;
            const long long qid = static_cast<long long>(qy) * a.W + qx;
            if (qid < a.start || qid > a.last) continue;
            const long long s = qid - a.start;
            const float x = __ldg(a.pos + 2 * s), y = __ldg(a.pos + 2 * s + 1);
            const int bx = static_cast<int>(ceilf(x - 0.5f - a.radius));
            const int by = static_cast<int>(ceilf(y - 0.5f - a.radius));
            if (px < bx || px >= bx + a.n || py < by || py >= by + a.n)
                continue;
            const float w = filter_eval(a, fx + 0.5f - x) *
                            filter_eval(a, fy + 0.5f - y);
            const float v0 = __ldg(a.values + 3 * s);
            const float v1 = __ldg(a.values + 3 * s + 1);
            const float v2 = __ldg(a.values + 3 * s + 2);
            s0 = __fadd_rn(s0, __fmul_rn(v0, w));
            s1 = __fadd_rn(s1, __fmul_rn(v1, w));
            s2 = __fadd_rn(s2, __fmul_rn(v2, w));
            sw = __fadd_rn(sw, w);
            if (a.rgb2) {
                q0 = __fadd_rn(q0, __fmul_rn(__fmul_rn(v0, v0), w));
                q1 = __fadd_rn(q1, __fmul_rn(__fmul_rn(v1, v1), w));
                q2 = __fadd_rn(q2, __fmul_rn(__fmul_rn(v2, v2), w));
            }
        }
    }
    a.rgb[3 * pid] = __fadd_rn(a.rgb[3 * pid], s0);
    a.rgb[3 * pid + 1] = __fadd_rn(a.rgb[3 * pid + 1], s1);
    a.rgb[3 * pid + 2] = __fadd_rn(a.rgb[3 * pid + 2], s2);
    a.w[pid] = __fadd_rn(a.w[pid], sw);
    if (a.rgb2) {
        a.rgb2[3 * pid] = __fadd_rn(a.rgb2[3 * pid], q0);
        a.rgb2[3 * pid + 1] = __fadd_rn(a.rgb2[3 * pid + 1], q1);
        a.rgb2[3 * pid + 2] = __fadd_rn(a.rgb2[3 * pid + 2], q2);
        a.w2[pid] = __fadd_rn(a.w2[pid], sw);
    }
}

}  // namespace

// K7s on `stream` of card `device`: the chunk of C lanes from pixel
// `start` (its positions pos [C,2] and values [C,3]) into the [H,W] film
// and, if rgb2 and w2 are not null, the squared film. kind is 1 tent, 2
// gaussian, 3 mitchell or catmullrom, 4 lanczos; consts points to
// N_CONSTS floats in host memory. Returns cudaGetLastError() as an int
// (0 = launched), or cudaErrorInvalidValue for an unknown kind.
extern "C" int ppg_film_splat_filter(float* rgb, float* w, float* rgb2,
                                     float* w2, const float* pos,
                                     const float* values, long long start,
                                     long long C, int W, int H, int kind,
                                     float radius, const float* consts,
                                     int device, void* stream) {
    if (kind < TENT || kind > LANCZOS || W <= 0 || H <= 0)
        return cudaErrorInvalidValue;
    const long long n_pix = static_cast<long long>(W) * H;
    const long long last = (start + C < n_pix ? start + C : n_pix) - 1;
    if (C <= 0 || start < 0 || last < start) return 0;
    const int K = static_cast<int>(ceilf(radius));
    const int first_row = static_cast<int>(start / W) - K;
    const int last_row = static_cast<int>(last / W) + K;
    const int y0 = first_row < 0 ? 0 : first_row;
    const int rows = (last_row < H ? last_row : H - 1) - y0 + 1;
    FilterArgs a{rgb, w, rgb2, w2, pos, values, start, last, W, H, y0, rows,
                 kind, K, static_cast<int>(ceilf(2.0f * radius)), radius, {}};
    for (int k = 0; k < N_CONSTS; ++k) a.c[k] = consts[k];
    const long long threads = static_cast<long long>(a.rows) * W;
    const int grid =
        static_cast<int>((threads + FILTER_BLOCK - 1) / FILTER_BLOCK);
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    splat_filter_kernel<<<grid, FILTER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
