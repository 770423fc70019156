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
