// K8: visible-normal microfacet sampling, Beckmann and GGX.
//
// It replaces ppg_tpu/bsdf/microfacet.py::sample_visible (:164) with
// _sample_visible_11 (:90), whose Beckmann branch is an XLA fori_loop of
// 12 bisection-Newton rounds (:149; no Pallas original). The BSDF table
// calls it once per sample_bsdf for the roughconductor, roughplastic and
// roughdielectric lanes together. The semantics are those of the plain
// version, ppg_tpu_torch/bsdf/microfacet.py::sample_visible_plain: stretch
// wi by (alpha_u, alpha_v, 1) and normalise it, take its polar angles,
// draw the alpha = 1 slope (GGX: Heitz's closed form; Beckmann: the
// erf-domain bisection-Newton rounds from the fitted start, or the
// normal-incidence case for theta < 1e-4), rotate it by phi, unstretch
// and normalise. The plain version computes both distributions on every
// lane and selects; one thread here computes only its lane's, which gives
// that lane the same bits. Every operation is the plain version's, in its
// order: sums of squares left to right, clamps as compare and select
// (which pass a NaN on, as fminf/fmaxf would not), 1 / x as a quotient,
// the constants as ATen rounds a Python float (the double cast to float),
// and the CUDA math library's erff, erfinvf, expf, powf, tanf, acosf,
// atan2f, sinf, cosf, logf and sqrtf, which ATen's erf, erfinv, exp, pow,
// tan, acos, atan2, sin, cos, log and sqrt call on a card. Built with
// --fmad=false, so no product is fused into a sum: the kernel equals the
// plain version bit for bit.
//
// What bounds it on an H100: bytes, at the roofline. A lane reads wi (12
// B), two uniforms (8 B), alpha_u, alpha_v and dist (12 B) and writes m
// (12 B): 11.5 MB, 3.4 us, for 262,144 lanes at 3.35 TB/s, where the
// Beckmann rounds' FP32 operations take about 1.3 us at 67 TFLOP/s. In
// practice its time is the instructions of the rounds' erfinvf, expf
// and IEEE divisions, about 90 a round on a Beckmann lane. One thread a
// lane reading every input through the strides it is given (the tracer's
// uniforms are columns of a [L,3] draw), one launch for what the plain
// version does in about 400.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ROUNDS = 12;
constexpr int GGX = 1;

// Python floats as ATen rounds them: the double to float
constexpr float TWO_PI = static_cast<float>(6.283185307179586);
constexpr float SQRT_PI_INV = static_cast<float>(0.5641895835477563);
constexpr float EDGE = static_cast<float>(0.9999999);
constexpr float C1 = static_cast<float>(-0.876);
constexpr float C2 = static_cast<float>(0.4265);
constexpr float C3 = static_cast<float>(0.0594);
constexpr float TILT_S = static_cast<float>(0.99999);
constexpr float EPS_N = static_cast<float>(1e-8);
constexpr float EPS_T = static_cast<float>(1e-12);
constexpr float EPS_U = static_cast<float>(1e-6);
constexpr float EPS_D = static_cast<float>(1e-12);
constexpr float NEAR0 = static_cast<float>(1e-4);

struct Args {
    const float* wi;
    long long wi_s0, wi_s1;
    const float* u;
    long long u_s0, u_s1;
    const float* alpha_u;
    long long au_s;
    const float* alpha_v;
    long long av_s;
    const int32_t* dist;
    long long d_s;
    float* m;  // [L,3], contiguous
    long long L;
};

// max(x, c) and min(x, c) as the plain version's compare and select
__device__ __forceinline__ float at_least(float x, float c) {
    return x < c ? c : x;
}
__device__ __forceinline__ float at_most(float x, float c) {
    return x > c ? c : x;
}

// GGX's alpha = 1 slope for the stretched wi = (sin theta, 0, cos theta):
// Heitz's disk in the basis T1 = (0, 1, 0), T2 = (-cos theta, 0, sin
// theta), squeezed along T2
__device__ void ggx_slope(float theta, float u1, float u2, float* sx,
                          float* sy) {
    const float wix = sinf(theta), wiz = cosf(theta);
    const float r = sqrtf(u1);
    const float phi = TWO_PI * u2;
    const float p1 = r * cosf(phi);
    float p2 = r * sinf(phi);
    const float s = 0.5f * (1.0f + wiz);
    p2 = (1.0f - s) * sqrtf(at_least(1.0f - p1 * p1, 0.0f)) + s * p2;
    const float p3 = sqrtf(at_least(1.0f - p1 * p1 - p2 * p2, 0.0f));
    const float nx = p3 * wix - p2 * wiz;
    const float nz = at_least(p2 * wix + p3 * wiz, EPS_N);
    *sx = -nx / nz;
    *sy = -p1 / nz;
}

// Beckmann's alpha = 1 slope: the bisection-Newton rounds in the erf
// domain, or the normal-incidence case
__device__ void beckmann_slope(float theta, float u1, float u2, float* sx,
                               float* sy) {
    if (theta < NEAR0) {
        const float r0 = sqrtf(at_least(-logf(1.0f - u1), 0.0f));
        const float phi0 = TWO_PI * u2;
        *sx = r0 * cosf(phi0);
        *sy = r0 * sinf(phi0);
        return;
    }
    const float tan_ti = tanf(theta);
    const float cot = 1.0f / at_least(tan_ti, EPS_T);
    const float c = erff(cot);
    const float ux = at_least(u1, EPS_U);
    const float fit = 1.0f + theta * (C1 + theta * (C2 - C3 * theta));
    float b = c - (1.0f + c) * powf(1.0f - ux, fit);
    const float k = SQRT_PI_INV * tan_ti;
    const float norm = 1.0f / (1.0f + c + k * expf(-cot * cot));
    float a = -1.0f, cc = c;
    for (int r = 0; r < ROUNDS; ++r) {
        if (!(b >= a && b <= cc)) b = 0.5f * (a + cc);
        const float ie = erfinvf(at_most(at_least(b, -EDGE), EDGE));
        const float value = (1.0f + b + k * expf(-ie * ie)) * norm - ux;
        if (value <= 0.0f) a = b;
        else cc = b;
        const float deriv = (1.0f - ie * tan_ti) * norm;
        b = b - value / (fabsf(deriv) < EPS_D ? 1.0f : deriv);
    }
    b = at_most(at_least(b, -EDGE), at_most(c, EDGE));
    *sx = erfinvf(b);
    *sy = erfinvf(at_most(at_least(2.0f * at_least(u2, EPS_U) - 1.0f, -EDGE),
                          EDGE));
}

__global__ void __launch_bounds__(BLOCK) vndf_kernel(const Args a) {
    const long long i =
        static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
    if (i >= a.L) return;
    const float* w = a.wi + i * a.wi_s0;
    const float au = a.alpha_u[i * a.au_s], av = a.alpha_v[i * a.av_s];
    const float u1 = a.u[i * a.u_s0], u2 = a.u[i * a.u_s0 + a.u_s1];
    float sx = au * w[0], sy = av * w[a.wi_s1], sz = w[2 * a.wi_s1];
    const float n = sqrtf(sx * sx + sy * sy + sz * sz);
    sx = sx / n;
    sy = sy / n;
    sz = sz / n;
    const float z = at_most(at_least(sz, -1.0f), 1.0f);
    const bool tilt = z < TILT_S;
    const float theta = tilt ? acosf(z) : 0.0f;
    const float phi = tilt ? atan2f(sy, sx) : 0.0f;
    const float sp = sinf(phi), cp = cosf(phi);
    float slx, sly;
    if (a.dist[i * a.d_s] == GGX) ggx_slope(theta, u1, u2, &slx, &sly);
    else beckmann_slope(theta, u1, u2, &slx, &sly);
    const float mx = (cp * slx - sp * sly) * au;
    const float my = (sp * slx + cp * sly) * av;
    const float inv = 1.0f / sqrtf(mx * mx + my * my + 1.0f);
    float* out = a.m + 3 * i;
    out[0] = -mx * inv;
    out[1] = -my * inv;
    out[2] = inv;
}

}  // namespace

// K8 on `stream` of card `device`: m [L,3] (contiguous) from wi [L,3], u
// [L,2], alpha_u, alpha_v [L] and dist [L] (int32), each read through the
// element strides given. Returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int ppg_vndf_sample(const float* wi, long long wi_s0,
                               long long wi_s1, const float* u,
                               long long u_s0, long long u_s1,
                               const float* alpha_u, long long au_s,
                               const float* alpha_v, long long av_s,
                               const int32_t* dist, long long d_s, float* m,
                               long long L, int device, void* stream) {
    if (L <= 0) return 0;
    const Args a{wi, wi_s0, wi_s1, u, u_s0, u_s1, alpha_u, au_s,
                 alpha_v, av_s, dist, d_s, m, L};
    const long long blocks = (L + BLOCK - 1) / BLOCK;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const unsigned grid = static_cast<unsigned>(blocks);
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    vndf_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
