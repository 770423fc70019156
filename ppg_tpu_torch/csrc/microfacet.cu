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
// and normalise; a lane outside the gate (its family's bit not in the
// mask `fams`) gets m = (0, 0, 1). The plain version computes both
// distributions on every lane and selects; a thread here computes only
// its lane's, which gives that lane the same bits. Every operation is the
// plain version's, in its order: sums of squares left to right, clamps
// as compare and select (which pass a NaN on, as fminf/fmaxf would not),
// 1 / x as a quotient, the constants as ATen rounds a Python float (the
// double cast to float), and the CUDA math library's erff, erfinvf, expf,
// powf, tanf, acosf, atan2f, sinf, cosf, logf and sqrtf, which ATen's
// erf, erfinv, exp, pow, tan, acos, atan2, sin, cos, log and sqrt call on
// a card. Built with --fmad=false, so no product is fused into a sum: the
// kernel equals the plain version bit for bit.
//
// The design. On the main path most lanes need nothing: the
// table samples one visible normal over the whole wavefront, and only the
// lanes of the three microfacet families keep it (phase 14's last call:
// 128,008 of 262,144, 15,090 of them Beckmann). One thread a lane over
// every lane ran Beckmann's 12 rounds on every lane whose dist is 0, the
// zero default of every other family, and a warp with one such lane ran
// all 12 rounds beside its GGX lanes. Here a persistent grid's blocks
// take tiles of BLOCK lanes in turn. A thread reads its lane's family
// first: a lane outside the gate gets (0, 0, 1) and loads nothing else. A
// gated-in lane reads dist and joins the block's GGX or Beckmann queue in
// shared memory: 16-lane ballots, each queue's group counts scanned by a
// group of warp 0, tile order kept. Once a queue holds BLOCK lanes, every
// thread samples one of them, so every warp runs one branch; what is left
// when the block runs out of tiles is sampled in one pass over the queues
// end to end. A queued lane's inputs are read where it is sampled, and
// the Beckmann branch decides its normal-incidence case itself (4 lanes
// of the call), so the queues decide only which thread computes a lane.
//
// Held against others on phase 14's last call (k1_compare.py --kernel
// k8, each in turns with this one in one run, NVIDIA H100 80GB HBM3,
// 700 W, ms alone over copies above the L2): one thread a lane over every
// lane 0.0311-0.0313; this one 0.0237-0.0238 (the group offsets summed by
// every thread over the tile's 16 groups: 0.0239-0.0241); one thread a
// lane skipping the gated-out lanes 0.0311; a third queue for normal
// incidence, the stretched wi computed before queueing 0.0261, or
// stashed in shared memory 0.0253; one tile a block 0.0279; blocks of
// 128 0.0247, of 512 0.0260; 8 blocks an SM (32 registers, a spill)
// 0.0266; the next tile's families loaded ahead 0.0242, and with half or
// a quarter of the resident grid 0.0244-0.0269; the Beckmann queue first
// 0.0241.
//
// What bounds it on an H100 (chip_smoke.vndf_bound_ms): bytes. Every lane
// reads its family (4 B) and writes m (12 B); a gated-in lane also reads
// dist, wi, the two uniforms, alpha_u and alpha_v (32 B): 0.00247 ms on
// phase 14's last call, FP32 work a tenth of that. What it can approach
// is less: on the main path the family, dist and alpha_u are strided
// views of the gathered 444-byte material rows, a 32-byte sector each,
// and a tile's loads and queues and the sampling after them add up
// rather than overlap. On that call, ms alone: no lane gated in (the
// families read, (0, 0, 1) written) 0.0099-0.0100; the GGX families only
// 0.0186-0.0187 (the chain of trigonometry, square roots and divisions);
// the Beckmann ones only 0.0174-0.0176 (the rounds' chain of dependent
// erfinvf, expf and IEEE divisions); all three 0.0237-0.0238.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // a block's threads, a tile's lanes
constexpr int GROUP = 16;   // the lanes of one ballot
constexpr int GROUPS = BLOCK / GROUP;
static_assert(GROUPS == GROUP, "a group scans one queue's group counts");
constexpr int ROUNDS = 12;
constexpr int GGX = 1;
// the queues, in the order a block's remainder is sampled
constexpr int Q_GGX = 0, Q_BECKMANN = 1, QUEUES = 2;

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
    const int32_t* mtype;  // null: every lane is gated in
    long long mt_s;
    unsigned fams;  // bit t set: family t samples a visible normal
    float* m;       // [L,3], contiguous
    int L;
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

// Lane i's whole sample, its distribution given: the stretch, the slope,
// the rotation, the unstretch
__device__ void sample(const Args& a, int i, bool ggx) {
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
    if (ggx) ggx_slope(theta, u1, u2, &slx, &sly);
    else beckmann_slope(theta, u1, u2, &slx, &sly);
    const float mx = (cp * slx - sp * sly) * au;
    const float my = (sp * slx + cp * sly) * av;
    const float inv = 1.0f / sqrtf(mx * mx + my * my + 1.0f);
    float* out = a.m + 3 * static_cast<long long>(i);
    out[0] = -mx * inv;
    out[1] = -my * inv;
    out[2] = inv;
}

__global__ void __launch_bounds__(BLOCK) vndf_kernel(const Args a) {
    // each queue holds under BLOCK lanes between tiles, and a tile adds
    // at most BLOCK
    __shared__ int s_queue[QUEUES][2 * BLOCK];
    __shared__ unsigned s_in[QUEUES][GROUPS];  // a tile's lanes, by group
    __shared__ int s_at[QUEUES][GROUPS + 1];   // their offsets and total
    const int tid = threadIdx.x, lane = tid % GROUP, grp = tid / GROUP;
    const unsigned gmask = 0xffffu << (tid & GROUP);
    const int tiles = (a.L + BLOCK - 1) / BLOCK;
    int queued[QUEUES] = {0, 0};  // the same in every thread
    for (int tile = blockIdx.x;; tile += gridDim.x) {
        const bool more = tile < tiles;
        if (more) {
            const int i = tile * BLOCK + tid;
            int q = -1;  // the lane's queue; -1: none
            if (i < a.L) {
                const unsigned t =
                    a.mtype ? static_cast<unsigned>(a.mtype[i * a.mt_s]) : 0u;
                if (a.mtype && !(t < 32u && ((a.fams >> t) & 1u))) {
                    float* out = a.m + 3 * static_cast<long long>(i);
                    out[0] = 0.0f;
                    out[1] = 0.0f;
                    out[2] = 1.0f;
                } else {
                    q = a.dist[i * a.d_s] == GGX ? Q_GGX : Q_BECKMANN;
                }
            }
            unsigned bits[QUEUES];
#pragma unroll
            for (int k = 0; k < QUEUES; ++k) {
                bits[k] = (__ballot_sync(gmask, q == k) >> (tid & GROUP)) &
                          0xffffu;
                if (lane == 0) s_in[k][grp] = bits[k];
            }
            __syncthreads();
            // warp 0's group k scans queue k's counts by group
            if (tid < GROUP * QUEUES) {
                const int k = tid / GROUP;
                const int c = __popc(s_in[k][lane]);
                int x = c;
                for (int d = 1; d < GROUP; d <<= 1) {
                    const int y = __shfl_sync(gmask, x, lane - d, GROUP);
                    if (lane >= d) x += y;
                }
                s_at[k][lane] = x - c;
                if (lane == GROUP - 1) s_at[k][GROUPS] = x;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < QUEUES; ++k) {
                if (q == k)
                    s_queue[k][queued[k] + s_at[k][grp] +
                               __popc(bits[k] & ((1u << lane) - 1u))] = i;
                queued[k] += s_at[k][GROUPS];
            }
            __syncthreads();
            // a full queue: every thread samples one of its lanes
#pragma unroll
            for (int k = 0; k < QUEUES; ++k) {
                if (queued[k] < BLOCK) continue;
                sample(a, s_queue[k][tid], k == Q_GGX);
                const int rest = queued[k] - BLOCK;
                const int keep = tid < rest ? s_queue[k][BLOCK + tid] : 0;
                __syncthreads();
                if (tid < rest) s_queue[k][tid] = keep;
                __syncthreads();
                queued[k] = rest;
            }
        } else {
            // the block's remainder: the queues end to end
            for (int p = tid; p < queued[0] + queued[1]; p += BLOCK) {
                const int k = p < queued[0] ? 0 : 1;
                sample(a, s_queue[k][k ? p - queued[0] : p], k == Q_GGX);
            }
            break;
        }
    }
}

}  // namespace

// K8 on `stream` of card `device`: m [L,3] (contiguous) from wi [L,3], u
// [L,2], alpha_u, alpha_v [L] and dist [L] (int32), each read through the
// element strides given; with mtype [L] (int32, its stride mt_s) a lane is
// sampled when bit mtype of fams is set and gets (0, 0, 1) otherwise, and
// with mtype null every lane is sampled. Returns cudaGetLastError() as an
// int (0 = launched), or cudaErrorInvalidValue for L of 2^31 or more.
extern "C" int ppg_vndf_sample(const float* wi, long long wi_s0,
                               long long wi_s1, const float* u,
                               long long u_s0, long long u_s1,
                               const float* alpha_u, long long au_s,
                               const float* alpha_v, long long av_s,
                               const int32_t* dist, long long d_s,
                               const int32_t* mtype, long long mt_s,
                               unsigned fams, float* m, long long L,
                               int device, void* stream) {
    if (L <= 0) return 0;
    if (L > 0x7fffffffLL - BLOCK) return cudaErrorInvalidValue;
    const Args a{wi,   wi_s0, wi_s1, u,     u_s0, u_s1, alpha_u,
                 au_s, alpha_v, av_s, dist, d_s,  mtype, mt_s,
                 fams, m,     static_cast<int>(L)};
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
            &per_sm, vndf_kernel, BLOCK, 0));
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
        const int tiles = static_cast<int>((L + BLOCK - 1) / BLOCK);
        const int grid = tiles < cap ? tiles : cap;
        vndf_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
    }
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
