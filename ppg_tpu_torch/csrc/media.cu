// K11: Woodcock (delta) tracking and ratio tracking through grid media.
//
// It replaces ppg_tpu/media.py::woodcock_sample (:256; its 64-event
// lax.scan blocks at :298 under the while_loop at :301) and
// ratio_transmittance (:309; the scan at :343 under the while_loop at
// :346): XLA loops, no Pallas original. In eager PyTorch an event is
// some 60 launches (the counter hash, the log, the world-to-grid affine,
// eight grid gathers, the trilinear blend, the selects), a block 64
// events and one host read; here one launch a call:
//   - mode 0 (track): woodcock_sample. A lane walks o + t d through its
//     medium's density grid against the majorant until an event is
//     accepted (a scatter: is_med, t, the albedo as weight), the flight
//     passes t_end (the surface, or inf: no event, t_end, weight 1) or
//     it reaches the cap of events (no event, as ppg_tpu);
//   - mode 1 (ratio): ratio_transmittance over [0, t_end]: the product
//     of 1 - density / majorant over the events before t_end, 1 on lanes
//     outside a grid medium; at the cap the product as it stands.
// The semantics are those of the plain version,
// ppg_tpu_torch/media.py::woodcock_sample_plain and
// ratio_transmittance_plain: a lane is gated in where mid >= 0, its
// row's hetero flag is set and its majorant is positive, and every other
// lane gets the plain version's values, so the gate adds no launch.
// Event k of lane i draws counter k * channels + c (channels 2 tracking,
// 1 ratio) from render/samplers.py's hash keyed by _hash(i, seed), the
// seed the int64 the wrapper's caller drew on the card, read here from
// memory; a uniform is the hash's top 24 bits times 2^-24. Every float
// operation is the plain version's, in its order: the flight
// t - logf(max(1 - u, 1e-38)) / max(maj, 1e-38) with the CUDA math
// library's logf (ATen's torch.log on a card), the point o + t d, the
// affine's products summed left to right, the insideness test on the
// continuous grid coordinate, the clamped cell, the trilinear blend in
// density's order, the acceptance u1 * maj < density * scale; clamps as
// compare and select. Built with --fmad=false, so no product is fused
// into a sum: the kernel equals the plain version bit for bit. A lane
// outside the grid reads no corner (its density is 0 whatever they
// hold); a corner's flat index is clamped into the grid, as ppg_tpu's
// gather clamps it.
//
// The design. Few lanes are gated in (chip_smoke phase 18's last track
// call: 36,708 of 262,144, 3.2 events each, the longest 21), in warps of
// 4.5 of them on average (SIMT efficiency of one thread a lane in the
// call's order 0.073, of the gated-in lanes queued in order 0.31;
// chip_smoke.media_layout). So:
//   - A persistent grid (as many blocks as the card holds at once) whose
//     blocks take tiles of BLOCK lanes, CHUNK tiles at a time: a thread
//     reads its lanes' medium ids (and, tracking, t_end) for the chunk's
//     tiles together, then the gate from the medium rows (read through
//     the L1, as every later read of a row). Gated-out lanes get their
//     values as coalesced stores
//     over the tile's outputs, and gated-in lanes join the block's queue
//     in shared memory in tile order (16-lane ballots, as K9 and K10).
//     The queue is worked once it could not take another chunk, or when
//     the block's tiles are done: a block gates all its tiles first, so
//     that all its lanes' walks run at once.
//   - Every thread takes a queued lane and, whenever its lane ends, the
//     next one (a shared counter): a warp stays full until the queue is
//     empty ("persistent while-while", Aila and Laine 2009). A thread
//     carries its lane's o, d, t_end, majorant, key, next event and t, or
//     T.
//   - A step takes BATCH events without a branch: every flight's term
//     logf(max(1 - u0, 1e-38)) / max(maj, 1e-38) (independent of the
//     others), then the flights t - term in order up to the first at or
//     past t_end or the cap, then the corner loads of every one of them
//     inside the grid, issued together, then the acceptance tests, or the
//     ratio factors, in event order. A lane accepted before the step's
//     last event has loaded the later events' corners in vain (57,120 of
//     1,001,320 on the last track call); their values are never used.
//   - A lane whose grid lies inside the concatenated grids with at least
//     two voxels an axis (checked once a lane, from its row) addresses its
//     corners in 32-bit arithmetic with no clamp: none could bind, so the
//     loads are the same; any other row takes the clamped 64-bit path.
// Each lane's outputs depend only on its own counters, so the order in
// which lanes are taken changes no bit.
//
// Measured (k1_compare.py --kernel k11, each variant in turns with the
// first design in one call; NVIDIA H100 80GB HBM3, 700.00 W; ms alone over
// K11_SETS copies of the lanes, the 64 MiB grid shared; the last track,
// last ratio, largest track and largest ratio calls): the first design
// (one thread a lane over every lane, 47-48 registers) 0.0354-0.0356,
// 0.0241-0.0242, 0.0406-0.0407, 0.0354-0.0355; this one 0.0261-0.0263,
// 0.0141-0.0143, 0.0363-0.0364, 0.0312-0.0315 at 78 and 73 registers, no
// spill, 8,724 B shared, three blocks an SM. With the medium rows staged
// in shared memory when M <= 64 (96 and 80 registers, two and three
// blocks an SM) 0.0260, 0.0139, 0.0365-0.0368, 0.0320-0.0321: faster by
// 0.0001-0.0004 ms on the last calls, slower by 0.0002-0.0009 on the
// largest, so the rows are read in place.
// The steps of this design (each with the rows staged): the queue and
// refills with one event a step 0.0326-0.0329, 0.0177-0.0179,
// 0.0415-0.0417, 0.0367-0.0368 (80 and 63 registers); four events a step
// with a branch at each flight and each point outside the grid
// 0.0327-0.0331, 0.0169-0.0171, 0.0444-0.0458,
// 0.0367-0.0370 (128 and 102), branch-free 0.0278-0.0279, 0.0158-0.0159,
// 0.0402-0.0405, 0.0345-0.0346; branch-free with one, two, three and
// eight events a step 0.0305, 0.0173, 0.0401, 0.0361 / 0.0270-0.0272,
// 0.0155-0.0157, 0.0387-0.0390, 0.0336-0.0343 / 0.0268, 0.0154, 0.0382,
// 0.0343 / 0.0355, 0.0193, 0.0465, 0.0398; the 32-bit corners at three
// blocks an SM (80 registers, 20 B spilled) 0.0276, 0.0140, 0.0381,
// 0.0323; four events at three or four blocks an SM (spilling) 0.0441 and
// 0.0571 on the last track call; a static share of the queue instead of
// refills 0.0514 on the largest track call (0.0444-0.0458 with them).
// With every lane gated out the grid's floor is 0.0038-0.0039 ms tracking
// and 0.0027-0.0028 in ratio mode; with the corner loads replaced by
// arithmetic (four events a step) 0.0130, 0.0131, 0.0142, 0.0190.
//
// What bounds it on an H100 (chip_smoke.media_bound_ms): bytes. Every
// lane reads its medium id and t_end and writes its outputs; a gated-in
// lane reads o and d; the call reads each distinct grid float its live
// events inside the grid need once (4 B). The events' FP32 operations
// (about 70 a tracking event) take longer only on small grids. What keeps
// it from the bound: an event's eight corners lie in four rows of the
// grid, about four 32-byte sectors (its x pairs mostly share one), so the
// last track call's 118,025 events move an estimated 15 MB of sectors
// where the bound counts 3.6 MB of distinct floats, and the grid's lines
// do not stay in the L2 from one call to the next (warm is no faster);
// the rest is each lane's chain of flights, address arithmetic and loads
// (without the loads a call still takes 0.013-0.019 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // a block's threads, a tile's lanes
constexpr int GROUP = 16;   // the lanes of one ballot
constexpr int GROUPS = BLOCK / GROUP;
static_assert(GROUPS == GROUP, "a group scans a tile's group counts");
constexpr int TRACK = 0, RATIO = 1;
constexpr int ROW_W = 36;
// the events a step takes
constexpr int BATCH = 2;
// the tiles whose gates a block reads at once
constexpr int CHUNK = 4;
static_assert(CHUNK <= GROUPS, "one group scans each tile of a chunk");
// the block's queue, worked once it could not take another chunk
constexpr int QCAP = 2048;
static_assert(QCAP >= CHUNK * BLOCK, "a chunk fits in the queue");
// Python floats as ATen rounds them: the double to float
constexpr float TINY = static_cast<float>(1e-38);
constexpr float INV24 = static_cast<float>(1.0 / 16777216.0);

struct Args {
    const float* rows;  // [M, 36]
    int M;
    const float* grid;  // [G]
    long long G;
    const float* o;
    long long o_s0, o_s1;
    const float* d;
    long long d_s0, d_s1;
    const float* t_end;
    long long t_s;
    const int32_t* mid;
    long long mid_s;
    const long long* seed;  // [1], in [0, 2^32)
    int cap;                // events a lane takes at most
    uint8_t* is_med;        // track: [L]
    float* t;               // track: [L]
    float* w;               // track: [L, 3]
    float* T;               // ratio: [L]
    int L;
};

__device__ __forceinline__ uint32_t finish(uint32_t x) {
    x ^= x >> 16;
    x *= 0x21F0AAADu;
    x ^= x >> 15;
    x *= 0x735A2D97u;
    return x ^ (x >> 15);
}

// render/samplers.py::_to_float of counter c's hash under a lane's key
// (kmul = key * 0x9E3779B9)
__device__ __forceinline__ float uniform(uint32_t kmul, uint32_t c) {
    return static_cast<float>(finish(c + kmul) >> 8) * INV24;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;  // torch.clamp(min=): NaN stays NaN
}

__device__ __forceinline__ int clamp_row(int m, int M) {
    return m < 0 ? 0 : m > M - 1 ? M - 1 : m;
}

// The gate of a lane in medium m (the row clamped into the table, as
// fetch_row clamps it)
__device__ __forceinline__ bool gated_in(const float* rows, int M, int m) {
    if (m < 0) return false;
    const float* r = rows + clamp_row(m, M) * ROW_W;
    return __ldg(r + 7) > 0.0f && __ldg(r + 8) > 0.0f;
}

// A queued lane's state between steps
struct Lane {
    int i;    // the lane
    int row;  // its row's first float in the rows
    float o0, o1, o2, d0, d1, d2, t_end, maj, maj_c, scale;
    uint32_t kmul;  // its key times the golden ratio
    bool safe;      // every corner index in the grid: no clamp binds
    int k;          // the events it took
    float t, T;
};

__device__ __forceinline__ void start(const Args& a, uint32_t seed, int i,
                                      Lane& s) {
    s.i = i;
    s.row = clamp_row(__ldg(a.mid + i * a.mid_s), a.M) * ROW_W;
    s.o0 = __ldg(a.o + i * a.o_s0);
    s.o1 = __ldg(a.o + i * a.o_s0 + a.o_s1);
    s.o2 = __ldg(a.o + i * a.o_s0 + 2 * a.o_s1);
    s.d0 = __ldg(a.d + i * a.d_s0);
    s.d1 = __ldg(a.d + i * a.d_s0 + a.d_s1);
    s.d2 = __ldg(a.d + i * a.d_s0 + 2 * a.d_s1);
    s.t_end = __ldg(a.t_end + i * a.t_s);
    const float* r = a.rows + s.row;
    s.maj = __ldg(r + 8);
    s.maj_c = clamp_min(s.maj, TINY);
    s.scale = __ldg(r + 9);
    {
        const float r0 = __ldg(r + 11), r1 = __ldg(r + 12),
                    r2 = __ldg(r + 13), off = __ldg(r + 10);
        s.safe = a.G <= 0x7fffffffLL && r0 >= 2.0f && r1 >= 2.0f &&
                 r2 >= 2.0f && r0 < 65536.0f && r1 < 65536.0f &&
                 r2 < 65536.0f && off >= 0.0f && off < 2147483648.0f &&
                 static_cast<long long>(off) +
                         static_cast<long long>(static_cast<int>(r0)) *
                             static_cast<int>(r1) * static_cast<int>(r2) <=
                     a.G;
    }
    const uint32_t key = finish(static_cast<uint32_t>(i) + seed * 0x9E3779B9u);
    s.kmul = key * 0x9E3779B9u;
    s.k = 0;
    s.t = 0.0f;
    s.T = 1.0f;
}

// media.py::_cell at p through row r's grid: whether p is inside it,
// and its eight corners (loaded where `load` and p is inside, else 0) and
// the fractions in the clamped cell. No branch: the corners of a step's
// events are addressed and loaded together.
__device__ __forceinline__ bool corners(const Args& a, const float* r,
                                        float p0, float p1, float p2,
                                        bool load, bool safe, float c[8],
                                        float f[3]) {
    float w[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) w[k] = __ldg(r + 14 + k);
    const float g0 = w[0] * p0 + w[1] * p1 + w[2] * p2 + w[3];
    const float g1 = w[4] * p0 + w[5] * p1 + w[6] * p2 + w[7];
    const float g2 = w[8] * p0 + w[9] * p1 + w[10] * p2 + w[11];
    const float r0 = __ldg(r + 11), r1 = __ldg(r + 12), r2 = __ldg(r + 13);
    const bool inside = g0 >= 0.0f && g0 <= r0 - 1.0f && g1 >= 0.0f &&
                        g1 <= r1 - 1.0f && g2 >= 0.0f && g2 <= r2 - 1.0f;
    const int nx = static_cast<int>(r0), ny = static_cast<int>(r1),
              nz = static_cast<int>(r2);
    // a point outside takes cell 0 (its corners are not loaded)
    auto cell = [inside](float g, int n) {
        int x = static_cast<int>(floorf(inside ? g : 0.0f));
        const int hi = n - 2 < 0 ? 0 : n - 2;
        x = x < 0 ? 0 : x;
        return x > hi ? hi : x;
    };
    const int x = cell(g0, nx), y = cell(g1, ny), z = cell(g2, nz);
    f[0] = g0 - static_cast<float>(x);
    f[1] = g1 - static_cast<float>(y);
    f[2] = g2 - static_cast<float>(z);
    const bool ld = load && inside;
    if (safe) {
        const int b = static_cast<int>(static_cast<long long>(__ldg(r + 10))) +
                      (z * ny + y) * nx + x;
        const int sz32 = nx * ny;
#pragma unroll
        for (int k = 0; k < 8; ++k)
            c[k] = ld ? __ldg(a.grid + (b + (k >> 2) * sz32 +
                                        ((k >> 1) & 1) * nx + (k & 1)))
                      : 0.0f;
        return ld;
    }
    // ((z + dz) ny + (y + dy)) nx + (x + dx) = base + dz sz + dy sy + dx
    const long long sy = nx, sz = static_cast<long long>(nx) * ny;
    const long long base = static_cast<long long>(__ldg(r + 10)) +
                           (static_cast<long long>(z) * ny + y) * nx + x;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        long long idx = base + (k >> 2) * sz + ((k >> 1) & 1) * sy + (k & 1);
        idx = idx < 0 ? 0 : idx > a.G - 1 ? a.G - 1 : idx;
        c[k] = ld ? __ldg(a.grid + idx) : 0.0f;
    }
    return ld;
}

// media.py::_blend's trilinear value from the corners and fractions
__device__ __forceinline__ float blend(const float c[8], const float f[3]) {
    const float fx = f[0], fy = f[1], fz = f[2];
    const float ux = 1.0f - fx, uy = 1.0f - fy, uz = 1.0f - fz;
    return ((c[0] * ux + c[1] * fx) * uy + (c[2] * ux + c[3] * fx) * fy) *
               uz +
           ((c[4] * ux + c[5] * fx) * uy + (c[6] * ux + c[7] * fx) * fy) *
               fz;
}

constexpr int GOING = 0, ENDED = 1, HIT = 2;

// One step of lane s: its next BATCH events (fewer at t_end or the cap).
// Returns GOING, ENDED (a flight at or past t_end, or the cap) or HIT.
template <int MODE>
__device__ __forceinline__ int step(const Args& a, Lane& s) {
    constexpr uint32_t NCH = MODE == TRACK ? 2u : 1u;
    float tk[BATCH], u1[BATCH];
    // each flight's term logf(max(1 - u0, 1e-38)) / max(maj, 1e-38),
    // independent of the others
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
        const uint32_t ctr = NCH * static_cast<uint32_t>(s.k + e);
        tk[e] = logf(clamp_min(1.0f - uniform(s.kmul, ctr), TINY)) / s.maj_c;
        if (MODE == TRACK) u1[e] = uniform(s.kmul, ctr + 1u);
    }
    // the flights t - term in order; n: the events before the first flight
    // at or past t_end, or the cap
    int n = BATCH;
    float tt = s.t;
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
        tt = tt - tk[e];
        tk[e] = tt;
        if (n == BATCH && (s.k + e >= a.cap || tt >= s.t_end)) n = e;
    }
    const float* r = a.rows + s.row;
    float c[BATCH][8], f[BATCH][3];
    bool in[BATCH];
#pragma unroll
    for (int e = 0; e < BATCH; ++e)
        in[e] = corners(a, r, s.o0 + tk[e] * s.d0, s.o1 + tk[e] * s.d1,
                        s.o2 + tk[e] * s.d2, e < n, s.safe, c[e], f[e]);
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
        if (e >= n) break;
        const float dens = (in[e] ? blend(c[e], f[e]) : 0.0f) * s.scale;
        s.t = tk[e];
        if (MODE == TRACK) {
            if (u1[e] * s.maj < dens) {
                s.k += e + 1;
                return HIT;
            }
        } else {
            float q = 1.0f - dens / s.maj_c;
            q = q < 0.0f ? 0.0f : q;
            s.T = s.T * q;
        }
    }
    s.k += n;
    return n < BATCH || s.k >= a.cap ? ENDED : GOING;
}

template <int MODE>
__device__ __forceinline__ void write_lane(const Args& a, const Lane& s,
                                           bool hit) {
    if (MODE == TRACK) {
        a.is_med[s.i] = hit ? 1 : 0;
        a.t[s.i] = hit ? s.t : s.t_end;
        for (int c = 0; c < 3; ++c)
            a.w[3LL * s.i + c] = hit ? __ldg(a.rows + s.row + 3 + c) : 1.0f;
    } else {
        a.T[s.i] = s.T;
    }
}

// The block's queue[0, n): every thread takes a lane and, when it ends,
// the next one from *next (BLOCK at the start).
template <int MODE>
__device__ void work(const Args& a, uint32_t seed, const int* queue, int n,
                     int* next) {
    int q = threadIdx.x;
    Lane s{};
    bool has = q < n;
    if (has) start(a, seed, queue[q], s);
    while (has) {
        const int r = step<MODE>(a, s);
        if (r != GOING) {
            write_lane<MODE>(a, s, r == HIT);
            q = atomicAdd(next, 1);
            has = q < n;
            if (has) start(a, seed, queue[q], s);
        }
    }
}

// Weight 1 into the [L,3] rows of the tile at lane i0 whose lanes are
// gated out (bit clear in `in`, by group): the tile's 3 * BLOCK floats,
// three a thread, neighbouring threads on neighbouring floats.
__device__ __forceinline__ void unit_rows(float* out, long long i0, int L,
                                          const unsigned* in) {
    for (int r = 0; r < 3; ++r) {
        const int k = r * BLOCK + static_cast<int>(threadIdx.x);
        const int l = k / 3;
        if (i0 + l < L && !((in[l / GROUP] >> (l % GROUP)) & 1u))
            out[3 * i0 + k] = 1.0f;
    }
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK) media_kernel(const Args a) {
    __shared__ int s_queue[QCAP];
    __shared__ unsigned s_in[CHUNK][GROUPS];  // gated-in lanes, by group
    __shared__ int s_at[CHUNK][GROUPS + 1];   // their offsets and total
    __shared__ int s_next;
    const int t = threadIdx.x, lane = t % GROUP, grp = t / GROUP;
    const unsigned gmask = 0xffffu << (t & GROUP);
    const int tiles = (a.L + BLOCK - 1) / BLOCK;
    const uint32_t seed = static_cast<uint32_t>(__ldg(a.seed) & 0xffffffffLL);
    int queued = 0;  // the same in every thread
    for (int c0 = blockIdx.x; c0 < tiles; c0 += CHUNK * gridDim.x) {
        // the chunk's tiles c0 + u * gridDim.x: their ids (and t_end) first
        int m[CHUNK];
        float te[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            const long long i =
                static_cast<long long>(c0 + u * gridDim.x) * BLOCK + t;
            m[u] = -1;
            te[u] = 0.0f;
            if (i < a.L) {
                m[u] = __ldg(a.mid + i * a.mid_s);
                if (MODE == TRACK) te[u] = __ldg(a.t_end + i * a.t_s);
            }
        }
        __syncthreads();  // every thread has read the last chunk's s_in, s_at
        bool in[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            in[u] = gated_in(a.rows, a.M, m[u]);
            const unsigned bits =
                (__ballot_sync(gmask, in[u]) >> (t & GROUP)) & 0xffffu;
            if (lane == 0) s_in[u][grp] = bits;
        }
        __syncthreads();
        // group u scans tile u's group counts
        if (grp < CHUNK) {
            const int c = __popc(s_in[grp][lane]);
            int x = c;
            for (int d = 1; d < GROUP; d <<= 1) {
                const int y = __shfl_sync(gmask, x, lane - d, GROUP);
                if (lane >= d) x += y;
            }
            s_at[grp][lane] = x - c;
            if (lane == GROUP - 1) s_at[grp][GROUPS] = x;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            const long long i0 =
                static_cast<long long>(c0 + u * gridDim.x) * BLOCK;
            const long long i = i0 + t;
            if (in[u]) {
                s_queue[queued + s_at[u][grp] +
                        __popc(s_in[u][grp] & ((1u << lane) - 1u))] =
                    static_cast<int>(i);
            } else if (i < a.L) {
                if (MODE == TRACK) {
                    a.is_med[i] = 0;
                    a.t[i] = te[u];
                } else {
                    a.T[i] = 1.0f;
                }
            }
            if (MODE == TRACK && i0 < a.L) unit_rows(a.w, i0, a.L, s_in[u]);
            queued += s_at[u][GROUPS];
        }
        if (c0 + CHUNK * gridDim.x >= tiles || queued > QCAP - CHUNK * BLOCK) {
            if (t == 0) s_next = BLOCK;
            __syncthreads();
            work<MODE>(a, seed, s_queue, queued, &s_next);
            queued = 0;
        }
    }
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
        mode == TRACK
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, media_kernel<TRACK>, BLOCK, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, media_kernel<RATIO>, BLOCK, 0));
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

// K11 on `stream` of card `device`, in `mode` (0 track, 1 ratio), over L
// lanes: the medium rows [M, 36] and the concatenated grids [G]; o and d
// [L,3] through their element strides, t_end [L] (t_surf tracking, dist
// in ratio mode) and mid [L] int32 through theirs; seed, one int64 on
// the card; cap, the events a lane takes at most. Writes is_med [L]
// (bool), t [L] and w [L,3] tracking, T [L] in ratio mode (contiguous).
// Returns cudaGetLastError() as an int (0 = launched), the occupancy
// query's error, or cudaErrorInvalidValue for L of 2^31 or more, a bad
// mode or an empty table.
extern "C" int ppg_media_track(int mode, const float* rows, int M,
                               const float* grid, long long G,
                               const float* o, long long o_s0,
                               long long o_s1, const float* d,
                               long long d_s0, long long d_s1,
                               const float* t_end, long long t_s,
                               const int32_t* mid, long long mid_s,
                               const long long* seed, int cap,
                               uint8_t* is_med, float* t, float* w,
                               float* T, long long L, int device,
                               void* stream) {
    if (L <= 0) return 0;
    if (L > 0x7fffffffLL - BLOCK || (mode != TRACK && mode != RATIO) ||
        M <= 0 || G <= 0 || cap <= 0)
        return cudaErrorInvalidValue;
    const Args a{rows, M,     grid,  G,   o, o_s0,   o_s1,
                 d,    d_s0,  d_s1,  t_end, t_s, mid, mid_s,
                 seed, cap,   is_med, t,   w, T,      static_cast<int>(L)};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    int cap_blocks = 0;
    int err = resident_blocks(mode, device, &cap_blocks);
    if (!err) {
        const int tiles = static_cast<int>((L + BLOCK - 1) / BLOCK);
        const int grid_n = tiles < cap_blocks ? tiles : cap_blocks;
        if (mode == TRACK)
            media_kernel<TRACK><<<grid_n, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        else
            media_kernel<RATIO><<<grid_n, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
    }
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
