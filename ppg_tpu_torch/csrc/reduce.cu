// K5's accumulation: target[m] += the sum of the values whose index is m,
// for one or two value streams over one index, with sums that do not
// depend on the order of the records.
//
// It replaces ppg_tpu/ops/reduce.py::bincount_add (:58) and bincount_add2
// (:69), which sort the records by index and take a compensated prefix
// sum (an XLA sort and associative scan; no Pallas original), so that the
// same records give the same sums on every run. Float atomics would give
// other last bits on every run, so this kernel takes no float atomic: each
// cell's sum is a fixed-point integer sum, and integer addition is
// associative. The semantics are those of the plain version,
// ppg_tpu_torch/ops/reduce.py::bincount_add_plain:
// - A value that is zero touches nothing (the main path masks its records
//   with zeros at cell 0).
// - For each cell m and stream, over its finite nonzero values: c_m, their
//   count; e_m, the largest frexp exponent (|v| < 2^e_m); the scale
//   S_m = 62 - bitlen(c_m) (bitlen(c) = ceil(log2(c + 1))). Each value is
//   rounded to the integer q = rint(v 2^(S_m - e_m)) (half to even, exact
//   in double), so |q| <= 2^S_m and |sum q| <= c_m 2^S_m < 2^62: the int64
//   sum cannot overflow. The cell's new value is
//   float(double(target) + double(sum q) 2^(e_m - S_m)), each step rounded
//   to nearest.
// - Error: each q is off by at most half a quantum, so the fixed-point
//   total is within c_m 2^(e_m - S_m - 1) <= c_m^2 2^(e_m - 62) of the
//   exact sum; converting the int64 sum to double and adding the target
//   each add at most 2^-53 relative, and the result is rounded once to
//   float32.
// - A cell that receives a non-finite value gets target + (the IEEE sum of
//   its non-finite values: NaN if any is NaN or both infinities come, else
//   the one infinity), its finite values dropped: a NaN stays in its own
//   cell, as a scatter-add leaves it.
// Three launches do it, on scratch that the wrapper keeps zeroed: pass 1
// over the records counts each cell's finite nonzero values and takes
// their largest exponent (32-bit integer atomics), and flags its
// non-finite ones; pass 2 over the records quantises each value at its
// cell's scale and adds it (64-bit integer atomics); pass 3 over the cells
// writes the targets of the cells that got a value and zeroes their
// scratch again. In passes 1 and 2 the 16 lanes of a half-warp first
// combine the records that share a cell (__match_any_sync, then the
// peers' values by shuffles, only where some lanes share one), so that a
// crowded cell takes one atomic per group, not one per record; this
// changes no bit. Every conversion is an explicitly rounded intrinsic, the
// powers of two are built from their bits, and there is no fast-math flag
// (subnormal values are quantised exactly), so the kernel equals the plain
// version bit for bit.
//
// What bounds it on an H100 (3.35 TB/s), as chip_smoke.py counts it: the
// index (4 or 8 B) and the values (4 B a stream) of each record read once,
// and the target of each cell that gets a nonzero value read and written
// (8 B a stream): bytes, some 24 us for the box splat's 9.4 M records
// into 643 k of 1.39 M cells. The design reads each record twice and moves
// each touched cell's 20 B of scratch through L2 as integer atomics; on
// crowded cells (the Adam statistics' and statistical weights' few
// thousand cells take millions of records) the atomics on one address
// queue in L2, which the group combine cuts down: without it, K5 took
// 1.37 ms of the NEE path's training wavefront against 0.80 ms with it,
// and 0.21 against 0.15 ms of cbox's, though the box splat's call alone
// was faster without it (PERF.md, PR 8). Each kernel's loop over the
// streams is unrolled so that a.s[s] has a constant index: a runtime
// index made every thread copy the 128-byte argument block to local
// memory, which made the passes several times slower (PERF.md's K5 row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int GROUP = 16;  // lanes that combine their records
constexpr int ACC_BITS = 62;
constexpr int EXP_BIAS = 256;  // ex holds e + EXP_BIAS, 0 = no value yet
constexpr int NF_POS = 1, NF_NEG = 2, NF_NAN = 4;

struct Stream {
    float* target;
    const float* val;
    long long* acc;  // the cell's sum of q
    int* cnt;        // its count of finite nonzero values
    int* ex;         // its largest exponent + EXP_BIAS
    int* nf;         // its non-finite flags
};

struct Args {
    const void* idx;
    int idx64;  // idx is int64, else int32
    long long N;
    int M;
    int n;  // streams
    Stream s[2];
};

__device__ __forceinline__ unsigned group_mask() {
    return 0xffffu << (threadIdx.x & 16u);
}

// The cell of record i, or -1 past the records. An index outside [0, M)
// traps, as index_add_'s device assertion does: the launch fails.
__device__ __forceinline__ int cell_of(const Args& a, long long i) {
    if (i >= a.N) return -1;
    const long long c = a.idx64
                            ? static_cast<const long long*>(a.idx)[i]
                            : static_cast<const int32_t*>(a.idx)[i];
    if (c < 0 || c >= a.M) __trap();
    return static_cast<int>(c);
}

__device__ __forceinline__ bool finite_bits(unsigned b) {
    return (b & 0x7f800000u) != 0x7f800000u;
}

// frexp's exponent of a finite nonzero float: |v| in [2^(e-1), 2^e).
__device__ __forceinline__ int exponent_of(unsigned b) {
    b &= 0x7fffffffu;
    const int E = static_cast<int>(b >> 23);
    return E ? E - 126 : -117 - __clz(static_cast<int>(b));
}

// 2^k, exact, for k in [-1022, 1023].
__device__ __forceinline__ double pow2(int k) {
    return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

// S = ACC_BITS - bitlen(c) for a count c >= 1.
__device__ __forceinline__ int scale_bits(int c) {
    return ACC_BITS - (32 - __clz(c));
}

// The lanes of this lane's group that hold the same key, as bits 0-15.
__device__ __forceinline__ unsigned peers_of(int key) {
    return (__match_any_sync(group_mask(), key) >> (threadIdx.x & 16u)) &
           0xffffu;
}

// True where some lane of the group shares its (valid) key with another.
__device__ __forceinline__ bool group_shares(int key, unsigned peers) {
    const unsigned self = 1u << (threadIdx.x & 15u);
    return __ballot_sync(group_mask(), key >= 0 && peers != self) != 0;
}

// True on the lowest lane of its peers.
__device__ __forceinline__ bool leads(unsigned peers) {
    return (peers & ((1u << (threadIdx.x & 15u)) - 1u)) == 0;
}

// Pass 1: counts, largest exponents, non-finite flags.
__global__ void __launch_bounds__(BLOCK) reduce_count_kernel(const Args a) {
    const long long i =
        static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
    const int cell = cell_of(a, i);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s == a.n) break;
        const Stream& st = a.s[s];
        const float v = cell >= 0 ? st.val[i] : 0.0f;
        const unsigned b = __float_as_uint(v);
        const bool fin = finite_bits(b);
        const int key = v != 0.0f && fin ? cell : -1;
        const int e = key >= 0 ? exponent_of(b) + EXP_BIAS : 0;
        const unsigned peers = peers_of(key);
        int emax = e;
        if (group_shares(key, peers)) {
            for (int j = 0; j < GROUP; ++j) {
                const int ej = __shfl_sync(group_mask(), e, j, GROUP);
                if ((peers >> j & 1u) && ej > emax) emax = ej;
            }
        }
        if (key >= 0 && leads(peers)) {
            atomicAdd(st.cnt + key, __popc(peers));
            atomicMax(st.ex + key, emax);
        }
        if (cell >= 0 && !fin)
            atomicOr(st.nf + cell, (b & 0x7fffffffu) > 0x7f800000u ? NF_NAN
                                   : v > 0.0f                     ? NF_POS
                                                                  : NF_NEG);
    }
}

// Pass 2: each value quantised at its cell's scale and added.
__global__ void __launch_bounds__(BLOCK) reduce_quantise_kernel(const Args a) {
    const long long i =
        static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
    const int cell = cell_of(a, i);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s == a.n) break;
        const Stream& st = a.s[s];
        const float v = cell >= 0 ? st.val[i] : 0.0f;
        const int key = v != 0.0f && finite_bits(__float_as_uint(v)) ? cell
                                                                     : -1;
        long long q = 0;
        if (key >= 0) {
            const int sh = scale_bits(st.cnt[key]) - (st.ex[key] - EXP_BIAS);
            q = __double2ll_rn(__dmul_rn(static_cast<double>(v), pow2(sh)));
        }
        const unsigned peers = peers_of(key);
        long long sum = q;
        if (group_shares(key, peers)) {
            sum = 0;
            const int lo = static_cast<int>(q & 0xffffffffLL);
            const int hi = static_cast<int>(q >> 32);
            for (int j = 0; j < GROUP; ++j) {
                const unsigned lj = static_cast<unsigned>(
                    __shfl_sync(group_mask(), lo, j, GROUP));
                const int hj = __shfl_sync(group_mask(), hi, j, GROUP);
                if (peers >> j & 1u)
                    sum += static_cast<long long>(
                        (static_cast<unsigned long long>(
                             static_cast<unsigned>(hj)) << 32) | lj);
            }
        }
        if (key >= 0 && leads(peers))
            atomicAdd(reinterpret_cast<unsigned long long*>(st.acc + key),
                      static_cast<unsigned long long>(sum));
    }
}

// Pass 3: the targets of the cells that got a value; their scratch zeroed.
__global__ void __launch_bounds__(BLOCK) reduce_finish_kernel(const Args a) {
    const long long m =
        static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
    if (m >= a.M) return;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s == a.n) break;
        const Stream& st = a.s[s];
        const int c = st.cnt[m], f = st.nf[m];
        if (c == 0 && f == 0) continue;
        float t = st.target[m];
        if (f) {
            const float inf = __int_as_float(0x7f800000);
            const bool nan = (f & NF_NAN) || (f & NF_POS && f & NF_NEG);
            t = __fadd_rn(t, nan ? __int_as_float(0x7fc00000)
                             : f & NF_POS ? inf
                                          : -inf);
        } else {
            const double total = __dmul_rn(
                __ll2double_rn(st.acc[m]),
                pow2(st.ex[m] - EXP_BIAS - scale_bits(c)));
            t = __double2float_rn(__dadd_rn(static_cast<double>(t), total));
        }
        st.target[m] = t;
        st.acc[m] = 0;
        st.cnt[m] = 0;
        st.ex[m] = 0;
        st.nf[m] = 0;
    }
}

int grid_for(long long threads) {
    return static_cast<int>((threads + BLOCK - 1) / BLOCK);
}

}  // namespace

// K5 on `stream` of card `device`: the n_streams (1 or 2) targets [M] +=
// their values [N] summed by idx [N] (int64 if idx64, else int32; an index
// outside [0, M) traps). acc, cnt, ex and nf are the scratch, cap
// cells a stream (stream 1's at +cap), all zero; the launches leave them
// zero. Returns the first cudaGetLastError() that is not 0, or 0.
extern "C" int ppg_reduce_add(const void* idx, int idx64, long long N, int M,
                              int n_streams, float* target0,
                              const float* val0, float* target1,
                              const float* val1, long long* acc, int* cnt,
                              int* ex, int* nf, long long cap, int device,
                              void* stream) {
    if (N <= 0 || M <= 0) return 0;
    Args a{idx, idx64, N, M, n_streams, {}};
    a.s[0] = Stream{target0, val0, acc, cnt, ex, nf};
    a.s[1] = Stream{target1, val1, acc + cap, cnt + cap, ex + cap, nf + cap};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const int rec = grid_for(N), cells = grid_for(M);
    int err = 0;
    reduce_count_kernel<<<rec, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (!err) {
        reduce_quantise_kernel<<<rec, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
    }
    if (!err) {
        reduce_finish_kernel<<<cells, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
    }
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
