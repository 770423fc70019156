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
// scratch again. Integer
// addition is associative, so no choice below changes a bit. Each call
// takes one of two paths (ppg_reduce_path):
// - shared: where the call's cells x streams fit in SHARED_SLOTS (the
//   statistical weights' 1,093 cells, the gradient sums' 2 x 4,478),
//   passes 1 and 2 run one or two blocks of 1,024 threads an SM, each
//   summing a grid-stride share of the records into shared memory with
//   shared atomics, then adding each cell it touched to the global
//   scratch with one atomic.
// - global: one record a thread; the 16 lanes of a half-warp first
//   combine the records that share a cell (__match_any_sync, then the
//   peers' values by shuffles, only where some lanes share one), so that
//   a crowded cell takes one atomic per group, not one per record.
// A list of the cells a call touches, for pass 3 to walk in place of the
// scan, did not pay and is not kept: on the box splat's first 65,536
// records into its 1.39 M cells, the listing pass 1 took 0.0061 ms
// against 0.0027 and the list's pass 3 0.0052-0.0054 against the scan's
// 0.0045 (k1_compare.py --kernel k5, NVIDIA H100 80GB HBM3, 700 W), and
// no call of the main path has so few records for its cells.
// powers of two are built from their bits, and there is no fast-math flag
// (subnormal values are quantised exactly), so the kernel equals the plain
// version bit for bit.
//
// What bounds it on an H100 (3.35 TB/s), as chip_smoke.py counts it: the
// index (4 or 8 B) and the values (4 B a stream) of each record read once,
// and the target of each cell that gets a nonzero value read and written
// (8 B a stream): bytes, some 24 us for the box splat's 9.4 M records
// into 643 k of 1.39 M cells. The design reads each record twice and moves
// each touched cell's scratch through L2 as integer atomics. On crowded
// cells (the Adam statistics' and statistical weights' few thousand cells
// take millions of records) the atomics on one address queue in L2: the
// group combine cut that down (without it, K5 took 1.37 ms of the NEE
// path's training wavefront against 0.80 ms with it, and 0.21 against
// 0.15 ms of cbox's, though the box splat's call alone was faster without
// it; PERF.md, PR 8), and the shared path takes them off L2 altogether,
// one atomic a block and cell where there was one a record group. Alone
// on the main path's largest calls (k1_compare.py --kernel k5, NVIDIA
// H100 80GB HBM3, 700 W, the global path alone and this design in turns
// in one run): statistical weights 0.2175 → 0.0225-0.0227 ms and
// gradient sums 0.1556 → 0.0439-0.0443 ms (PERF.md, PR 9). In shared
// memory a 64-bit atomicAdd compiles to a compare-and-swap loop; two
// 32-bit adds with the carry (shared_add64) took the shared pass 2 from
// 0.0177 to 0.0111 ms on the statistical weights. Each kernel's loop
// over the streams is unrolled so that a.s[s] has a constant index: a
// runtime index made every thread copy the 128-byte argument block to
// local memory, which made the passes several times slower (PERF.md's
// K5 row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // the global path: one record a thread
constexpr int GROUP = 16;   // lanes that combine their records
// The shared path: SHARED_BLOCK threads a block, one or two blocks an SM,
// each keeping the sums of every cell and stream of the call in shared
// memory, SLOT_BYTES a cell and stream (pass 1: count, exponent, flags;
// pass 2: the int64 sum and the cell's shift). SHARED_SLOTS cells x
// streams take 192 KB of the 227 KB a block may have.
constexpr int SHARED_BLOCK = 1024;
constexpr int SLOT_BYTES = 12;
constexpr int SHARED_SLOTS = 16384;
constexpr int BLOCKS_PER_SM = 2;
constexpr int ACC_BITS = 62;
constexpr int EXP_BIAS = 256;  // ex holds e + EXP_BIAS, 0 = no value yet
constexpr int NF_POS = 1, NF_NEG = 2, NF_NAN = 4;

struct Stream {
    float* target;
    const float* val;
    unsigned long long* acc;  // the cell's sum of q
    int* cnt;                 // its count of finite nonzero values
    int* ex;                  // its largest exponent + EXP_BIAS
    int* nf;                  // its non-finite flags
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

// The non-finite flag of a value that is not finite.
__device__ __forceinline__ int nf_flag(unsigned b) {
    return (b & 0x7fffffffu) > 0x7f800000u ? NF_NAN
           : (b >> 31)                     ? NF_NEG
                                           : NF_POS;
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

// The shift S - e of a cell's values, from its count c and exponent
// field ex.
__device__ __forceinline__ int shift_of(int c, int ex) {
    return c ? scale_bits(c) - (ex - EXP_BIAS) : 0;
}

// v quantised at the shift sh: rint(v 2^sh), exact in double.
__device__ __forceinline__ long long quantise(float v, int sh) {
    return __double2ll_rn(__dmul_rn(static_cast<double>(v), pow2(sh)));
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

// Pass 1, global path: counts, largest exponents, non-finite flags.
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
        if (cell >= 0 && !fin) atomicOr(st.nf + cell, nf_flag(b));
    }
}

// Pass 2, global path: each value quantised at its cell's scale and
// added.
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
        const long long q =
            key >= 0 ? quantise(v, shift_of(st.cnt[key], st.ex[key])) : 0;
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
            atomicAdd(st.acc + key, static_cast<unsigned long long>(sum));
    }
}

// Pass 1, shared path: each block counts its share of the records into
// shared memory (count, exponent, flags of every cell and stream), then
// adds each cell it touched to the global scratch with one atomic each.
__global__ void __launch_bounds__(SHARED_BLOCK)
    reduce_count_shared_kernel(const Args a) {
    extern __shared__ unsigned long long dyn[];
    const int slots = a.n * a.M;
    int* cnt = reinterpret_cast<int*>(dyn);
    int* ex = cnt + slots;
    int* nf = ex + slots;
    for (int m = threadIdx.x; m < slots; m += SHARED_BLOCK)
        cnt[m] = ex[m] = nf[m] = 0;
    __syncthreads();
    const long long stride = static_cast<long long>(gridDim.x) * SHARED_BLOCK;
    for (long long i = static_cast<long long>(blockIdx.x) * SHARED_BLOCK +
                       threadIdx.x;
         i < a.N; i += stride) {
        const int cell = cell_of(a, i);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            if (s == a.n) break;
            const unsigned b = __float_as_uint(a.s[s].val[i]);
            const int m = s * a.M + cell;
            if (!finite_bits(b)) {
                atomicOr(nf + m, nf_flag(b));
            } else if (b & 0x7fffffffu) {
                atomicAdd(cnt + m, 1);
                atomicMax(ex + m, exponent_of(b) + EXP_BIAS);
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s == a.n) break;
        const Stream& st = a.s[s];
        for (int m = threadIdx.x; m < a.M; m += SHARED_BLOCK) {
            const int c = cnt[s * a.M + m], f = nf[s * a.M + m];
            if (c) {
                atomicAdd(st.cnt + m, c);
                atomicMax(st.ex + m, ex[s * a.M + m]);
            }
            if (f) atomicOr(st.nf + m, f);
        }
    }
}

// Adds q to the 64-bit sum held in w[0] (low word) and w[1] (high word)
// of shared memory with two 32-bit atomics, the low word's carry going
// into the high one: the sum is exact modulo 2^64 once all adds are
// done (a 64-bit shared atomicAdd compiles to a compare-and-swap loop).
__device__ __forceinline__ void shared_add64(unsigned* w,
                                             unsigned long long q) {
    const unsigned lo = static_cast<unsigned>(q);
    const unsigned before = atomicAdd(w, lo);
    atomicAdd(w + 1, static_cast<unsigned>(q >> 32) +
                         (before + lo < before ? 1u : 0u));
}

// Pass 2, shared path: each block takes every cell's shift into shared
// memory, sums its share of the records there as int64, then adds each
// nonzero sum to the global scratch with one atomic.
__global__ void __launch_bounds__(SHARED_BLOCK)
    reduce_quantise_shared_kernel(const Args a) {
    extern __shared__ unsigned long long dyn[];
    const int slots = a.n * a.M;
    unsigned long long* acc = dyn;  // each as its two words, low first
    int* sh = reinterpret_cast<int*>(dyn + slots);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s == a.n) break;
        for (int m = threadIdx.x; m < a.M; m += SHARED_BLOCK) {
            sh[s * a.M + m] = shift_of(a.s[s].cnt[m], a.s[s].ex[m]);
            acc[s * a.M + m] = 0;
        }
    }
    __syncthreads();
    const long long stride = static_cast<long long>(gridDim.x) * SHARED_BLOCK;
    for (long long i = static_cast<long long>(blockIdx.x) * SHARED_BLOCK +
                       threadIdx.x;
         i < a.N; i += stride) {
        const int cell = cell_of(a, i);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            if (s == a.n) break;
            const float v = a.s[s].val[i];
            if (v != 0.0f && finite_bits(__float_as_uint(v))) {
                const int m = s * a.M + cell;
                shared_add64(reinterpret_cast<unsigned*>(acc + m),
                             static_cast<unsigned long long>(
                                 quantise(v, sh[m])));
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s == a.n) break;
        for (int m = threadIdx.x; m < a.M; m += SHARED_BLOCK) {
            const unsigned long long q = acc[s * a.M + m];
            if (q) atomicAdd(a.s[s].acc + m, q);
        }
    }
}

// Cell m's target, if it got a value or a flag; its scratch zeroed.
__device__ __forceinline__ void finish_cell(const Stream& st, int m) {
    const int c = st.cnt[m], f = st.nf[m];
    if (c == 0 && f == 0) return;
    float t = st.target[m];
    if (f) {
        const float inf = __int_as_float(0x7f800000);
        const bool nan = (f & NF_NAN) || (f & NF_POS && f & NF_NEG);
        t = __fadd_rn(t, nan ? __int_as_float(0x7fc00000)
                         : f & NF_POS ? inf
                                      : -inf);
    } else {
        const double total =
            __dmul_rn(__ll2double_rn(static_cast<long long>(st.acc[m])),
                      pow2(-shift_of(c, st.ex[m])));
        t = __double2float_rn(__dadd_rn(static_cast<double>(t), total));
    }
    st.target[m] = t;
    st.acc[m] = 0;
    st.cnt[m] = 0;
    st.ex[m] = 0;
    st.nf[m] = 0;
}

// Pass 3: the targets of the cells that got a value; their scratch
// zeroed.
__global__ void __launch_bounds__(BLOCK) reduce_finish_kernel(const Args a) {
    const long long m =
        static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
    if (m >= a.M) return;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s == a.n) break;
        finish_cell(a.s[s], static_cast<int>(m));
    }
}

int grid_for(long long threads) {
    return static_cast<int>((threads + BLOCK - 1) / BLOCK);
}

// The shared path's grid: BLOCKS_PER_SM blocks an SM at most (as many
// as fit beside `bytes` of shared memory each), no more than the records
// need. Returns 0 where no block fits, or the error.
int shared_grid(int device, size_t bytes, long long N, int* grid) {
    int sms = 0;
    int err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device));
    int per_sm = BLOCKS_PER_SM;
    const void* kernels[2] = {
        reinterpret_cast<const void*>(reduce_count_shared_kernel),
        reinterpret_cast<const void*>(reduce_quantise_shared_kernel)};
    for (const void* k : kernels) {
        int n = 0;
        if (!err)
            err = static_cast<int>(cudaFuncSetAttribute(
                k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(bytes)));
        if (!err)
            err = static_cast<int>(
                cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, k, SHARED_BLOCK, bytes));
        if (n < per_sm) per_sm = n;
    }
    if (err) return err;
    if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long need = (N + SHARED_BLOCK - 1) / SHARED_BLOCK;
    const long long most = static_cast<long long>(sms) * per_sm;
    *grid = static_cast<int>(need < most ? need : most);
    return 0;
}

}  // namespace

// The path of a call into M cells a stream: PATH_SHARED or PATH_GLOBAL.
enum { PATH_SHARED = 0, PATH_GLOBAL = 1 };
extern "C" int ppg_reduce_path(int M, int n_streams) {
    return static_cast<long long>(M) * n_streams <= SHARED_SLOTS
               ? PATH_SHARED
               : PATH_GLOBAL;
}

// K5 on `stream` of card `device`: the n_streams (1 or 2) targets [M] +=
// their values [N] summed by idx [N] (int64 if idx64, else int32; an index
// outside [0, M) traps). acc, cnt, ex and nf are the scratch, cap
// cells a stream (stream 1's at +cap), all zero; the launches leave them
// zero. Returns the first error (of cudaFuncSetAttribute, the occupancy
// query or cudaGetLastError) that is not 0, or 0.
extern "C" int ppg_reduce_add(const void* idx, int idx64, long long N, int M,
                              int n_streams, float* target0,
                              const float* val0, float* target1,
                              const float* val1, unsigned long long* acc,
                              int* cnt, int* ex, int* nf, long long cap,
                              int device, void* stream) {
    if (N <= 0 || M <= 0) return 0;
    Args a{idx, idx64, N, M, n_streams, {}};
    a.s[0] = Stream{target0, val0, acc, cnt, ex, nf};
    a.s[1] = Stream{target1, val1, acc + cap, cnt + cap, ex + cap, nf + cap};
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const size_t bytes =
        static_cast<size_t>(SLOT_BYTES) * n_streams * static_cast<size_t>(M);
    int err = 0, grid = 0;
    if (ppg_reduce_path(M, n_streams) == PATH_SHARED) {
        err = shared_grid(device, bytes, N, &grid);
        if (!err) {
            reduce_count_shared_kernel<<<grid, SHARED_BLOCK, bytes, static_cast<cudaStream_t>(stream)>>>(a);
            err = static_cast<int>(cudaGetLastError());
        }
        if (!err) {
            reduce_quantise_shared_kernel<<<grid, SHARED_BLOCK, bytes, static_cast<cudaStream_t>(stream)>>>(a);
            err = static_cast<int>(cudaGetLastError());
        }
    } else {
        const int rec = grid_for(N);
        reduce_count_kernel<<<rec, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
        if (!err) {
            reduce_quantise_kernel<<<rec, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
            err = static_cast<int>(cudaGetLastError());
        }
    }
    if (!err) {
        reduce_finish_kernel<<<grid_for(M), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
        err = static_cast<int>(cudaGetLastError());
    }
    if (cur != device && cur >= 0) cudaSetDevice(cur);
    return err;
}
