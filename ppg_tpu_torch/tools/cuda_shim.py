"""What a kernel source of csrc/ needs of CUDA, for a host compiler, so
that the kernels' own code runs on the CPU in the tests.

`build_host(src, out_dir, name, launches)` rewrites the source's launch
lines (`kernel<<<grid, block, shared, static_cast<cudaStream_t>(stream)>>>(`)
as `HOST_LAUNCH(grid, block, shared, kernel, ...)` and its dynamic
shared arrays (`extern __shared__ T name[];`) as pointers to the
launch's `shared` bytes, writes CUDA_SHIM as cuda_runtime.h beside it
(and a cuda_fp16.h that includes it: `__half`, `__ushort_as_half` and
the exact `__half2float`) and compiles it with the host C++ compiler
without FMA contraction (-ffp-contract=off), so each product and sum is
rounded on its own as the kernels' --fmad=false build rounds it. The
kernel's code runs unchanged: the threads of a block as fibers on one
host thread, so a run is deterministic and a switch wakes no system
thread (a fiber starts on its own stack with makecontext and setcontext;
switches are _setjmp / _longjmp, which save no signal mask, so they make
no system call). The blocks run one after another until a thread calls
__nanosleep (it waits on another block, as a persistent grid's barrier
does); from then on every block of the grid runs at once, a sleeping
thread resumed once a sweep over the blocks' threads, so the launch ends
with an error if its threads sleep 50 million times. A kernel whose
blocks may run at once keeps its shared memory dynamic (a static
__shared__ array is one for every block here). A collective stores the
lane's value in its group's exchange slots (two sets, used in turn: the
16-lane group for a mask of its 16 lanes, the warp for the full mask)
and hands the thread on to a lane of the group that has not stored its
value yet, or, where each of those sleeps, back to the launch's loop. A
collective that names another mask, lanes of a group in different
collectives, or a group that can no longer progress end the launch with
an error, as __trap() does. The collectives are __syncwarp,
__ballot_sync, __reduce_min_sync, __reduce_max_sync, __match_any_sync,
__shfl_sync and __shfl_xor_sync. __syncthreads hands the thread back to
the launch's loop, which releases the block's threads once all of them
wait there (a thread that returned while others wait ends the launch
with an error); a block's dynamic shared memory is filled with 0xa5
bytes before it starts, so a kernel that reads what it did not write
differs from the plain version. Atomics (32-bit integer add, max, or and
exchange, 32-bit unsigned add; 64-bit unsigned add; on global or shared
memory alike) are plain read-modify-writes, and __threadfence does
nothing, as one host thread runs every lane. Math functions (expf,
powf, erff, ...) are the host C library's, erfinvf, which it lacks, is
ATen's CPU calc_erfinv (exported as shim_erfinvf), and rsqrtf (the
card's rsqrt.approx, within its 2^-22.9 relative error) is the correctly
rounded 1 / sqrt(x); the rounded conversions and arithmetic intrinsics
(__dmul_rn, __double2ll_rn, ...) are the host's operations under its
default rounding to nearest.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

CUDA_SHIM = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <functional>
#include <memory>
#include <vector>
#include <ucontext.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx, threadIdx, gridDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 4 };
enum { cudaDevAttrMultiProcessorCount = 16 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaSetDevice(int) { return 0; }
// a card that holds 2 blocks on each of 3 multiprocessors, so that the
// persistent grid's groups take many rays each
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 3; return 0; }
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                         size_t) {
    *n = 2;
    return 0;
}
template <class F>
inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int atomicAdd(int* p, int v) { const int old = *p; *p += v; return old; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    const unsigned old = *p;
    *p += v;
    return old;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
    const unsigned long long old = *p;
    *p += v;
    return old;
}
inline int atomicMax(int* p, int v) {
    const int old = *p;
    if (v > old) *p = v;
    return old;
}
inline int atomicOr(int* p, int v) { const int old = *p; *p |= v; return old; }
inline int atomicExch(int* p, int v) { const int old = *p; *p = v; return old; }
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
struct uint2 { unsigned x, y; };
// float16 storage: the conversion to float is exact, as on the card
struct __half { unsigned short bits; };
inline __half __ushort_as_half(unsigned short b) { __half h; h.bits = b; return h; }
inline float __half2float(__half h) {
    const uint32_t s = (h.bits & 0x8000u) << 16;
    const uint32_t e = (h.bits >> 10) & 31u, m = h.bits & 1023u;
    uint32_t u;
    if (e == 31u) {
        u = s | 0x7f800000u | (m << 13);
    } else if (e != 0u) {
        u = s | ((e + 112u) << 23) | (m << 13);
    } else if (m == 0u) {
        u = s;
    } else {  // subnormal: normalise
        int k = -1;
        uint32_t mm = m;
        do { ++k; mm <<= 1; } while ((mm & 1024u) == 0u);
        u = s | ((112u - k) << 23) | ((mm & 1023u) << 13);
    }
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
struct int4 { int x, y, z, w; };
template <class T>
inline T __ldg(const T* p) { return *p; }
template <class T>
inline T __ldcg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) {
    unsigned i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned i) {
    float f; std::memcpy(&f, &i, 4); return f; }
// rsqrt.approx.f32 (2^-22.9 relative error on the card): the correctly
// rounded 1 / sqrt(x), which lies within it
inline float rsqrtf(float x) {
    return static_cast<float>(1.0 / std::sqrt(static_cast<double>(x))); }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) {
    return x ? __builtin_clz(static_cast<unsigned>(x)) : 32; }
inline double __longlong_as_double(long long i) {
    double d; std::memcpy(&d, &i, 8); return d; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __ll2double_rn(long long x) { return static_cast<double>(x); }
inline float __double2float_rn(double x) { return static_cast<float>(x); }
inline long long __double2ll_rn(double x) { return std::llrint(x); }
// erfinvf, which the C library lacks: ATen's calc_erfinv, the algorithm
// of PyTorch's CPU erfinv, on the C library's erff, expf, logf and sqrtf.
// Exported as shim_erfinvf, so that a test can give a plain version the
// same function.
extern "C" float shim_erfinvf(float y) {
    const float a[4] = {0.886226899f, -1.645349621f, 0.914624893f,
                        -0.140543331f};
    const float b[4] = {-2.118377725f, 1.442710462f, -0.329097515f,
                        0.012229801f};
    const float c[4] = {-1.970840454f, -1.624906493f, 3.429567803f,
                        1.641345311f};
    const float d[2] = {3.543889200f, 1.637067800f};
    const float y_abs = std::fabs(y);
    if (y_abs > 1.0f) return std::nanf("");
    if (y_abs == 1.0f) return std::copysign(INFINITY, y);
    float x;
    if (y_abs <= 0.7f) {
        const float z = y * y;
        const float num = ((a[3] * z + a[2]) * z + a[1]) * z + a[0];
        const float dem = (((b[3] * z + b[2]) * z + b[1]) * z + b[0]) * z
                          + 1.0f;
        x = y * num / dem;
    } else {
        const float z = std::sqrt(-std::log((1.0f - y_abs) / 2.0f));
        const float num = ((c[3] * z + c[2]) * z + c[1]) * z + c[0];
        const float dem = (d[1] * z + d[0]) * z + 1.0f;
        x = std::copysign(num, y) / dem;
    }
    const float k = 2.0f * 0.564189583547756286948f;
    x = x - (std::erf(x) - y) / (k * std::exp(-x * x));
    x = x - (std::erf(x) - y) / (k * std::exp(-x * x));
    return x;
}
inline float erfinvf(float y) { return shim_erfinvf(y); }

namespace shim {
struct Block;
struct Lane {
    ucontext_t start;  // the lane's first entry, on its own stack
    jmp_buf at;        // where it yielded
    Block* block;
    unsigned tid;
    long n[2];  // the collectives it passed: of its 16-lane group, its warp
    bool started, done, waits, sleeps;  // waits: at __syncthreads;
                                        // sleeps: in __nanosleep, or in a
                                        // collective that waits on one
};
struct Group { long arrived, idle; int op[2]; uint32_t slot[2][32]; };
struct Block {
    unsigned id;
    size_t stack0;  // its lanes' stacks: stacks[stack0 + tid]
    std::vector<Lane> lanes;
    std::vector<Group> groups[2];  // 16-lane groups, warps
    std::vector<unsigned char> shared;  // the block's dynamic
};
constexpr size_t STACK_BYTES = 1 << 16;
constexpr long SLEEPS_MAX = 50000000;  // a grid that sleeps this often hangs
static jmp_buf main_at;
static std::vector<std::unique_ptr<Block>> running;
static std::vector<std::unique_ptr<char[]>> stacks;
static std::vector<bool> stack_used;  // by block slot
static Block* cur;
static Lane* self;
static std::function<void()> body;
static int error;
static bool spread, slept;  // spread: every block of the grid runs at once
static long sleeps;

inline unsigned char* shared_now() { return cur->shared.data(); }

inline void entry() {
    body();
    self->done = true;
    _longjmp(main_at, 1);
}

// Runs lane l from where it yielded, or from its start.
[[noreturn]] inline void resume(Lane& l) {
    self = &l;
    cur = l.block;
    threadIdx.x = l.tid;
    blockIdx.x = l.block->id;
    l.sleeps = false;
    if (l.started) _longjmp(l.at, 1);
    l.started = true;
    setcontext(&l.start);
    std::abort();
}

inline void fail(const char* what) {
    if (!error) std::fprintf(stderr, "cuda shim: %s (block %u thread %u)\n",
                             what, blockIdx.x, threadIdx.x);
    error = cudaErrorLaunchFailure;
    _longjmp(main_at, 1);  // the lane is never resumed
}

// Hands the host thread back to the launch's loop, which resumes this
// lane in its next sweep.
inline void doze() {
    Lane& me = *self;
    me.sleeps = true;
    slept = true;
    spread = true;
    if (++sleeps > SLEEPS_MAX) fail("a grid cannot progress");
    if (_setjmp(me.at) == 0) _longjmp(main_at, 1);
}

// Waits until the lanes of this lane's group (kind 0: 16 lanes, 1: the
// warp's 32) have stored their values of its n-th collective: hands the
// thread to a lane of the group that has not stored its value yet, or,
// where each of those sleeps, dozes.
inline void wait_group(Group& g, int kind, unsigned size, long n) {
    Lane& me = *self;
    const unsigned base = me.tid - me.tid % size;
    bool sleeping = false;
    for (unsigned k = 1; k < size; ++k) {
        Lane& o = cur->lanes[base + (me.tid % size + k) % size];
        if (o.done || o.waits || o.n[kind] >= n) continue;
        if (o.sleeps) {
            sleeping = true;
            continue;
        }
        if (++g.idle > 64 * static_cast<long>(size))
            fail("a group cannot progress");
        if (_setjmp(me.at) == 0) resume(o);
        return;  // resumed: resume() set self, cur and the indices
    }
    if (!sleeping) fail("a group waits on lanes that returned");
    doze();
}

// Stores x as this lane's value of its group's next collective (kind op)
// and returns the group's values once all are stored: the 16-lane
// group's (a mask of its 16 lanes) or the warp's (the full mask).
inline const uint32_t* exchange(unsigned mask, uint32_t x, int op) {
    const unsigned t = threadIdx.x;
    const int kind = mask == 0xffffffffu ? 1 : 0;
    const unsigned size = kind ? 32u : 16u;
    if (!kind && mask != 0xffffu << (t & 16u))
        fail("a collective without its group's or its warp's mask");
    Lane& me = *self;
    Group& g = cur->groups[kind][t / size];
    const int b = me.n[kind] & 1;
    if (g.arrived == static_cast<long>(size) * me.n[kind]) g.op[b] = op;
    else if (g.op[b] != op) fail("lanes of a group in different collectives");
    g.slot[b][t % size] = x;
    ++g.arrived;
    ++me.n[kind];
    g.idle = 0;
    while (g.arrived < static_cast<long>(size) * me.n[kind])
        wait_group(g, kind, size, me.n[kind]);
    return g.slot[b];
}

// __syncthreads: the lane waits until the launch's loop releases it.
inline void barrier() {
    Lane& me = *self;
    me.waits = true;
    if (_setjmp(me.at) == 0) _longjmp(main_at, 1);
}

inline void start_block(unsigned id, unsigned block, size_t shared) {
    size_t slot = 0;
    while (slot < stack_used.size() && stack_used[slot]) ++slot;
    if (slot == stack_used.size()) stack_used.push_back(false);
    stack_used[slot] = true;
    while (stacks.size() < (slot + 1) * block)
        stacks.emplace_back(new char[STACK_BYTES]);
    std::unique_ptr<Block> B(new Block);
    B->id = id;
    B->stack0 = slot * block;
    B->lanes.assign(block, Lane{});
    B->groups[0].assign((block + 15) / 16, Group{});
    B->groups[1].assign((block + 31) / 32, Group{});
    B->shared.assign(shared, 0xa5);
    for (unsigned t = 0; t < block; ++t) {
        Lane& l = B->lanes[t];
        l.block = B.get();
        l.tid = t, l.n[0] = l.n[1] = 0;
        l.started = l.done = l.waits = l.sleeps = false;
        getcontext(&l.start);
        l.start.uc_stack.ss_sp = stacks[B->stack0 + t].get();
        l.start.uc_stack.ss_size = STACK_BYTES;
        l.start.uc_link = nullptr;
        makecontext(&l.start, entry, 0);
    }
    running.push_back(std::move(B));
}

// The grid's blocks one after another until a lane sleeps (__nanosleep:
// it waits on another block); from then on every block at once, each
// sleeping lane resumed once a sweep over the blocks' lanes.
inline void run(unsigned grid, unsigned block, size_t shared,
                std::function<void()> fn) {
    body = std::move(fn);
    gridDim.x = grid;
    running.clear();
    stack_used.assign(stack_used.size(), false);
    spread = false;
    sleeps = 0;
    unsigned next = 0;
    if (grid > 0) start_block(next++, block, shared);
    while (!running.empty() && !error) {
        while (spread && next < grid) start_block(next++, block, shared);
        for (size_t r = 0; r < running.size() && !error; ++r) {
            Block& B = *running[r];
            for (unsigned t = 0; t < block && !error; ++t) {
                Lane& l = B.lanes[t];
                while (!l.done && !l.waits && !error) {
                    slept = false;
                    if (_setjmp(main_at) == 0) resume(l);
                    if (slept) break;
                }
            }
        }
        // release the blocks whose threads all wait at __syncthreads;
        // retire the finished ones
        for (size_t r = 0; r < running.size() && !error;) {
            Block& B = *running[r];
            unsigned waiting = 0, done = 0;
            for (const Lane& l : B.lanes) waiting += l.waits, done += l.done;
            if (done == block) {
                stack_used[B.stack0 / block] = false;
                running.erase(running.begin() + r);
                if (!spread && next < grid) start_block(next++, block, shared);
                continue;
            }
            if (waiting > 0 && waiting + done == block) {
                if (done > 0) {
                    std::fprintf(stderr, "cuda shim: __syncthreads waits on "
                                 "threads that returned (block %u)\n", B.id);
                    error = cudaErrorLaunchFailure;
                    break;
                }
                for (Lane& l : B.lanes) l.waits = false;
            }
            ++r;
        }
    }
    running.clear();
}
}  // namespace shim

inline int cudaGetLastError() { const int e = shim::error; shim::error = 0; return e; }
inline void __trap() { shim::fail("__trap"); }
inline void __syncthreads() { shim::barrier(); }
inline void __syncwarp(unsigned mask) { shim::exchange(mask, 0, 0); }
inline void __threadfence() {}
inline void __nanosleep(unsigned) { shim::doze(); }
inline unsigned __ballot_sync(unsigned mask, int p) {
    const uint32_t* v = shim::exchange(mask, p != 0, 1);
    if (mask == 0xffffffffu) {
        unsigned r = 0;
        for (int k = 0; k < 32; ++k) r |= (v[k] ? 1u : 0u) << k;
        return r;
    }
    unsigned r = 0;
    for (int k = 0; k < 16; ++k) r |= (v[k] ? 1u : 0u) << k;
    return r << (threadIdx.x & 16u);
}
inline int shim_lanes(unsigned mask) { return mask == 0xffffffffu ? 32 : 16; }
inline unsigned __reduce_min_sync(unsigned mask, unsigned x) {
    const uint32_t* v = shim::exchange(mask, x, 2);
    unsigned r = v[0];
    for (int k = 1; k < shim_lanes(mask); ++k) r = v[k] < r ? v[k] : r;
    return r;
}
inline int __reduce_max_sync(unsigned mask, int x) {
    const uint32_t* v = shim::exchange(mask, static_cast<uint32_t>(x), 6);
    int r = static_cast<int>(v[0]);
    for (int k = 1; k < shim_lanes(mask); ++k)
        r = static_cast<int>(v[k]) > r ? static_cast<int>(v[k]) : r;
    return r;
}
inline unsigned __match_any_sync(unsigned mask, int key) {
    const uint32_t* v = shim::exchange(mask, static_cast<uint32_t>(key), 5);
    unsigned r = 0;
    for (int k = 0; k < shim_lanes(mask); ++k)
        r |= (v[k] == static_cast<uint32_t>(key) ? 1u : 0u) << k;
    return mask == 0xffffffffu ? r : r << (threadIdx.x & 16u);
}
template <class T>
inline T __shfl_sync(unsigned mask, T x, int src, int width = 32) {
    static_assert(sizeof(T) == 4, "32-bit values");
    if (width != shim_lanes(mask))
        shim::fail("a shuffle wider or narrower than its mask's group");
    uint32_t u;
    std::memcpy(&u, &x, 4);
    const uint32_t* v = shim::exchange(mask, u, 3);
    std::memcpy(&x, &v[src & (width - 1)], 4);
    return x;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T x, int lane_mask, int width = 32) {
    static_assert(sizeof(T) == 4, "32-bit values");
    if (width != shim_lanes(mask))
        shim::fail("a shuffle wider or narrower than its mask's group");
    uint32_t u;
    std::memcpy(&u, &x, 4);
    const uint32_t* v = shim::exchange(mask, u, 4);
    std::memcpy(&x, &v[(threadIdx.x ^ lane_mask) & (width - 1)], 4);
    return x;
}
#define HOST_LAUNCH(grid, block, shared, kernel, ...) \
    shim::run((grid), (block), (shared), [&] { kernel(__VA_ARGS__); })
"""

_LAUNCH = re.compile(
    r"([\w:]+(?:<\w+>)?)<<<([^,<>]+), ([^,<>]+), ([^,<>]+), "
    r"static_cast<cudaStream_t>\(stream\)>>>\(")
_DYNAMIC_SHARED = re.compile(r"extern __shared__ ([\w ]+?) (\w+)\[\];")


def host_compiler():
    """The host C++ compiler's path ($CXX or c++), or None."""
    return shutil.which(os.environ.get("CXX", "c++"))


def build_host(src, out_dir, name, launches):
    """Compile the CUDA source `src` for the CPU against CUDA_SHIM, in
    `out_dir`, as lib<name>.so, and load it. `launches` is the number of
    launch lines the source must have; raises if it has another number,
    or if there is no compiler or it fails. Returns the ctypes library
    (the caller sets each entry point's argtypes)."""
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler")
    with open(src) as f:
        text, n = _LAUNCH.subn(r"HOST_LAUNCH(\2, \3, \4, \1, ", f.read())
    text = _DYNAMIC_SHARED.sub(
        r"\1* \2 = reinterpret_cast<\1*>(shim::shared_now());", text)
    if n != launches:
        raise RuntimeError(f"{src}: {n} launch lines, want {launches}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as f:
        f.write(CUDA_SHIM)
    with open(os.path.join(out_dir, "cuda_fp16.h"), "w") as f:
        f.write('#pragma once\n#include "cuda_runtime.h"\n')
    cpp = os.path.join(out_dir, f"{name}.cpp")
    with open(cpp, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, f"lib{name}.so")
    # -U_FORTIFY_SOURCE: its _longjmp refuses to jump to another stack
    r = subprocess.run([cxx, "-O2", "-ffp-contract=off", "-U_FORTIFY_SOURCE",
                        "-std=c++17", "-shared", "-fPIC", f"-I{out_dir}",
                        "-o", so, cpp], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {src}:\n{r.stderr}")
    return ctypes.CDLL(so)
