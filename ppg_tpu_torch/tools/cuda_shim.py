"""What a kernel source of csrc/ needs of CUDA, for a host compiler, so
that the kernels' own code runs on the CPU in the tests.

`build_host(src, out_dir, name, launches)` rewrites the source's launch
lines (`kernel<<<grid, block, shared, static_cast<cudaStream_t>(stream)>>>(`)
as `HOST_LAUNCH(grid, block, shared, kernel, ...)` and its dynamic
shared arrays (`extern __shared__ T name[];`) as pointers to the
launch's `shared` bytes, writes CUDA_SHIM as
cuda_runtime.h beside it and compiles it with the host C++ compiler
without FMA contraction (-ffp-contract=off), so each product and sum is
rounded on its own as the kernels' --fmad=false build rounds it. The
kernel's code runs unchanged: the blocks one after another, the threads
of a block as fibers on one host thread, so a run is deterministic and a
switch wakes no system thread (a fiber starts on its own stack with
makecontext and setcontext; switches are _setjmp / _longjmp, which save
no signal mask, so they make no system call). A collective stores the
lane's value in its 16-lane group's exchange slots (two sets, used in
turn) and hands the thread on to the group's next lane until all 16 have
stored theirs. A collective that names another mask than its group's 16
lanes, lanes of a group in different collectives, or a group that can no
longer progress end the launch with an error, as __trap() does. The
collectives are __syncwarp, __ballot_sync, __reduce_min_sync,
__match_any_sync, __shfl_sync and __shfl_xor_sync, each within a 16-lane
group. __syncthreads hands the thread back to the block's loop, which
releases the block's threads once all of them wait there (a thread that
returned while others wait ends the launch with an error); a block's
dynamic shared memory is filled with 0xa5 bytes before it starts, so a
kernel that reads what it did not write differs from the plain version.
Atomics (32-bit integer add, max and or, 32-bit unsigned add; 64-bit
unsigned add; on global or shared memory alike) are plain read-modify-writes, as one host thread
runs every lane. Math functions
(expf, powf, erff, ...) are the host C library's, and erfinvf, which it
lacks, is ATen's CPU calc_erfinv (exported as shim_erfinvf); the rounded
conversions and
arithmetic intrinsics (__dmul_rn, __double2ll_rn, ...) are the host's
operations under its default rounding to nearest.
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
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
template <class T>
inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) {
    unsigned i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
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
struct Lane {
    ucontext_t start;  // the lane's first entry, on its own stack
    jmp_buf at;        // where it yielded
    unsigned tid;
    long n;
    bool started, done, waits;  // waits: at __syncthreads
};
struct Group { long arrived, idle; int op[2]; uint32_t slot[2][16]; };
constexpr size_t STACK_BYTES = 1 << 16;
static jmp_buf main_at;
static std::vector<Lane> lanes;
static std::vector<Group> groups;
static std::vector<std::unique_ptr<char[]>> stacks;
static Lane* self;
static std::function<void()> body;
static std::vector<unsigned char> shared_bytes;  // the block's dynamic
static int error;

inline void entry() {
    body();
    self->done = true;
    _longjmp(main_at, 1);
}

// Runs lane l from where it yielded, or from its start.
[[noreturn]] inline void resume(Lane& l) {
    self = &l;
    threadIdx.x = l.tid;
    if (l.started) _longjmp(l.at, 1);
    l.started = true;
    setcontext(&l.start);
    std::abort();
}

inline void fail(const char* what) {
    if (!error) std::fprintf(stderr, "cuda shim: %s (thread %u)\n", what,
                             threadIdx.x);
    error = cudaErrorLaunchFailure;
    _longjmp(main_at, 1);  // the lane is never resumed
}

// Hands the host thread to the next lane of this lane's group that has
// not returned.
inline void pass() {
    Lane& me = *self;
    const unsigned base = me.tid & ~15u;
    for (unsigned k = 1; k < 16; ++k) {
        Lane& next = lanes[base + (me.tid + k) % 16];
        if (next.done || next.waits) continue;
        if (_setjmp(me.at) == 0) resume(next);
        return;  // resumed: resume() set self and threadIdx
    }
    fail("a group waits on lanes that returned");
}

// Stores x as this lane's value of its group's next collective (kind op)
// and returns the group's 16 values once all are stored.
inline const uint32_t* exchange(unsigned mask, uint32_t x, int op) {
    const unsigned t = threadIdx.x;
    if (mask != 0xffffu << (t & 16u))
        fail("a collective without its group's mask");
    Lane& me = *self;
    Group& g = groups[t / 16];
    const int b = me.n & 1;
    if (g.arrived == 16 * me.n) g.op[b] = op;
    else if (g.op[b] != op) fail("lanes of a group in different collectives");
    g.slot[b][t % 16] = x;
    ++g.arrived;
    ++me.n;
    for (g.idle = 0; g.arrived < 16 * me.n; pass())
        if (++g.idle > 64) fail("a group cannot progress");
    return g.slot[b];
}

// __syncthreads: the lane waits until the block's loop releases it.
inline void barrier() {
    Lane& me = *self;
    me.waits = true;
    if (_setjmp(me.at) == 0) _longjmp(main_at, 1);
}

inline void run(unsigned grid, unsigned block, size_t shared,
                std::function<void()> fn) {
    body = std::move(fn);
    gridDim.x = grid;
    lanes.assign(block, Lane{});
    while (stacks.size() < block)
        stacks.emplace_back(new char[STACK_BYTES]);
    for (unsigned b = 0; b < grid && !error; ++b) {
        blockIdx.x = b;
        groups.assign(block / 16, Group{});
        shared_bytes.assign(shared, 0xa5);
        for (unsigned t = 0; t < block; ++t) {
            Lane& l = lanes[t];
            l.tid = t, l.n = 0, l.started = l.done = l.waits = false;
            getcontext(&l.start);
            l.start.uc_stack.ss_sp = stacks[t].get();
            l.start.uc_stack.ss_size = STACK_BYTES;
            l.start.uc_link = nullptr;
            makecontext(&l.start, entry, 0);
        }
        // a group's lanes hand the thread on among themselves; a lane that
        // returns, fails or reaches __syncthreads hands it back here, and
        // once every lane waits at __syncthreads all go on
        while (!error) {
            for (unsigned t = 0; t < block && !error; ++t)
                while (!lanes[t].done && !lanes[t].waits && !error)
                    if (_setjmp(main_at) == 0) resume(lanes[t]);
            unsigned waiting = 0;
            for (const Lane& l : lanes) waiting += l.waits;
            if (error || waiting == 0) break;
            if (waiting != block) {
                std::fprintf(stderr, "cuda shim: __syncthreads waits on "
                             "threads that returned (block %u)\n", b);
                error = cudaErrorLaunchFailure;
                break;
            }
            for (Lane& l : lanes) l.waits = false;
        }
    }
}
}  // namespace shim

inline int cudaGetLastError() { const int e = shim::error; shim::error = 0; return e; }
inline void __trap() { shim::fail("__trap"); }
inline void __syncthreads() { shim::barrier(); }
inline void __syncwarp(unsigned mask) { shim::exchange(mask, 0, 0); }
inline unsigned __ballot_sync(unsigned mask, int p) {
    const uint32_t* v = shim::exchange(mask, p != 0, 1);
    unsigned r = 0;
    for (int k = 0; k < 16; ++k) r |= (v[k] ? 1u : 0u) << k;
    return r << (threadIdx.x & 16u);
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned x) {
    const uint32_t* v = shim::exchange(mask, x, 2);
    unsigned r = v[0];
    for (int k = 1; k < 16; ++k) r = v[k] < r ? v[k] : r;
    return r;
}
inline unsigned __match_any_sync(unsigned mask, int key) {
    const uint32_t* v = shim::exchange(mask, static_cast<uint32_t>(key), 5);
    unsigned r = 0;
    for (int k = 0; k < 16; ++k)
        r |= (v[k] == static_cast<uint32_t>(key) ? 1u : 0u) << k;
    return r << (threadIdx.x & 16u);
}
template <class T>
inline T __shfl_sync(unsigned mask, T x, int src, int width) {
    static_assert(sizeof(T) == 4, "32-bit values");
    if (width != 16) shim::fail("a shuffle wider than the group");
    uint32_t u;
    std::memcpy(&u, &x, 4);
    const uint32_t* v = shim::exchange(mask, u, 3);
    std::memcpy(&x, &v[src & 15], 4);
    return x;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T x, int lane_mask, int width) {
    static_assert(sizeof(T) == 4, "32-bit values");
    if (width != 16) shim::fail("a shuffle wider than the group");
    uint32_t u;
    std::memcpy(&u, &x, 4);
    const uint32_t* v = shim::exchange(mask, u, 4);
    std::memcpy(&x, &v[(threadIdx.x ^ lane_mask) & 15], 4);
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
        r"\1* \2 = reinterpret_cast<\1*>(shim::shared_bytes.data());", text)
    if n != launches:
        raise RuntimeError(f"{src}: {n} launch lines, want {launches}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as f:
        f.write(CUDA_SHIM)
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
