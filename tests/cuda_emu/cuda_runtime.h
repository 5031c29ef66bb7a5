// CPU emulation of the CUDA subset that the port's kernels use, for the
// CPU tests (tests/_cuda_emu.py): the CUDA threads of a cluster are fibers
// on the launching thread, and each runs until it waits at a barrier;
// warp collectives (ballot, any, all, reduce, shuffles) and __syncwarp meet at
// a barrier of the warp's threads, __syncthreads at one of the block's,
// and cluster.sync at one of the cluster's; the blocks of a cluster run
// together, clusters one after another.  A fiber runs until it waits, so
// a shared-memory atomic is a plain update.  It checks a kernel's logic and
// its barrier pairing (a mismatched barrier aborts with a message), not
// its speed, and knows nothing of memory ordering or bank conflicts.
// The cluster's shared-memory primitives of the mesh round
// (mesh_exchange.cuh: a store into a peer CTA's shared memory that
// completes its bytes on the peer's mbarrier, mbarriers with arrival and
// transaction counts, a parity wait) are given here under
// the names that header uses; a parity wait yields the fiber, and aborts
// like a mismatched barrier when every live fiber waits.
#pragma once
#define CUDA_EMU 1
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <vector>

#include <ucontext.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 4,
       cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };

struct dim3 {
    unsigned x = 1, y = 1, z = 1;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes = 0;
    cudaStream_t stream = nullptr;
    cudaLaunchAttribute* attrs = nullptr;
    unsigned numAttrs = 0;
};

namespace emu {
constexpr size_t kSmemOptin = 232448;      // an H100's per-block opt-in
constexpr size_t kStack = 128 << 10;       // each fiber's stack
struct Fiber { ucontext_t ctx; unsigned r, t; bool done; };
// the fibers of one cluster: ``blocked`` counts those waiting at a barrier
// that has not yet released them
struct Sched {
    std::vector<Fiber> fibers;
    ucontext_t main;
    size_t live = 0, blocked = 0;
    void (*body)(void*) = nullptr;
    void* arg = nullptr;
};
inline thread_local Sched* sched;
inline thread_local Fiber* fiber;
inline void deadlock() {
    std::fprintf(stderr, "cuda_emu: every live thread waits at a barrier\n");
    std::abort();
}
inline void yield() { swapcontext(&fiber->ctx, &sched->main); }
struct Barrier {
    size_t expected, arrived = 0;
    unsigned gen = 0;
    explicit Barrier(size_t n) : expected(n) {}
    void arrive_and_wait() {
        const unsigned g = gen;
        if (++arrived == expected) {        // the last to arrive releases all
            sched->blocked -= expected - 1;
            arrived = 0;
            ++gen;
            return;
        }
        if (++sched->blocked == sched->live) deadlock();
        while (gen == g) yield();
    }
};
struct Warp { Barrier* bar; uint64_t slot[32]; int size; };
struct Block { Barrier* bar; std::vector<uint32_t> smem; std::vector<Warp*> warps; };
// an mbarrier: arrivals pending in the current phase (of `expected`), the
// transaction bytes still owed (below 0 while bytes arrive before they are
// expected), the phases completed, and the fibers waiting on this one
struct MBar { unsigned expected = 0, pending = 0; long tx = 0;
              unsigned phases = 0; size_t waiters = 0; };
struct Cluster { Barrier* bar; std::vector<Block*> blocks;
                 std::map<const void*, MBar> mbars; };
inline thread_local Block* block;
inline thread_local Cluster* cluster;
inline thread_local unsigned rank;
inline std::atomic<int> last_error{0};
// warp collectives issued, one count per warp: 0 ballot or any, 1 OR
// reduction, 2 add reduction, 3 shuffle (read and cleared by emu_rounds)
inline std::atomic<long> rounds[4];
// a mesh row's manager rounds by gate (MESH_TALLY: 0 block, 1 drain),
// counted by the row's lead thread (read and cleared by emu_gate_rounds)
inline std::atomic<long> gates[2];
}  // namespace emu
extern "C" __attribute__((visibility("default"), used)) long emu_rounds(int kind) {
    return emu::rounds[kind].exchange(0);
}
extern "C" __attribute__((visibility("default"), used))
long emu_gate_rounds(int kind) {
    return emu::gates[kind].exchange(0);
}
#define MESH_TALLY(kind) (emu::gates[kind]++)
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
inline int lane() { return threadIdx.x & 31; }
inline Warp* warp() { return block->warps[threadIdx.x >> 5]; }
inline void check_mask(unsigned mask) {
    const int n = warp()->size;
    const unsigned all = n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
    if (mask != all) {
        std::fprintf(stderr, "cuda_emu: mask %x on a warp of %d lanes\n", mask, n);
        std::abort();
    }
}
// every lane posts v; returns the warp's values (and its size)
inline int exchange(uint64_t v, uint64_t out[32], int kind) {
    Warp* w = warp();
    if (lane() == 0) rounds[kind]++;
    w->slot[lane()] = v;
    w->bar->arrive_and_wait();
    for (int i = 0; i < w->size; ++i) out[i] = w->slot[i];
    w->bar->arrive_and_wait();
    return w->size;
}
template <class T> T shuffle(unsigned mask, T v, int src) {
    check_mask(mask);
    uint64_t b = 0, all[32];
    std::memcpy(&b, &v, sizeof(T));
    const int n = exchange(b, all, 3);
    const uint64_t r = src >= 0 && src < n ? all[src] : b;
    T o;
    std::memcpy(&o, &r, sizeof(T));
    return o;
}
}  // namespace emu

inline unsigned __ballot_sync(unsigned mask, int p) {
    emu::check_mask(mask);
    uint64_t all[32];
    const int n = emu::exchange(p != 0, all, 0);
    unsigned r = 0;
    for (int i = 0; i < n; ++i) r |= (all[i] ? 1u : 0u) << i;
    return r;
}
inline int __any_sync(unsigned mask, int p) { return __ballot_sync(mask, p) != 0; }
inline int __all_sync(unsigned mask, int p) { return __ballot_sync(mask, p) == mask; }
inline unsigned __reduce_or_sync(unsigned mask, unsigned v) {
    emu::check_mask(mask);
    uint64_t all[32];
    const int n = emu::exchange(v, all, 1);
    unsigned r = 0;
    for (int i = 0; i < n; ++i) r |= (unsigned)all[i];
    return r;
}
inline unsigned __reduce_and_sync(unsigned mask, unsigned v) {
    emu::check_mask(mask);
    uint64_t all[32];
    const int n = emu::exchange(v, all, 1);
    unsigned r = 0xFFFFFFFFu;
    for (int i = 0; i < n; ++i) r &= (unsigned)all[i];
    return r;
}
inline int __reduce_add_sync(unsigned mask, int v) {
    emu::check_mask(mask);
    uint64_t all[32];
    const int n = emu::exchange((uint64_t)(int64_t)v, all, 2);
    int r = 0;
    for (int i = 0; i < n; ++i) r += (int)(int64_t)all[i];
    return r;
}
template <class T> T __shfl_sync(unsigned mask, T v, int src) {
    return emu::shuffle(mask, v, src & 31);
}
template <class T> T __shfl_xor_sync(unsigned mask, T v, int m) {
    return emu::shuffle(mask, v, emu::lane() ^ m);
}
template <class T> T __shfl_up_sync(unsigned mask, T v, int d) {
    const int src = emu::lane() - d;
    return emu::shuffle(mask, v, src < 0 ? emu::lane() : src);
}
template <class T> T __shfl_down_sync(unsigned mask, T v, int d) {
    const int src = emu::lane() + d;
    return emu::shuffle(mask, v, src > 31 ? emu::lane() : src);
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { emu::warp()->bar->arrive_and_wait(); }
inline void __syncthreads() { emu::block->bar->arrive_and_wait(); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
// the fibers of a launch run one at a time, so an atomic is a plain update
template <class T> T atomicAdd(T* p, T v) {
    const T old = *p;
    *p = old + v;
    return old;
}
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline unsigned max(unsigned a, unsigned b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }

inline cudaError_t cudaGetLastError() { return emu::last_error.exchange(0); }
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
    *v = (int)emu::kSmemOptin;
    return 0;
}

namespace emu {
inline void fiber_main() {
    sched->body(sched->arg);
    fiber->done = true;                     // returns to sched->main
}

template <class K, class... A>
void launch(K kernel, dim3 grid, dim3 blk, size_t smem, void*, unsigned csize,
            A... args) {
    const unsigned nb = grid.x, nt = blk.x;
    if (nt == 0 || nt > 1024 || smem > kSmemOptin || csize == 0 || nb % csize) {
        last_error = cudaErrorInvalidConfiguration;
        return;
    }
    auto run = [&] { kernel(args...); };
    const size_t n = (size_t)csize * nt;
    std::unique_ptr<char[]> stacks(new char[n * kStack]);
    for (unsigned c0 = 0; c0 < nb; c0 += csize) {
        Barrier cbar(n);
        Cluster cl{&cbar, {}};
        std::vector<std::unique_ptr<Block>> blocks;
        std::vector<std::unique_ptr<Warp>> warps;
        std::vector<std::unique_ptr<Barrier>> bars;
        for (unsigned r = 0; r < csize; ++r) {
            auto b = std::make_unique<Block>();
            bars.push_back(std::make_unique<Barrier>(nt));
            b->bar = bars.back().get();
            b->smem.assign(smem / 4 + 1, 0xDEADBEEFu);  // garbage, as on a card
            for (unsigned w = 0; w < (nt + 31) / 32; ++w) {
                auto wp = std::make_unique<Warp>();
                wp->size = (int)std::min(32u, nt - w * 32);
                bars.push_back(std::make_unique<Barrier>(wp->size));
                wp->bar = bars.back().get();
                b->warps.push_back(wp.get());
                warps.push_back(std::move(wp));
            }
            cl.blocks.push_back(b.get());
            blocks.push_back(std::move(b));
        }
        Sched s;
        s.body = [](void* f) { (*static_cast<decltype(run)*>(f))(); };
        s.arg = &run;
        s.fibers.resize(n);
        for (size_t i = 0; i < n; ++i) {
            Fiber& f = s.fibers[i];
            f.r = (unsigned)(i / nt);
            f.t = (unsigned)(i % nt);
            f.done = false;
            getcontext(&f.ctx);
            f.ctx.uc_stack.ss_sp = stacks.get() + i * kStack;
            f.ctx.uc_stack.ss_size = kStack;
            f.ctx.uc_link = &s.main;
            makecontext(&f.ctx, fiber_main, 0);
        }
        // round robin: each pass moves every live fiber to its next wait
        s.live = n;
        sched = &s;
        while (s.live) {
            for (Fiber& f : s.fibers) {
                if (f.done) continue;
                ::threadIdx = dim3(f.t);
                ::blockIdx = dim3(c0 + f.r);
                ::blockDim = blk;
                ::gridDim = grid;
                block = cl.blocks[f.r];
                cluster = &cl;
                rank = f.r;
                fiber = &f;
                swapcontext(&s.main, &f.ctx);
                if (f.done && --s.live && s.blocked == s.live) deadlock();
            }
        }
    }
}
}  // namespace emu

#define EMU_SMEM(T) (reinterpret_cast<T*>(emu::block->smem.data()))

// The cluster's shared memory (mesh_exchange.cuh's primitives): an address
// in a peer CTA's shared memory is a pointer there
typedef uintptr_t ClusterAddr;
namespace emu {
inline MBar& mbar(const void* p) {
    auto it = cluster->mbars.find(p);
    if (it == cluster->mbars.end()) {
        std::fprintf(stderr, "cuda_emu: an mbarrier used before its init\n");
        std::abort();
    }
    return it->second;
}
// the phase completes once every arrival is in and every byte delivered;
// its waiters are released, as the last arrival at a Barrier releases them
inline void mbar_settle(MBar& m) {
    if (m.pending != 0 || m.tx != 0) return;
    ++m.phases;
    m.pending = m.expected;
    sched->blocked -= m.waiters;
    m.waiters = 0;
}
inline void mbar_arrive(const void* p) {
    MBar& m = mbar(p);
    if (m.pending == 0) {
        std::fprintf(stderr, "cuda_emu: an arrival past an mbarrier's count\n");
        std::abort();
    }
    --m.pending;
    mbar_settle(m);
}
}  // namespace emu
inline ClusterAddr peer_addr(const void* p, unsigned r) {
    return reinterpret_cast<ClusterAddr>(
        reinterpret_cast<const char*>(emu::cluster->blocks[r]->smem.data()) +
        (reinterpret_cast<const char*>(p) -
         reinterpret_cast<const char*>(emu::block->smem.data())));
}
inline void mbar_init(uint64_t* bar, unsigned arrivals) {
    emu::MBar& m = emu::cluster->mbars[bar];
    m = emu::MBar();
    m.expected = m.pending = arrivals;
}
inline void mbar_init_fence() {}
inline void st_async_peer(ClusterAddr a, uint32_t v, ClusterAddr bar) {
    *reinterpret_cast<uint32_t*>(a) = v;
    emu::MBar& m = emu::mbar(reinterpret_cast<const void*>(bar));
    m.tx -= 4;
    emu::mbar_settle(m);
}
inline void mbar_expect(uint64_t* bar, unsigned bytes) {
    emu::mbar(bar).tx += bytes;
    emu::mbar_arrive(bar);
}
// the phase of parity `parity` completed: the barrier is past it
inline void mbar_wait(uint64_t* bar, unsigned parity) {
    emu::MBar& m = emu::mbar(bar);
    if ((m.phases & 1u) != parity) return;
    const unsigned at = m.phases;           // the phase waited on
    ++m.waiters;
    if (++emu::sched->blocked == emu::sched->live) emu::deadlock();
    while (m.phases == at) emu::yield();
}

template <class... KA, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(KA...),
                               A... args) {
    unsigned cs = 1;
    for (unsigned i = 0; i < cfg->numAttrs; ++i)
        if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
            cs = cfg->attrs[i].val.clusterDim.x;
    emu::launch(k, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, nullptr,
                cs, (KA)args...);
    return cudaGetLastError();
}
