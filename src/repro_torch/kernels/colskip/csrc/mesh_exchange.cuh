// The cross-bank round of the §IV mesh kernels (colskip_mesh.cu) for
// Hopper: the words each warp of each CTA of a thread-block cluster posts
// reach every warp of every CTA, once a round.  Two rounds are built;
// the mesh kernels take kAsyncRound, the chain probe (mesh_chain_kernel)
// times both:
//
//   * kBarrierRound: each warp writes its words into its own CTA's shared
//     memory, a cluster barrier (barrier.cluster.arrive.release /
//     wait.acquire, as cluster.sync()) follows, and lane i < D * W reads
//     warp i % W's words of CTA i / W through DSMEM.  A round is a barrier
//     of every thread of the cluster plus a remote load on the chain.
//   * kAsyncRound (pushed): each CTA keeps its receive slots, two parity
//     buffers of [D senders][W warps][words], and one mbarrier a buffer,
//     initialised to one arrival: the CTA's own, which also expects the
//     round's bytes (arrive.expect_tx).  Lane j < D of a sender warp writes
//     CTA j's slot with st.async, which completes its bytes on CTA j's
//     barrier, so data and signal travel as one remote operation; a
//     receiver waits on its own barrier (try_wait.parity.acquire.cluster)
//     and reads slots that are now local.  Its thread 0 arms a buffer's
//     next round once it has waited on this one.  (A plain DSMEM store
//     followed by a remote mbarrier.arrive.release.cluster was measured
//     too, and was hardly faster than the barrier round: PERF.md.)
//
// Slot reuse (the async round): a sender writes a buffer's round r + 2
// only after its own round r + 1 completed, that is after every warp of
// every CTA pushed round r + 1, which each warp does only after it has read
// round r.  So one buffer a parity suffices, and no barrier phase can run
// ahead of a waiter of the phase before it.  The release of st.async's
// complete_tx and the acquire of the wait order a slot's write before its
// read and its read before the next write.
//
// The PTX lives in the few named functions below.  The CPU emulation
// (tests/cuda_emu/, which defines CUDA_EMU) gives the same functions, and
// mesh_exchange.cuh then takes them from there.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxBanks = 8;       // the portable cluster size
constexpr int kBarrierRound = 0, kAsyncRound = 1;

#ifndef CUDA_EMU
// an address in the shared memory of a CTA of the cluster
using ClusterAddr = uint32_t;

__device__ __forceinline__ uint32_t cta_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
// `p` (in this CTA's shared memory) at the same offset in CTA `rank`'s
__device__ __forceinline__ ClusterAddr peer_addr(const void* p, unsigned rank) {
    uint32_t a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(a) : "r"(cta_addr(p)), "r"(rank));
    return a;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(cta_addr(bar)), "r"(arrivals) : "memory");
}
// the barriers' initialisation, visible to the cluster's next barrier
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// a store into a peer's shared memory that completes its 4 bytes on the
// peer's barrier `bar`
__device__ __forceinline__ void st_async_peer(ClusterAddr a, uint32_t v,
                                              ClusterAddr bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
                 "[%0], %1, [%2];" :: "r"(a), "r"(v), "r"(bar) : "memory");
}
// this thread's arrival on its CTA's barrier, expecting `bytes` more of
// the phase's transactions
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    uint64_t state;
    asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 "
                 "%0, [%1], %2;"
                 : "=l"(state) : "r"(cta_addr(bar)), "r"(bytes) : "memory");
    (void)state;
}
// wait until the phase of parity `parity` of this CTA's barrier completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const uint32_t a = cta_addr(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
            "p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } while (!done);
}
#endif  // CUDA_EMU

// The round between the `banks` CTAs of a cluster, W warps each, S words a
// warp.  Shared memory (kWords words at `smem`): the two barriers (the
// async round), then two parity buffers: the barrier round's [S][W]
// posted words, or the async round's [kMaxBanks][W] receive slots of S
// words.
template <int W, int S, int kMode>
struct MeshExchange {
    static_assert(kMode >= kBarrierRound && kMode <= kAsyncRound, "a round");
    static_assert(kMaxBanks * W <= 32, "a lane reads each bank's warp slot");
    static constexpr int kBuf = kMode == kBarrierRound ? S * W
                                                       : kMaxBanks * W * S;
    static constexpr int kWords = 4 + 2 * kBuf;
    uint32_t* smem;
    int banks, bank, par = 0;
    uint32_t phase = 0u;       // bit p: the parity of buffer p's next phase

    __device__ MeshExchange(uint32_t* s, int nb, int b)
        : smem(s), banks(nb), bank(b) {}
    __device__ __forceinline__ uint64_t* bar(int p) const {
        return reinterpret_cast<uint64_t*>(smem) + p;
    }
    __device__ __forceinline__ uint32_t* buf(int p) const {
        return smem + 4 + p * kBuf;
    }
    __device__ __forceinline__ unsigned bytes() const {
        return (unsigned)(banks * W * S * 4);
    }

    // Before the first round, by every thread of the cluster: the async
    // round's barriers set up and their first two phases armed, and every
    // CTA of the cluster running
    __device__ __forceinline__ void init() {
        if (kMode == kAsyncRound && threadIdx.x == 0) {
            mbar_init(bar(0), 1u);
            mbar_init(bar(1), 1u);
            mbar_expect(bar(0), bytes());
            mbar_expect(bar(1), bytes());
            mbar_init_fence();
        }
        cg::this_cluster().sync();
    }

    // One round: this warp's words `mine` (the same in every lane) reach
    // every warp of the cluster; lane i < banks * W gets in `got` the words
    // of warp i % W of CTA i / W (bank-major), the other lanes zeros.
    __device__ __forceinline__ void round(const uint32_t (&mine)[S],
                                          uint32_t (&got)[S]) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        uint32_t* b = buf(par);
#pragma unroll
        for (int h = 0; h < S; ++h) got[h] = 0u;
        if constexpr (kMode == kBarrierRound) {
            if (lane == 0) {
#pragma unroll
                for (int h = 0; h < S; ++h) b[h * W + warp] = mine[h];
            }
            cg::cluster_group cluster = cg::this_cluster();
            cluster.sync();
            if (lane < banks * W) {
                const uint32_t* remote =
                    cluster.map_shared_rank(b, (unsigned)(lane / W));
#pragma unroll
                for (int h = 0; h < S; ++h) got[h] = remote[h * W + lane % W];
            }
        } else {
            if (lane < banks) {
                uint32_t* slot = b + (bank * W + warp) * S;
                const ClusterAddr to = peer_addr(slot, (unsigned)lane);
                const ClusterAddr at = peer_addr(bar(par), (unsigned)lane);
#pragma unroll
                for (int h = 0; h < S; ++h)
                    st_async_peer(to + 4 * h, mine[h], at);
            }
            mbar_wait(bar(par), (phase >> par) & 1u);
            phase ^= 1u << par;
            if (lane < banks * W) {
                const uint32_t* slot = b + lane * S;
#pragma unroll
                for (int h = 0; h < S; ++h) got[h] = slot[h];
            }
            // the buffer's next round (r + 2): its bytes expected
            if (threadIdx.x == 0) mbar_expect(bar(par), bytes());
        }
        par ^= 1;
    }
};

}  // namespace
