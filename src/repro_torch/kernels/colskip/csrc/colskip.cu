// Column-skipping in-memory sort (paper §III) for Hopper, one warp per row.
//
// Replaces the Pallas kernel repro/kernels/colskip/kernel.py:_sort_kernel
// (launched by sort_pallas) on its lane-packed path (_machine_packed with
// fuse=1).  The outputs are bit-identical to it: per row the ascending
// values and order, the column reads (CRs) and the cycles (CRs + drains).
//
// What bounds it on this card.  Rows are independent in the single-bank
// machine (or_any and drain_counts are identities), but each row is a
// dependency chain: every CR is a warp-wide ballot whose verdict decides
// the next plane's alive mask, and every drain is a warp scan whose count
// decides the next min search.  The least time is therefore latency:
// CRs of the slowest row times one ballot round, plus its drains times
// one scan (at least one dependent warp vote each; vote_chain_kernel
// below measures that round on the card, and chip_smoke.py prices the
// slowest row's cycles with it); the bytes (one read of the tile, one write of values and
// order: 64 KB in, 128 KB out for an 8 x 2048 tile) are negligible at
// 3.35 TB/s.  The design keeps every step of that chain on chip:
//
//   * the row's w bit planes are packed once into shared memory with
//     __ballot_sync (w * ceil(N/32) words: 8 KB at N=2048, 16 KB at
//     N=4096), so a CR is one shared-memory word per lane per 32 columns;
//   * the alive and sorted masks live in registers, WPL words per lane
//     (word i = q*32 + lane is held by `lane` as its q-th word);
//   * any_lane is __ballot_sync, popcount is __popc plus a warp sum, and
//     cumsum_bits is a warp exclusive scan of per-word popcounts plus a
//     masked __popc inside the word;
//   * the k-entry state table keeps its masks in shared memory (each lane
//     touches only its own words, so no barrier is needed) and its
//     significances and valid bits in warp-uniform registers;
//   * drained elements write order[count + rank] = column directly, and the
//     values are gathered from the input after the row finishes.
//
// Exactness notes (line numbers in the Pallas kernel file): fresh rows
// start at s_top (:111, :184); `seen` resets on each traversal; a push
// shifts table entries toward older slots (:144-149); a load takes the
// newest live entry and invalidates the newer ones (:176-179); k=0
// records nothing, with one (always invalid) slot; a row that has drained
// `stop` elements stops counting CRs (:196-203).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 8;        // deepest state table the kernel holds

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += t;
    }
    return v;
}

template <int WPL>
__global__ void __launch_bounds__(32)
colskip_sort_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ vals,
                    int32_t* __restrict__ order, int32_t* __restrict__ crs_out,
                    int32_t* __restrict__ cyc_out, int n, int w, int k, int stop) {
    extern __shared__ uint32_t smem[];
    const int row = blockIdx.x;
    const int lane = threadIdx.x;
    const int nw = (n + 31) >> 5;
    const int kk = k > 0 ? k : 1;
    uint32_t* planes = smem;               // [w][nw]
    uint32_t* tmask = smem + w * nw;       // [kk][nw]
    const uint32_t* xr = x + (size_t)row * n;
    int32_t* ordr = order + (size_t)row * stop;

    // pack the bit planes: lane b of word i holds element 32*i + b
    for (int i = 0; i < nw; ++i) {
        const int j = i * 32 + lane;
        const uint32_t v = j < n ? xr[j] : 0u;
        uint32_t mine = 0;
        for (int s = 0; s < w; ++s) {
            const uint32_t bits = __ballot_sync(kFull, (v >> s) & 1u);
            if (lane == s) mine = bits;
        }
        if (lane < w) planes[lane * nw + i] = mine;
    }
    __syncwarp();

    uint32_t alive[WPL], srt[WPL], vmask[WPL];
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
        const int i = q * 32 + lane;
        const int rem = n - i * 32;        // valid bits of word i
        vmask[q] = i >= nw ? 0u : (rem >= 32 ? kFull : ((1u << rem) - 1u));
        srt[q] = 0u;
    }
    int tsig[kMaxK];
#pragma unroll
    for (int e = 0; e < kMaxK; ++e) tsig[e] = 0;
    uint32_t tvalid = 0u;                  // bit e: table entry e is valid
    const uint32_t kkmask = (kk >= 32) ? kFull : ((1u << kk) - 1u);
    int s_top = w - 1, count = 0, crs = 0, drains = 0;

    while (count < stop) {
        // --- load: the newest live table entry, else a fresh search
        int first = -1;
#pragma unroll
        for (int e = 0; e < kMaxK; ++e) {
            if (e < kk && first < 0 && ((tvalid >> e) & 1u)) {
                uint32_t h = 0u;
#pragma unroll
                for (int q = 0; q < WPL; ++q) {
                    const int i = q * 32 + lane;
                    if (i < nw) h |= tmask[e * nw + i] & ~srt[q] & vmask[q];
                }
                if (__any_sync(kFull, h != 0u)) first = e;
            }
        }
        int start;
        bool fresh;
        if (first >= 0) {
#pragma unroll
            for (int q = 0; q < WPL; ++q) {
                const int i = q * 32 + lane;
                alive[q] = i < nw ? (tmask[first * nw + i] & ~srt[q] & vmask[q]) : 0u;
            }
            start = 0;
#pragma unroll
            for (int e = 0; e < kMaxK; ++e)
                if (e == first) start = tsig[e] - 1;
            tvalid &= ~((1u << first) - 1u);   // drop the newer entries
            fresh = false;
        } else {
#pragma unroll
            for (int q = 0; q < WPL; ++q) alive[q] = ~srt[q] & vmask[q];
            start = s_top;
            tvalid = 0u;
            fresh = true;
        }

        // --- traverse planes start..0, one CR each
        bool seen = false;
        for (int sig = start; sig >= 0; --sig) {
            const uint32_t* col = planes + sig * nw;
            uint32_t t1 = 0u, t0 = 0u;
#pragma unroll
            for (int q = 0; q < WPL; ++q) {
                const int i = q * 32 + lane;
                const uint32_t c = i < nw ? col[i] : 0u;
                t1 |= c & alive[q];
                t0 |= ~c & alive[q];
            }
            const bool p1 = __any_sync(kFull, t1 != 0u);
            const bool p0 = __any_sync(kFull, t0 != 0u);
            if (p1 && p0) {                   // mixed column: exclude the 1s
#pragma unroll
                for (int q = 0; q < WPL; ++q) {
                    const int i = q * 32 + lane;
                    if (i < nw) alive[q] &= ~col[i];
                }
                if (fresh) {
                    if (k > 0) {              // push (sig, alive) as entry 0
#pragma unroll
                        for (int e = kMaxK - 1; e > 0; --e) {
                            if (e < kk) {
                                tsig[e] = tsig[e - 1];
#pragma unroll
                                for (int q = 0; q < WPL; ++q) {
                                    const int i = q * 32 + lane;
                                    if (i < nw) tmask[e * nw + i] = tmask[(e - 1) * nw + i];
                                }
                            }
                        }
                        tsig[0] = sig;
#pragma unroll
                        for (int q = 0; q < WPL; ++q) {
                            const int i = q * 32 + lane;
                            if (i < nw) tmask[i] = alive[q];
                        }
                        tvalid = ((tvalid << 1) | 1u) & kkmask;
                    }
                    if (!seen) {
                        s_top = sig;
                        seen = true;
                    }
                }
            }
        }
        crs += start + 1;                     // start >= -1

        // --- drain the survivors in column order, up to `stop`
        int mine = 0;
#pragma unroll
        for (int q = 0; q < WPL; ++q) mine += __popc(alive[q]);
        const int m_tot = warp_sum(mine);
        const int m_eff = min(m_tot, stop - count);
        if (m_eff <= 0) break;                // unreachable: a search always
                                              // keeps a survivor; never spin
        int base = 0;
#pragma unroll
        for (int q = 0; q < WPL; ++q) {
            const int c = __popc(alive[q]);
            const int incl = warp_inclusive_scan(c, lane);
            int r = base + incl - c;          // rank of this word's first bit
            uint32_t a = alive[q];
            uint32_t kept = 0u;
            while (a != 0u && r < m_eff) {
                const int bpos = __ffs(a) - 1;
                a &= a - 1u;
                ordr[count + r] = (q * 32 + lane) * 32 + bpos;
                kept |= 1u << bpos;
                ++r;
            }
            srt[q] |= kept;
            base += __shfl_sync(kFull, incl, 31);
        }
        count += m_eff;
        drains += max(m_eff - 1, 0);
    }

    __syncwarp();                             // order[] written by all lanes
    uint32_t* vr = vals + (size_t)row * stop;
    for (int t = lane; t < stop; t += 32) vr[t] = xr[ordr[t]];
    if (lane == 0) {
        crs_out[row] = crs;
        cyc_out[row] = crs + drains;
    }
}

template <int WPL>
int launch(const uint32_t* x, uint32_t* vals, int32_t* order, int32_t* crs,
           int32_t* cyc, int b, int n, int w, int k, int stop, size_t smem,
           cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        colskip_sort_kernel<WPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    colskip_sort_kernel<WPL><<<b, 32, smem, stream>>>(x, vals, order, crs, cyc,
                                                      n, w, k, stop);
    return (int)cudaGetLastError();
}

// One warp, `rounds` dependent __any_sync votes: each predicate depends on
// the previous verdict, as a CR's alive mask depends on the last one.  The
// time per round is the latency of one step of a row's chain in the sort
// kernel above; it prices that kernel's bound and is not on the serving
// path.
__global__ void __launch_bounds__(32)
vote_chain_kernel(int32_t* __restrict__ out, uint32_t seed, int rounds) {
    const uint32_t v = seed ^ threadIdx.x;
    int acc = 0;
    for (int r = 0; r < rounds; ++r)
        acc += __any_sync(kFull, ((v >> (r & 31)) ^ (uint32_t)acc) & 1u);
    if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

extern "C" {

// out (1,) int32 <- the count of true votes in a chain of `rounds`
// dependent warp votes (one warp).  Returns cudaGetLastError().
int colskip_vote_chain_launch(void* out, unsigned seed, int rounds,
                              void* stream) {
    if (rounds < 0) return (int)cudaErrorInvalidValue;
    vote_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(out), seed, rounds);
    return (int)cudaGetLastError();
}

// Largest row the kernel takes: 32 words per lane, 1024 words per mask.
int colskip_max_n(void) { return 32 * 32 * 32; }
int colskip_max_k(void) { return kMaxK; }

// x (b, n) uint32 -> vals (b, stop) uint32, order (b, stop) int32,
// crs (b,) int32, cyc (b,) int32.  Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream` and does not synchronise.
int colskip_sort_launch(const void* x, void* vals, void* order, void* crs,
                        void* cyc, int b, int n, int w, int k, int stop,
                        void* stream) {
    if (b <= 0 || n <= 0 || w < 1 || w > 32 || k < 0 || k > kMaxK ||
        stop < 1 || stop > n || n > colskip_max_n())
        return (int)cudaErrorInvalidValue;
    const int nw = (n + 31) / 32;
    const int wpl = (nw + 31) / 32;
    const size_t smem = (size_t)(w + (k > 0 ? k : 1)) * nw * sizeof(uint32_t);
    auto xs = static_cast<const uint32_t*>(x);
    auto vs = static_cast<uint32_t*>(vals);
    auto os = static_cast<int32_t*>(order);
    auto cs = static_cast<int32_t*>(crs);
    auto ys = static_cast<int32_t*>(cyc);
    auto st = static_cast<cudaStream_t>(stream);
    if (wpl <= 1) return launch<1>(xs, vs, os, cs, ys, b, n, w, k, stop, smem, st);
    if (wpl <= 2) return launch<2>(xs, vs, os, cs, ys, b, n, w, k, stop, smem, st);
    if (wpl <= 4) return launch<4>(xs, vs, os, cs, ys, b, n, w, k, stop, smem, st);
    if (wpl <= 8) return launch<8>(xs, vs, os, cs, ys, b, n, w, k, stop, smem, st);
    if (wpl <= 16) return launch<16>(xs, vs, os, cs, ys, b, n, w, k, stop, smem, st);
    return launch<32>(xs, vs, os, cs, ys, b, n, w, k, stop, smem, st);
}

}  // extern "C"
