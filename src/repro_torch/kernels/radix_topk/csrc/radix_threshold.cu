// Radix top-k threshold descent with plane skip, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/radix_topk/kernel.py:
// _threshold_kernel (launched by threshold_pallas).  Per row it returns the
// sortable-uint32 value of the k-th largest element; per TB=8-row tile it
// returns the number of planes visited, s_top + 1, where s_top is the
// highest plane mixed in some row of the tile (:53-60, :84): the leading
// planes uniform in every row of the tile are certified by one OR/AND pass
// and skipped, and each row's prefix above s_top is pre-loaded from its
// AND (:63-66).  The outputs equal the Pallas kernel's for any descent
// order, because both return the k-th largest value of each row.
//
// What bounds it on this card: bytes.  The work is one read of the B*N
// 32-bit inputs (plus 8 bytes written per row), so the least time is
// B*N*4 bytes at 3.35 TB/s; at serving shapes (an 8 x 4096 tile, 128 KB)
// that is some 40 ns, far below one launch, so a launch is bound by its
// chain of block barriers.  The design shortens the chain:
//
//   * one block of kThreads threads a row, a tile's 8 rows one
//     thread-block cluster of 8 blocks (the portable size) on 8 SMs;
//   * pass 1 reads the row once from device memory into shared memory
//     (rows of at most kSmemN words, 64 KB), mapping float32 inputs to the
//     sortable domain in registers, and reduces OR and AND (one REDUX a
//     warp, one barrier);
//   * the tile's s_top through distributed shared memory: each block posts
//     its row's mixed planes (OR ^ AND; 0 for a block past B, as the -inf
//     padding rows of :98-100) and, after one cluster.sync(), reads the 8
//     words of its cluster;
//   * a digit descent from s_top: kDigit planes a pass (the last pass
//     takes what is left), so ceil((s_top + 1) / kDigit) passes instead
//     of s_top + 1.  A pass builds a shared-memory histogram of the digit
//     over the candidates (the words whose bits above the digit equal the
//     prefix) with shared-memory atomics (a warp whose 32 keys agree adds
//     once), then one warp scans the 2^kDigit bins from the top and picks
//     the digit that holds the need-th largest candidate; two barriers a
//     pass, two histogram buffers alternating;
//   * rows wider than kSmemN words (the sortable entry takes any N) take
//     the same descent streamed: each pass re-reads the row from device
//     memory.
//
// Narrow rows (N <= kNarrowN words: the MoE router's 40 experts, the
// sampler's manager pass over its banks' candidates) take another
// instance.  A block a row leaves most of its 512 threads idle there and
// pays two barriers a digit pass, so the narrow instance gives a row one
// warp and a tile one block of 8 warps:
//
//   * the row lives in registers, kWpl = ceil(N / 32) words a lane (one
//     of a few template sizes), word j = lane + 32 i, so each load of the
//     warp is coalesced; float32 words map to the sortable domain there;
//   * OR and AND by one REDUX each; the tile's s_top through 8 words of
//     shared memory and one __syncthreads(), no cluster (a warp past B
//     posts 0 mixed planes, as the -inf padding rows of :98-100);
//   * the descent from s_top one plane at a time: per-lane candidate
//     counts, one __reduce_add_sync a plane, no histogram and no block
//     barrier;
//   * its top-k entry also does what the reference's radix_topk does
//     around the Pallas call (repro/kernels/radix_topk/ops.py:74, one XLA
//     program there): every word above the threshold T and the first
//     `need` words equal to T by index are selected (a ballot a register
//     word and a popcount over the lower lanes rank the ties), placed in
//     shared memory in index order (compact_topk's slots), ranked under
//     (value desc, index asc) by counting against the k slots, and written
//     with their int32 indices, mapped back from the sortable domain.
//     One launch instead of a threshold launch and some 20 eager ops.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTileRows = 8;           // rows a tile: blocks a cluster
constexpr int kThreads = 512;          // threads a row
constexpr int kWarps = kThreads / 32;
constexpr int kSmemN = 16384;          // widest row held in shared memory
// planes a descent pass: on an H100 digits of 4 took 25 % longer at an
// (8, 4096) tile (PERF.md)
constexpr int kDigit = 8;
constexpr int kBins = 1 << kDigit;
// shared words before the row: two histograms, the warps' OR and AND,
// the pass's verdict (digit, need) and the row's (mixed, AND)
constexpr int kHead = 2 * kBins + 2 * kWarps + 4;
constexpr int kMaxDevices = 64;
// the narrow instance: rows of at most kNarrowN words, a warp a row, a
// tile of kTileRows rows a block
constexpr int kNarrowN = 1024;
constexpr int kNarrowThreads = kTileRows * 32;

template <bool kFloatIn>
__device__ __forceinline__ uint32_t sortable(uint32_t v) {
    if (kFloatIn) return v ^ ((v >> 31) ? 0xFFFFFFFFu : 0x80000000u);
    return v;
}

template <bool kFloatIn>
__device__ __forceinline__ uint32_t unsortable(uint32_t u) {
    if (kFloatIn) return u ^ ((u >> 31) ? 0x80000000u : 0xFFFFFFFFu);
    return u;
}

template <bool kFloatIn, bool kStream>
__global__ void __launch_bounds__(kThreads)
radix_threshold_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ thresh,
                       int32_t* __restrict__ visited, int b, int n, int k) {
    extern __shared__ uint32_t smem[];
    uint32_t* hist = smem;                     // [2][kBins]
    uint32_t* red = hist + 2 * kBins;          // [2][kWarps] OR, AND
    uint32_t* sel = red + 2 * kWarps;          // digit, need, mixed, AND
    uint32_t* srow = smem + kHead;             // [n] (!kStream)
    cg::cluster_group cluster = cg::this_cluster();
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int row = blockIdx.x;
    const bool real = row < b;                 // block-uniform
    const uint32_t* xr = x + (size_t)(real ? row : 0) * n;
    const int iters = (n + kThreads - 1) / kThreads;

    // pass 1: the row into shared memory, OR / AND -> its mixed planes
    uint32_t v_or = 0u, v_and = kFull;
    if (real) {
        for (int j = t; j < n; j += kThreads) {
            const uint32_t v = sortable<kFloatIn>(xr[j]);
            if (!kStream) srow[j] = v;
            v_or |= v;
            v_and &= v;
        }
    }
    for (int i = t; i < kBins; i += kThreads) hist[i] = 0u;
    v_or = __reduce_or_sync(kFull, v_or);
    v_and = __reduce_and_sync(kFull, v_and);
    if (lane == 0) {
        red[warp] = v_or;
        red[kWarps + warp] = v_and;
    }
    __syncthreads();
    if (warp == 0) {
        const uint32_t o = __reduce_or_sync(kFull, lane < kWarps ? red[lane] : 0u);
        const uint32_t a = __reduce_and_sync(kFull,
                                             lane < kWarps ? red[kWarps + lane] : kFull);
        if (lane == 0) {
            sel[2] = real ? (o ^ a) : 0u;
            sel[3] = a;
        }
    }
    // the tile's mixed planes: every block's word, read across the cluster
    cluster.sync();
    const uint32_t m = lane < kTileRows ? *cluster.map_shared_rank(sel + 2, lane) : 0u;
    const uint32_t tile_mixed = __reduce_or_sync(kFull, m);
    const int s_top = tile_mixed ? 31 - __clz(tile_mixed) : -1;

    if (real) {
        // prefix pre-load: the bits above s_top are uniform in every row
        const uint32_t hi0 = s_top >= 31 ? 0u
                           : (s_top < 0 ? kFull : ~((2u << s_top) - 1u));
        uint32_t prefix = sel[3] & hi0;
        uint32_t need = (uint32_t)k;
        int pass = 0;
        for (int hi = s_top; hi >= 0; ++pass) {
            const int d = hi + 1 < kDigit ? hi + 1 : kDigit;
            const int lo = hi + 1 - d;
            const uint32_t above = hi >= 31 ? 0u : ~((2u << hi) - 1u);
            const uint32_t dmask = (1u << d) - 1u;
            uint32_t* h = hist + (pass & 1) * kBins;
            // the histogram of the digit over the candidates
            for (int i = 0; i < iters; ++i) {
                const int j = t + i * kThreads;
                uint32_t key = kFull;          // not a candidate
                if (j < n) {
                    const uint32_t v = kStream ? sortable<kFloatIn>(xr[j]) : srow[j];
                    if (((v ^ prefix) & above) == 0u) key = (v >> lo) & dmask;
                }
                const uint32_t key0 = __shfl_sync(kFull, key, 0);
                if (__all_sync(kFull, key == key0)) {
                    if (lane == 0 && key0 != kFull) atomicAdd(h + key0, 32u);
                } else if (key != kFull) {
                    atomicAdd(h + key, 1u);
                }
            }
            __syncthreads();
            if (warp == 0) {
                // lane l sums bins l * per .. l * per + per - 1; suffix sums
                // over the lanes find the lane, then its bins the digit,
                // that holds the need-th largest candidate
                const int nb = 1 << d;
                const int per = (nb + 31) / 32;
                uint32_t tot = 0u;
                for (int i = 0; i < per; ++i) {
                    const int bin = lane * per + i;
                    if (bin < nb) tot += h[bin];
                }
                uint32_t incl = tot;           // candidates in lanes >= lane
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const uint32_t y = __shfl_down_sync(kFull, incl, o);
                    if (lane + o < 32) incl += y;
                }
                const uint32_t reach = __ballot_sync(kFull, incl >= need);
                if (lane == 31 - __clz(reach)) {
                    uint32_t acc = incl - tot;     // in higher lanes' bins
                    for (int i = per - 1; i >= 0; --i) {
                        const int bin = lane * per + i;
                        if (bin >= nb) continue;
                        if (acc + h[bin] >= need) {
                            sel[0] = (uint32_t)bin;
                            sel[1] = need - acc;
                            break;
                        }
                        acc += h[bin];
                    }
                }
                // the next pass's buffer, read last by the pass before
                uint32_t* hn = hist + ((pass + 1) & 1) * kBins;
                for (int i = lane; i < kBins; i += 32) hn[i] = 0u;
            }
            __syncthreads();
            prefix |= sel[0] << lo;
            need = sel[1];
            hi = lo - 1;
        }
        if (t == 0) {
            thresh[row] = prefix;
            visited[row] = s_top + 1;
        }
    }
    // no block leaves while a partner may still read its mixed word
    cluster.sync();
}

// The narrow instance.  Warp w of block t holds row 8 t + w in registers
// (kWpl words a lane).  Writes thresh and visited where they are not null;
// where vals is not null (the top-k entry) also the row's k largest words
// in (value desc, index asc) order into vals, their indices into idxs,
// with 2 k words of shared memory a warp for the slots.
template <bool kFloatIn, int kWpl>
__global__ void __launch_bounds__(kNarrowThreads)
radix_narrow_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ thresh,
                    int32_t* __restrict__ visited, uint32_t* __restrict__ vals,
                    int32_t* __restrict__ idxs, int b, int n, int k) {
    extern __shared__ uint32_t smem[];
    uint32_t* tile = smem;                     // [kTileRows] mixed planes
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row = blockIdx.x * kTileRows + warp;
    const bool real = row < b;                 // warp-uniform
    const uint32_t* xr = x + (size_t)(real ? row : 0) * n;

    // the row into registers, OR / AND -> its mixed planes
    uint32_t w[kWpl];
    uint32_t v_or = 0u, v_and = kFull;
#pragma unroll
    for (int i = 0; i < kWpl; ++i) {
        w[i] = 0u;
        if (real && lane + 32 * i < n) {
            w[i] = sortable<kFloatIn>(xr[lane + 32 * i]);
            v_or |= w[i];
            v_and &= w[i];
        }
    }
    v_or = __reduce_or_sync(kFull, v_or);
    v_and = __reduce_and_sync(kFull, v_and);
    if (lane == 0) tile[warp] = real ? (v_or ^ v_and) : 0u;
    __syncthreads();                           // the block's only barrier
    if (!real) return;
    uint32_t tile_mixed = 0u;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) tile_mixed |= tile[r];
    const int s_top = tile_mixed ? 31 - __clz(tile_mixed) : -1;

    // prefix pre-load, then one plane a step: the candidates (bits above
    // the plane equal to the prefix) with the plane set, counted by the
    // warp.  A word past N holds 0, which never has the plane set, so the
    // count needs no bounds test and no branch: the words' tests are
    // independent, and the compiler interleaves them
    uint32_t prefix = v_and & (s_top >= 31 ? 0u
                               : (s_top < 0 ? kFull : ~((2u << s_top) - 1u)));
    int need = k;
    for (int p = s_top; p >= 0; --p) {
        const uint32_t want = prefix | (1u << p);
        const uint32_t upto = ~((1u << p) - 1u);   // the plane and above
        int c = 0;
#pragma unroll
        for (int i = 0; i < kWpl; ++i)
            c += ((w[i] ^ want) & upto) == 0u ? 1 : 0;
        c = __reduce_add_sync(kFull, c);
        if (c >= need) prefix = want;
        else need -= c;
    }
    if (lane == 0) {
        if (thresh) thresh[row] = prefix;
        if (visited) visited[row] = s_top + 1;
    }
    if (!vals) return;

    // the selection: every word above T = prefix (k - need of them) and the
    // first `need` words equal to T by index, into slots in index order
    uint32_t* sv = smem + kTileRows + (size_t)warp * 2 * k;   // [k] words
    uint32_t* si = sv + k;                                    // [k] indices
    const unsigned lower = (1u << lane) - 1u;
    int ties = 0, taken = 0;                   // in earlier register words
#pragma unroll
    for (int i = 0; i < kWpl; ++i) {
        if (32 * i >= n) break;
        const bool live = lane + 32 * i < n;
        const bool eq = live && w[i] == prefix;
        const unsigned eqs = __ballot_sync(kFull, eq);
        const bool sel = live && (w[i] > prefix ||
                                  (eq && ties + __popc(eqs & lower) < need));
        const unsigned sels = __ballot_sync(kFull, sel);
        if (sel) {
            const int slot = taken + __popc(sels & lower);
            sv[slot] = w[i];
            si[slot] = (uint32_t)(lane + 32 * i);
        }
        ties += __popc(eqs);
        taken += __popc(sels);
    }
    __syncwarp();
    // a slot's rank: the slots above it in value, and the equal ones
    // before it (lower index); the k ranks are a permutation of 0..k-1
    uint32_t* vr = vals + (size_t)row * k;
    int32_t* ir = idxs + (size_t)row * k;
    for (int s = lane; s < k; s += 32) {
        const uint32_t v = sv[s];
        int rank = 0;
        for (int t = 0; t < k; ++t) {
            const uint32_t o = sv[t];
            rank += (o > v || (o == v && t < s)) ? 1 : 0;
        }
        vr[rank] = unsortable<kFloatIn>(v);
        ir[rank] = (int32_t)si[s];
    }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// `blocks` blocks of `threads`, in clusters of `cluster` blocks (1: none)
template <typename... Args>
int launch_grid(void (*kernel)(Args...), int blocks, int threads, int cluster,
                size_t smem, cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// `tiles` clusters of kTileRows blocks of kThreads threads
template <typename... Args>
int launch_tiles(void (*kernel)(Args...), int tiles, size_t smem,
                 cudaStream_t stream, Args... args) {
    return launch_grid(kernel, tiles * kTileRows, kThreads, kTileRows, smem,
                       stream, args...);
}

// Lets `kernel` take `bytes` of dynamic shared memory, once per device
// (past 48 KB it needs the opt-in); `done` is the kernel's own flags.
template <typename K>
int opt_in(K kernel, int bytes, std::atomic<bool>* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const bool keep = dev >= 0 && dev < kMaxDevices;
    if (keep && done[dev].load(std::memory_order_acquire)) return 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    if (keep) done[dev].store(true, std::memory_order_release);
    return 0;
}

template <bool kFloatIn, bool kStream>
int launch(const uint32_t* x, uint32_t* thresh, int32_t* visited, int b,
           int n, int k, cudaStream_t stream) {
    auto kernel = radix_threshold_kernel<kFloatIn, kStream>;
    const size_t smem = (size_t)(kHead + (kStream ? 0 : n)) * sizeof(uint32_t);
    if (!kStream) {
        static std::atomic<bool> done[kMaxDevices];
        const int err = opt_in(kernel, (int)((kHead + kSmemN) * sizeof(uint32_t)),
                               done);
        if (err) return err;
    }
    const int tiles = (b + kTileRows - 1) / kTileRows;
    return launch_tiles(kernel, tiles, smem, stream, x, thresh, visited, b, n,
                        k);
}

template <bool kFloatIn, int kWpl>
int launch_narrow_wpl(const uint32_t* x, uint32_t* thresh, int32_t* visited,
                      uint32_t* vals, int32_t* idxs, int b, int n, int k,
                      cudaStream_t stream) {
    auto kernel = radix_narrow_kernel<kFloatIn, kWpl>;
    // the tile's words, and 2 k slot words a warp for the top-k entry (past
    // 48 KB only at k > 767)
    const size_t smem = (size_t)(kTileRows + (vals ? 2 * kTileRows * k : 0)) *
                        sizeof(uint32_t);
    static std::atomic<bool> done[kMaxDevices];
    const int err = opt_in(
        kernel, (int)((kTileRows + 2 * kTileRows * kNarrowN) * sizeof(uint32_t)),
        done);
    if (err) return err;
    const int tiles = (b + kTileRows - 1) / kTileRows;
    return launch_grid(kernel, tiles, kNarrowThreads, 1, smem, stream, x,
                       thresh, visited, vals, idxs, b, n, k);
}

// kWpl: the least of 2, 4, 8, 32 that holds the row
template <bool kFloatIn>
int launch_narrow(const uint32_t* x, uint32_t* thresh, int32_t* visited,
                  uint32_t* vals, int32_t* idxs, int b, int n, int k,
                  cudaStream_t stream) {
    const int wpl = (n + 31) / 32;
    if (wpl <= 2)
        return launch_narrow_wpl<kFloatIn, 2>(x, thresh, visited, vals, idxs,
                                              b, n, k, stream);
    if (wpl <= 4)
        return launch_narrow_wpl<kFloatIn, 4>(x, thresh, visited, vals, idxs,
                                              b, n, k, stream);
    if (wpl <= 8)
        return launch_narrow_wpl<kFloatIn, 8>(x, thresh, visited, vals, idxs,
                                              b, n, k, stream);
    return launch_narrow_wpl<kFloatIn, 32>(x, thresh, visited, vals, idxs, b,
                                           n, k, stream);
}

}  // namespace

extern "C" {

int radix_tile_rows(void) { return kTileRows; }
int radix_digit_bits(void) { return kDigit; }
int radix_smem_n(void) { return kSmemN; }
int radix_narrow_n(void) { return kNarrowN; }

// x (b, n) float32 (float_in=1, n <= radix_smem_n()) or sortable uint32
// (float_in=0, any n) -> thresh (b,) uint32, visited (b,) int32.  Rows of
// at most radix_narrow_n() words take the narrow instance (a warp a row),
// wider ones a block a row, streamed past radix_smem_n().  Returns
// cudaGetLastError() after the launch (0 on success); launches on
// `stream` and does not synchronise.
int radix_threshold_launch(const void* x, void* thresh, void* visited, int b,
                           int n, int k, int float_in, void* stream) {
    if (b <= 0 || n <= 0 || k < 1 || k > n || (float_in && n > kSmemN) ||
        b > 0x7FFFFFFF - kTileRows)
        return (int)cudaErrorInvalidValue;
    auto xs = static_cast<const uint32_t*>(x);
    auto ts = static_cast<uint32_t*>(thresh);
    auto vs = static_cast<int32_t*>(visited);
    auto st = static_cast<cudaStream_t>(stream);
    if (n <= kNarrowN) {
        if (float_in)
            return launch_narrow<true>(xs, ts, vs, nullptr, nullptr, b, n, k, st);
        return launch_narrow<false>(xs, ts, vs, nullptr, nullptr, b, n, k, st);
    }
    if (float_in) return launch<true, false>(xs, ts, vs, b, n, k, st);
    if (n > kSmemN) return launch<false, true>(xs, ts, vs, b, n, k, st);
    return launch<false, false>(xs, ts, vs, b, n, k, st);
}

// x (b, n <= radix_narrow_n()) float32 (float_in=1) or sortable uint32
// (float_in=0) -> vals (b, k) of x's type and idxs (b, k) int32: each
// row's k largest, ordered (value desc, index asc), the lowest indices
// taken among ties at the k-th value (lax.top_k's rule).  One launch of
// the narrow instance; returns cudaGetLastError() as above.
int radix_topk_launch(const void* x, void* vals, void* idxs, int b, int n,
                      int k, int float_in, void* stream) {
    if (b <= 0 || n <= 0 || n > kNarrowN || k < 1 || k > n ||
        b > 0x7FFFFFFF - kTileRows)
        return (int)cudaErrorInvalidValue;
    auto xs = static_cast<const uint32_t*>(x);
    auto vs = static_cast<uint32_t*>(vals);
    auto is = static_cast<int32_t*>(idxs);
    auto st = static_cast<cudaStream_t>(stream);
    if (float_in)
        return launch_narrow<true>(xs, nullptr, nullptr, vs, is, b, n, k, st);
    return launch_narrow<false>(xs, nullptr, nullptr, vs, is, b, n, k, st);
}

// An empty kernel launched as one tile is (a cluster of kTileRows blocks
// of kThreads): its time, taken as the kernel's is, is the card's launch
// floor for this launch.  Returns cudaGetLastError().
int radix_empty_launch(void* stream) {
    return launch_tiles(empty_kernel, 1, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
