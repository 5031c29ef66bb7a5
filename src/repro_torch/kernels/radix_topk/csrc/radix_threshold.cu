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

template <bool kFloatIn>
__device__ __forceinline__ uint32_t sortable(uint32_t v) {
    if (kFloatIn) return v ^ ((v >> 31) ? 0xFFFFFFFFu : 0x80000000u);
    return v;
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

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// `tiles` clusters of kTileRows blocks of kThreads threads
template <typename... Args>
int launch_tiles(void (*kernel)(Args...), int tiles, size_t smem,
                 cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * kTileRows));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kTileRows;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <bool kFloatIn, bool kStream>
int launch(const uint32_t* x, uint32_t* thresh, int32_t* visited, int b,
           int n, int k, cudaStream_t stream) {
    auto kernel = radix_threshold_kernel<kFloatIn, kStream>;
    const size_t smem = (size_t)(kHead + (kStream ? 0 : n)) * sizeof(uint32_t);
    if (!kStream) {
        // rows past 48 KB need the opt-in, once per device
        static std::atomic<bool> done[kMaxDevices];
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return (int)err;
        const bool keep = dev >= 0 && dev < kMaxDevices;
        if (!keep || !done[dev].load(std::memory_order_acquire)) {
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)((kHead + kSmemN) * sizeof(uint32_t)));
            if (err != cudaSuccess) return (int)err;
            if (keep) done[dev].store(true, std::memory_order_release);
        }
    }
    const int tiles = (b + kTileRows - 1) / kTileRows;
    return launch_tiles(kernel, tiles, smem, stream, x, thresh, visited, b, n,
                        k);
}

}  // namespace

extern "C" {

int radix_tile_rows(void) { return kTileRows; }
int radix_digit_bits(void) { return kDigit; }
int radix_smem_n(void) { return kSmemN; }

// x (b, n) float32 (float_in=1, n <= radix_smem_n()) or sortable uint32
// (float_in=0, any n; rows wider than radix_smem_n() stream) -> thresh (b,)
// uint32, visited (b,) int32.  Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream` and does not synchronise.
int radix_threshold_launch(const void* x, void* thresh, void* visited, int b,
                           int n, int k, int float_in, void* stream) {
    if (b <= 0 || n <= 0 || k < 1 || k > n || (float_in && n > kSmemN) ||
        b > 0x7FFFFFFF - kTileRows)
        return (int)cudaErrorInvalidValue;
    auto xs = static_cast<const uint32_t*>(x);
    auto ts = static_cast<uint32_t*>(thresh);
    auto vs = static_cast<int32_t*>(visited);
    auto st = static_cast<cudaStream_t>(stream);
    if (float_in) return launch<true, false>(xs, ts, vs, b, n, k, st);
    if (n > kSmemN) return launch<false, true>(xs, ts, vs, b, n, k, st);
    return launch<false, false>(xs, ts, vs, b, n, k, st);
}

// An empty kernel launched as one tile is (a cluster of kTileRows blocks
// of kThreads): its time, taken as the kernel's is, is the card's launch
// floor for this launch.  Returns cudaGetLastError().
int radix_empty_launch(void* stream) {
    return launch_tiles(empty_kernel, 1, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
