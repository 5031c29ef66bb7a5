// Bitonic sorting network for Hopper: ascending rows of 32-bit words.
//
// Replaces the Pallas kernel repro/kernels/bitonic/kernel.py:_bitonic_kernel
// (launched by sort_pallas): log2(N)(log2(N)+1)/2 compare-exchange passes
// over each row, N a power of two.  Stage k doubles the sorted-run length;
// substage j pairs element i (bit j of i clear) with i | j, ascending where
// (i & k) == 0 -- the direction rule of kernel.py:42-43.  The outputs equal
// the Pallas kernel's (and a plain sort's) bit for bit.
//
// The Pallas kernel pads the batch to its 8-row tile with 0xFFFFFFFF rows
// and drops them.  Here the grid covers exactly the B rows given, so no
// padding row exists.
//
// What bounds it on this card: the network makes B * N/2 * n_passes
// compare-exchanges (a min and a max each) against one read and one write
// of the rows.  The int32 rate is 16.7 TOP/s (64 int32 lanes an SM, 132
// SMs, 1.98 GHz boost: Hopper white paper).  At the harness shape (2, 1024)
// that is 112,640 operations (6.7 ns) against 16 KB of traffic (4.9 ns at
// 3.35 TB/s); at (8, 32768) 31.5 M operations (1.88 us) against 2 MB (0.63
// us): the operations bound it.  What held the first design (one block per
// row, every pass through shared memory behind a block barrier) far above
// that was the shared-memory port of one SM per row and a barrier per
// pass.  This design keeps the words in registers and spreads a row over
// the card:
//
//   * each thread holds E = 8 consecutive words of the row (element
//     t*E + r in its register r);
//   * substages with j < E exchange registers of one thread (no barrier,
//     no memory);
//   * substages with E <= j < 32E exchange with lane t ^ (j/E) through
//     __shfl_xor_sync (no barrier);
//   * substages with 32E <= j < the words of one block go through shared
//     memory (a store of the registers, barrier-separated pair passes, a
//     reload); the layout pads one word every 32 (word i at i + i/32), so
//     the register stores and reloads, whose lanes sit E words apart, hit
//     32 different banks;
//   * a row of more than one block's words (kCtaWords = 4096) is split
//     over a thread-block cluster of up to 8 blocks (32768 words, on 8
//     SMs; the portable cluster size): substages with j >= the block's
//     words pair a block with block rank ^ (j / words) of the cluster.  Each block reads its partner's
//     words from distributed shared memory (map_shared_rank) and keeps the
//     min or max side of its own; the two shared buffers alternate, so a
//     substage costs one cluster.sync();
//   * a row wider than one cluster (N > 32768) takes the standard split:
//     the first launch sorts its aligned 32768-word segments (each
//     ascending or descending as the network orders it), then for each
//     later stage k one global-memory launch per substage j >= 32768 and
//     one cluster launch for the substages below it.
//
// A row narrower than E (N in {1, 2, 4}) runs in one thread; its register
// slots past N hold 0xFFFFFFFF and pair only with each other.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kE = 8;                 // words a thread holds
constexpr int kCtaWords = 4096;       // words a block holds
constexpr int kSpan = 1 << 15;        // widest row one cluster sorts
constexpr int kMaxThreads = kCtaWords / kE;
constexpr int kGlobalThreads = 256;

// shared-memory slot of word i: one pad word every 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded(int words) {
    return words + words / 32 + 1;
}

__device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b, bool up) {
    const uint32_t lo = min(a, b), hi = max(a, b);
    a = up ? lo : hi;
    b = up ? hi : lo;
}

// The side of a pair this element keeps: the lower index takes the min of
// an ascending pair, the higher the max.
__device__ __forceinline__ uint32_t keep(uint32_t mine, uint32_t other,
                                         bool lower, bool up) {
    return lower == up ? min(mine, other) : max(mine, other);
}

// Each block holds `blockDim.x * kE` words of a row (all of a row narrower
// than that); `span` words (a power of two, blocks * words) form one
// cluster.  Runs stages k = k_first .. k_last (powers of two), each from
// substage min(k/2, span/2) down to 1, on the aligned span-word segments
// of `in` and stores them to `out`.  Directions use the element's index in
// its row.  `in` may be `out` (each block reads its words before it writes
// any).
__global__ void __launch_bounds__(kMaxThreads)
bitonic_net_kernel(const uint32_t* in, uint32_t* out, int n, int span,
                   int k_first, int k_last) {
    constexpr int E = kE;
    extern __shared__ uint32_t sm[];
    const int t = threadIdx.x;
    const int nt = blockDim.x;
    const int blk = nt * E;                    // words of this block
    const int per_row = n > blk ? n / blk : 1;
    const size_t row = blockIdx.x / per_row;
    const int off = (blockIdx.x % per_row) * blk;   // block's first word
    const int gbase = off + t * E;             // this thread's first word
    const int lane = t & 31;
    const unsigned wmask = nt >= 32 ? kFull : ((1u << nt) - 1u);
    const uint32_t* src = in + row * n + off;
    uint32_t* dst = out + row * n + off;

#pragma unroll
    for (int m = 0; m < E; ++m) {              // coalesced: word t + m*nt
        const int i = t + m * nt;
        sm[pad(i)] = off + i < n ? src[i] : kFull;
    }
    __syncthreads();
    uint32_t v[E];
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = sm[pad(t * E + r)];

    for (long long k = k_first; k <= k_last; k <<= 1) {
        int j = (int)min(k >> 1, (long long)(span >> 1));
        const bool up_hi = (gbase & k) == 0;   // direction when k >= 2E
        if (j >= blk) {
            // pairs straddle blocks: read the partner block's words from
            // distributed shared memory, keep this block's side
            cg::cluster_group cluster = cg::this_cluster();
            const int rank = (int)cluster.block_rank();
            uint32_t* cur = sm;                // buffers sm, sm + padded(blk)
            uint32_t* nxt = sm + padded(blk);
#pragma unroll
            for (int r = 0; r < E; ++r) cur[pad(t * E + r)] = v[r];
            cluster.sync();
            for (; j >= blk; j >>= 1) {
                const int m = j / blk;
                const uint32_t* far = cluster.map_shared_rank(cur, rank ^ m);
                const bool lower = (rank & m) == 0;
#pragma unroll
                for (int r = 0; r < E; ++r)
                    v[r] = keep(v[r], far[pad(t * E + r)], lower, up_hi);
                if ((j >> 1) >= blk) {
                    uint32_t* done = cur;
                    cur = nxt;
                    nxt = done;
#pragma unroll
                    for (int r = 0; r < E; ++r) cur[pad(t * E + r)] = v[r];
                    cluster.sync();
                }
            }
            // no block rewrites (or leaves) its buffers while a partner
            // may still read them
            cluster.sync();
        }
        if (j >= 32 * E) {
            // pairs straddle warps: barrier-separated passes in shared memory
            uint32_t* s = sm;
#pragma unroll
            for (int r = 0; r < E; ++r) s[pad(t * E + r)] = v[r];
            __syncthreads();
            for (; j >= 32 * E; j >>= 1) {
#pragma unroll
                for (int m = 0; m < E / 2; ++m) {  // pair t + m*nt
                    const int p = t + m * nt;
                    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
                    uint32_t a = s[pad(i)], b = s[pad(i + j)];
                    exchange(a, b, ((off + i) & k) == 0);
                    s[pad(i)] = a;
                    s[pad(i + j)] = b;
                }
                __syncthreads();
            }
#pragma unroll
            for (int r = 0; r < E; ++r) v[r] = s[pad(t * E + r)];
        }
        // pairs straddle threads of one warp: shuffles
        for (; j >= E; j >>= 1) {
            const int m = j / E;
            const bool lower = (lane & m) == 0;
#pragma unroll
            for (int r = 0; r < E; ++r)
                v[r] = keep(v[r], __shfl_xor_sync(wmask, v[r], m), lower,
                            up_hi);
        }
        // pairs inside a thread: registers
#pragma unroll
        for (int jj = E >> 1; jj >= 1; jj >>= 1) {
            if (jj > j) continue;
#pragma unroll
            for (int r = 0; r < E; ++r)
                if ((r & jj) == 0)
                    exchange(v[r], v[r | jj], ((gbase + r) & k) == 0);
        }
    }

    // every thread reads only its own slots after the last barrier, so the
    // stores below race with no reader
#pragma unroll
    for (int r = 0; r < E; ++r) sm[pad(t * E + r)] = v[r];
    __syncthreads();
#pragma unroll
    for (int m = 0; m < E; ++m) {
        const int i = t + m * nt;
        if (off + i < n) dst[i] = sm[pad(i)];
    }
}

// One substage (k, j) over every row, in place in global memory.
__global__ void bitonic_global_kernel(uint32_t* __restrict__ x, long long pairs,
                                      int n, int j, int k) {
    const long long half = n >> 1;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         p < pairs; p += stride) {
        const long long row = p / half, q = p % half;
        const long long i = ((q & ~(long long)(j - 1)) << 1) | (q & (j - 1));
        uint32_t* r = x + row * n;
        uint32_t a = r[i], b = r[i + j];
        exchange(a, b, (i & k) == 0);
        r[i] = a;
        r[i + j] = b;
    }
}

// Launch bitonic_net_kernel over b rows of n words: blocks of
// min(n, kCtaWords) words, clusters of up to kSpan words (8 blocks).
int launch_net(const uint32_t* in, uint32_t* out, int b, int n, int k_first,
               int k_last, cudaStream_t stream) {
    const int blk = n < kE ? kE : (n < kCtaWords ? n : kCtaWords);
    const int threads = blk / kE;
    const int row_words = n < kE ? kE : n;
    const int span = row_words < kSpan ? row_words : kSpan;
    const int csize = span / blk;
    const long long blocks = (long long)b * (n > blk ? n / blk : 1);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(csize > 1 ? 2 : 1) * padded(blk) *
                        sizeof(uint32_t);
    if (csize == 1) {
        bitonic_net_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
            in, out, n, span, k_first, k_last);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, bitonic_net_kernel, in, out, n,
                                         span, k_first, k_last);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

bool bad_args(int b, int n) {
    return b <= 0 || n <= 0 || (n & (n - 1)) != 0 || n > (1 << 30);
}

}  // namespace

extern "C" {

// Widest row the kernel takes (power-of-two N up to 2^30).
int bitonic_max_n(void) { return 1 << 30; }

// x (b, n) 32-bit words -> out (b, n) uint32, each row ascending; n a power
// of two.  The first launch sorts each row's aligned 32768-word segments;
// each later stage k takes one global-memory launch per substage
// j >= 32768 and one cluster launch for the rest.  Returns
// cudaGetLastError() after each launch and stops at the first non-zero (0
// on success); launches on `stream` and does not synchronise.
int bitonic_sort_launch(const void* x, void* out, int b, int n, void* stream) {
    if (bad_args(b, n)) return (int)cudaErrorInvalidValue;
    auto in = static_cast<const uint32_t*>(x);
    auto o = static_cast<uint32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    const int span = n < kSpan ? n : kSpan;
    int err = launch_net(in, o, b, n, 2, span < 2 ? 2 : span, st);
    if (err != 0) return err;
    const long long pairs = (long long)b * (n / 2);
    long long want = (pairs + kGlobalThreads - 1) / kGlobalThreads;
    const unsigned grid = (unsigned)(want < (1LL << 20) ? want : (1LL << 20));
    for (long long k = 2LL * kSpan; k <= n; k <<= 1) {
        for (long long j = k >> 1; j >= kSpan; j >>= 1) {
            bitonic_global_kernel<<<grid, kGlobalThreads, 0, st>>>(
                o, pairs, n, (int)j, (int)k);
            err = (int)cudaGetLastError();
            if (err != 0) return err;
        }
        err = launch_net(o, o, b, n, (int)k, (int)k, st);
        if (err != 0) return err;
    }
    return 0;
}

}  // extern "C"
