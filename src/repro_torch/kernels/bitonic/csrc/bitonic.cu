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
// and drops them.  Here a block works on one row (or one aligned block of
// a wide row) and the grid covers exactly the B rows given, so no padding
// row exists.
//
// Design:
//   * a row of up to kBlockN = 2^15 words (128 KB) lives in dynamic shared
//     memory; up to 1024 threads each take pairs (i, i | j) of a pass, with
//     __syncthreads() between passes; the whole network is one launch;
//   * a wider row takes the standard split: the first launch sorts its
//     aligned 2^15-word blocks (each ascending or descending as the network
//     orders it), then for each later stage k one global-memory launch per
//     substage j >= 2^15 (the pairs straddle blocks) and one shared-memory
//     launch for the substages j < 2^15 of that stage.
//
// What bounds it on this card: the network makes B * N/2 * n_passes
// compare-exchanges (a min and a max each) against one read and one write
// of the rows.  The int32 rate is 16.7 TOP/s (64 int32 lanes an SM, 132
// SMs, 1.98 GHz boost: Hopper white paper).  At the harness shape (2, 1024)
// that is 112,640 operations (6.7 ns) against 16 KB of traffic (4.9 ns at
// 3.35 TB/s): the operations bound it, as they do at (8, 32768) (1.88 us
// against 0.63 us).  A launch alone costs microseconds, so at (2, 1024)
// the kernel sits far above its bound; warp-shuffle passes for j < 32 and
// rows held in registers are for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockLog = 15;
constexpr int kBlockN = 1 << kBlockLog;     // words of one shared block
constexpr int kMaxThreads = 1024;
constexpr int kGlobalThreads = 256;

__device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b, bool up) {
    const uint32_t lo = min(a, b), hi = max(a, b);
    a = up ? lo : hi;
    b = up ? hi : lo;
}

// Each block loads one aligned block of `blk` words of a row from `in`,
// runs stages k = k_first .. k_last (powers of two) on it, each from
// substage min(k/2, blk/2) down to 1, and stores it to `out`.  Directions
// use the element's index in its row.  `in` may be `out` (a merge reads
// its block whole before it writes any of it).
__global__ void bitonic_shared_kernel(const uint32_t* in, uint32_t* out,
                                      int n, int blk, int k_first,
                                      int k_last) {
    extern __shared__ uint32_t sm[];
    const int per_row = n / blk;
    const size_t row = blockIdx.x / per_row;
    const int base = (blockIdx.x % per_row) * blk;
    const uint32_t* src = in + row * n + base;
    uint32_t* dst = out + row * n + base;
    for (int t = threadIdx.x; t < blk; t += blockDim.x) sm[t] = src[t];
    __syncthreads();
    const int half = blk >> 1;
    for (long long k = k_first; k <= k_last; k <<= 1) {
        for (int j = (int)min(k >> 1, (long long)half); j >= 1; j >>= 1) {
            for (int p = threadIdx.x; p < half; p += blockDim.x) {
                const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
                uint32_t a = sm[i], b = sm[i + j];
                exchange(a, b, ((base + i) & k) == 0);
                sm[i] = a;
                sm[i + j] = b;
            }
            __syncthreads();
        }
    }
    for (int t = threadIdx.x; t < blk; t += blockDim.x) dst[t] = sm[t];
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

int launch_shared(const uint32_t* in, uint32_t* out, int b, int n, int blk,
                  int k_first, int k_last, cudaStream_t stream) {
    const long long blocks = (long long)b * (n / blk);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const int threads = blk >= 2 * kMaxThreads ? kMaxThreads
                        : (blk >= 2 ? blk / 2 : 1);
    const size_t smem = (size_t)blk * sizeof(uint32_t);
    bitonic_shared_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
        in, out, n, blk, k_first, k_last);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest row the kernel takes (power-of-two N up to 2^30).
int bitonic_max_n(void) { return 1 << 30; }

// x (b, n) 32-bit words -> out (b, n) uint32, each row ascending; n a power
// of two.  Returns cudaGetLastError() after each launch and stops at the
// first non-zero (0 on success); launches on `stream` and does not
// synchronise.
int bitonic_sort_launch(const void* x, void* out, int b, int n, void* stream) {
    if (b <= 0 || n <= 0 || (n & (n - 1)) != 0 || n > bitonic_max_n())
        return (int)cudaErrorInvalidValue;
    auto in = static_cast<const uint32_t*>(x);
    auto o = static_cast<uint32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    const int blk = n < kBlockN ? n : kBlockN;
    cudaError_t attr = cudaFuncSetAttribute(
        bitonic_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        blk * (int)sizeof(uint32_t));
    if (attr != cudaSuccess) return (int)attr;
    int err = launch_shared(in, o, b, n, blk, 2, blk, st);
    if (err != 0) return err;
    const long long pairs = (long long)b * (n / 2);
    long long want = (pairs + kGlobalThreads - 1) / kGlobalThreads;
    const unsigned grid = (unsigned)(want < (1LL << 20) ? want : (1LL << 20));
    for (long long k = 2LL * blk; k <= n; k <<= 1) {
        for (long long j = k >> 1; j >= blk; j >>= 1) {
            bitonic_global_kernel<<<grid, kGlobalThreads, 0, st>>>(
                o, pairs, n, (int)j, (int)k);
            err = (int)cudaGetLastError();
            if (err != 0) return err;
        }
        err = launch_shared(o, o, b, n, blk, (int)k, (int)k, st);
        if (err != 0) return err;
    }
    return 0;
}

}  // extern "C"
