// Bit-plane radix top-k threshold descent with plane skip, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/radix_topk/kernel.py:
// _threshold_kernel (launched by threshold_pallas).  Per row it returns the
// sortable-uint32 value of the k-th largest element; per TB=8-row tile it
// returns the number of planes visited.  One block runs one tile, so the
// tile-level s_top and `visited` of the Pallas kernel (:53-60, :84) come
// out identical: the leading planes that are uniform in every row of the
// tile are certified by one OR/AND pass and skipped, and each row's prefix
// above s_top is pre-loaded from its AND register (:63-66).
//
// What bounds it on this card: bytes.  The work is one read of the B*N
// 32-bit inputs (plus 8 bytes written per row), so the least time is
// B*N*4 bytes at 3.35 TB/s.  The descent re-reads the row once per
// visited plane; a row of at most 16384 words (64 KB; an 8-row tile is
// 512 KB) stays in the 50 MB L2 between passes, so only the first pass
// reaches device memory.  The design:
//
//   * one warp per row (8 warps per block), lanes striding the row so
//     every load is coalesced;
//   * pass 1 reduces OR and AND per row with warp shuffles; the block ORs
//     the rows' mixed planes through shared memory to get s_top;
//   * each visited plane is one more pass that counts the candidates
//     matching the prefix with the plane's bit set (warp sum), and the
//     warp-uniform prefix/need registers take the verdict;
//   * rows past B in a ragged last tile count as constant rows (the -inf
//     padding rows of :98-100), which add no mixed planes;
//   * the float32 entry maps each value to the sortable domain in
//     registers (flip all bits of negatives, the sign bit otherwise).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTileRows = 8;

template <bool kFloatIn>
__device__ __forceinline__ uint32_t sortable(uint32_t v) {
    if (kFloatIn) return v ^ ((v >> 31) ? 0xFFFFFFFFu : 0x80000000u);
    return v;
}

template <bool kFloatIn>
__global__ void __launch_bounds__(32 * kTileRows)
radix_threshold_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ thresh,
                       int32_t* __restrict__ visited, int b, int n, int k) {
    __shared__ uint32_t s_mixed[kTileRows];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kTileRows + warp;
    const bool real = row < b;                 // warp-uniform
    const uint32_t* xr = x + (size_t)row * n;

    // pass 1: OR / AND per row -> the row's mixed planes
    uint32_t v_or = 0u, v_and = kFull;
    if (real) {
        for (int j = lane; j < n; j += 32) {
            const uint32_t v = sortable<kFloatIn>(xr[j]);
            v_or |= v;
            v_and &= v;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        v_or |= __shfl_xor_sync(kFull, v_or, o);
        v_and &= __shfl_xor_sync(kFull, v_and, o);
    }
    if (lane == 0) s_mixed[warp] = real ? (v_or ^ v_and) : 0u;
    __syncthreads();
    uint32_t tile_mixed = 0u;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) tile_mixed |= s_mixed[r];
    const int s_top = tile_mixed ? 31 - __clz(tile_mixed) : -1;
    if (!real) return;

    // prefix pre-load: the bits above s_top are uniform in every row
    const uint32_t hi0 = s_top >= 31 ? 0u
                       : (s_top < 0 ? kFull : ~((2u << s_top) - 1u));
    uint32_t prefix = v_and & hi0;
    int need = k;
    for (int plane = s_top; plane >= 0; --plane) {
        const uint32_t bit = 1u << plane;
        const uint32_t hi_mask = ~((bit << 1) - 1u);   // 0 at plane 31
        int c1 = 0;
        for (int j = lane; j < n; j += 32) {
            const uint32_t v = sortable<kFloatIn>(xr[j]);
            c1 += ((v & hi_mask) == prefix) && (v & bit);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) c1 += __shfl_xor_sync(kFull, c1, o);
        if (c1 >= need) prefix |= bit;
        else need -= c1;
    }
    if (lane == 0) {
        thresh[row] = prefix;
        visited[row] = s_top + 1;
    }
}

}  // namespace

extern "C" {

int radix_tile_rows(void) { return kTileRows; }

// x (b, n) float32 (float_in=1) or sortable uint32 (float_in=0) ->
// thresh (b,) uint32, visited (b,) int32.  Returns cudaGetLastError() after
// the launch (0 on success); launches on `stream` and does not synchronise.
int radix_threshold_launch(const void* x, void* thresh, void* visited, int b,
                           int n, int k, int float_in, void* stream) {
    if (b <= 0 || n <= 0 || k < 1 || k > n) return (int)cudaErrorInvalidValue;
    const int tiles = (b + kTileRows - 1) / kTileRows;
    auto xs = static_cast<const uint32_t*>(x);
    auto ts = static_cast<uint32_t*>(thresh);
    auto vs = static_cast<int32_t*>(visited);
    auto st = static_cast<cudaStream_t>(stream);
    if (float_in)
        radix_threshold_kernel<true><<<tiles, 32 * kTileRows, 0, st>>>(xs, ts, vs, b, n, k);
    else
        radix_threshold_kernel<false><<<tiles, 32 * kTileRows, 0, st>>>(xs, ts, vs, b, n, k);
    return (int)cudaGetLastError();
}

}  // extern "C"
