// Column-skipping in-memory sort (paper §III) for Hopper, one warp per row.
//
// Replaces the Pallas kernel repro/kernels/colskip/kernel.py:_sort_kernel
// (launched by sort_pallas) on its lane-packed path (_machine_packed).
// The outputs are bit-identical to it for any `fuse`: per row the
// ascending values and order, the column reads (CRs) and the cycles (CRs
// + drains).
//
// What bounds it on this card.  Rows are independent in the single-bank
// machine (or_any and drain_counts are identities), but each row is a
// dependency chain: a min search cannot start before the drain of the
// last one has marked its survivors sorted, and that drain cannot start
// before the search's last verdict.  However many planes one round
// resolves, a row costs at least one dependent warp round per min search,
// and with stop = N a row makes one search per distinct value.  The least
// time is therefore the slowest row's searches times one dependent warp
// round (vote_chain_kernel and redux_chain_kernel below time that round;
// chip_smoke.py prices the bound with it, and prints the older unfused
// chain, CRs + drains rounds, beside it).  The bytes (one read of the
// tile, one write of values and order: 64 KB in, 128 KB out for an
// 8 x 2048 tile) are negligible at 3.35 TB/s.  The design shortens the
// chain:
//
//   * speculative plane fusion, as _traverse_planes (kernel.py:92-160)
//     does it: planes are walked in blocks of kFuse, aligned at multiples
//     of kFuse (planes bF + F - 1 .. bF; a plane above the search's start
//     is inactive), one warp round a block.  Each lane sets bit p of a
//     2^F-bit set (pat_words(F) words) when one of its alive elements
//     shows the F-bit pattern p on the block's planes; one
//     __reduce_or_sync a word gives the warp's
//     patterns, and the verdicts resolve in registers plane by plane: a
//     plane is mixed when the patterns still alive show both of its bits,
//     and then keeps those with a 0.  This is the reference's speculation
//     (a saw-a-1 and a saw-a-0 bit for each plane under each hypothesis of
//     the earlier planes' verdicts) in 2^F bits instead of 2 (2^F - 1).
//     kFuse = 2 (COLSKIP_FUSE at build time, 1 to 8).  On an H100 it
//     beat F = 4 on distinct 32-bit rows, the serving traffic, and lost to
//     it on duplicate-heavy ones (PERF.md, scripts/colskip_fuse.py);
//   * a walk stops at a lone alive element: its alive count rides in the
//     same round as the verdicts (__reduce_add_sync), and a lone element
//     makes every lower plane uniform.  Its CRs (start + 1) are counted
//     when the walk starts, so nothing else depends on the planes skipped;
//     the lone element is then drained with no warp round;
//   * contiguous word ownership: lane l holds the packed words
//     l * WPL .. l * WPL + WPL - 1 (word i holds elements 32i .. 32i + 31),
//     so a drain rank is the lane's running count plus one warp exclusive
//     scan, and the total is one __reduce_add_sync; a drain whose
//     survivors sit in one lane skips the scan (a ballot says so);
//   * one round for the load: every table entry's still-live bit is one
//     bit of one __reduce_or_sync; the newest live entry is __ffs of it;
//     the table's sigs and mask slots are packed in two scalars, so a push
//     is a shift.  Folding the load into the round that ended the last
//     search, as the mesh kernels do (colskip_body.cuh's head), costs each
//     lane a share of every entry, and lost on an H100 (PERF.md), so a load
//     keeps its round here (kFoldsLoad false);
//   * planes and table in registers up to WPL = 2 (N <= 2048, the serving
//     cap): the 32 x WPL plane words and the kMaxK x WPL table words of a
//     lane are register arrays indexed only by compile-time constants
//     (the block walk is unrolled over the ceil(32 / kFuse) blocks), so a table
//     push is register moves and `-Xptxas -v` shows no spill.  Wider rows
//     (WPL 4 to 32, N up to 32768) keep planes and table masks in shared
//     memory, lane-interleaved (the lane's q-th word at q * 32 + lane, no
//     bank conflicts), with table entries renamed through slot numbers,
//     and take the same fused walk, rolled.

// Planes are packed once with __ballot_sync: one ballot per bit of each
// 32-element word, kept by the word's owner lane.  Drained elements write
// order[count + rank] = column directly, and the values are gathered from
// the input after the row finishes.
//
// Both carriers' row bodies (packed_row, dense_row) live in
// colskip_body.cuh, written against a Gate (the §IV manager's combine
// points), so the mesh kernels of colskip_mesh.cu run the same bodies
// with the gates between the CTAs of a cluster.  Here, on one bank, the
// gates are warp reductions (WarpGate) and, for the dense carrier's
// warps, one shared-memory meeting behind one barrier (BlockGate).
//
// Exactness notes (line numbers in the Pallas kernel file): fresh rows
// start at s_top (:111, :184); `seen` resets on each traversal; a push
// shifts table entries toward older slots (:144-149); a load takes the
// newest live entry and invalidates the newer ones (:176-179); k=0
// records nothing, with one (always invalid) slot; a row that has drained
// `stop` elements stops counting CRs (:196-203).
//
// The dense carrier (colskip_dense_kernel) replaces the same Pallas kernel
// on its dense path (_sort_kernel with packed=False, whose body is
// _machine_dense, kernel.py:229-291).  Its outputs equal the packed
// kernel's, as the reference's two carriers equal each other.  The carrier
// stays dense: a column read is (v >> sig) & 1 of each alive element's
// value, and the alive, sorted and table masks hold one flag per element
// (a byte), never one bit of a packed word.  It shares the packed
// kernel's chain and its shortening of it:
//
//   * the same speculative fusion and resolution: each thread ORs
//     1 << ((v >> base) & (2^F - 1)) over its alive elements, one
//     __reduce_or_sync a block, and resolve_block() (shared with the
//     packed kernel) gives the verdicts; the alive count rides in the same
//     round, a walk stops at a lone element and drains it with no round;
//   * a one-round load (each table entry's still-live bit is one bit of
//     one reduction, the newest live entry __ffs of it) and a drain rank
//     of a running count plus one scan, since thread t owns the
//     contiguous elements t * c .. t * c + c - 1;
//   * registers with a compile-time c (C = 4, 8, ... kDenseMaxC; rows up
//     to kDenseRegN = 2048, the serving cap): a thread's values are a
//     register array and its flags bytes of registers, four to a word, so
//     every element loop is unrolled; the table masks too at k <= 2, in
//     lane-interleaved shared memory above;
//   * kDenseWarps = 4 warps a row: the warps meet once a round in shared
//     memory behind one barrier, which costs less than the elements a lane
//     no longer walks.  On an H100 four beat one and two, and eight on the
//     harness's (8, 1024) tile (eight won by 1.4 % at (8, 2048); PERF.md);
//   * wider rows take a rolled one-warp instance whose values and flag
//     bytes live in shared memory ((4 + 2 + kk) bytes an element, slot
//     [i][lane], no bank conflicts); colskip_max_n() gives the widest row
//     it holds on the current card; a wider row is refused, never split.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "colskip_body.cuh"

namespace {

#ifndef COLSKIP_FUSE
#define COLSKIP_FUSE 2
#endif
constexpr int kFuse = COLSKIP_FUSE;     // planes resolved per verdict round
constexpr int kDenseWarps = 4;     // dense: warps a row, registers
constexpr int kDenseRegN = 2048;   // dense: widest row held in registers
// dense: most elements a thread of a register instance holds
constexpr int kDenseMaxC = kDenseRegN / (32 * kDenseWarps);
static_assert(kDenseMaxC >= 4 && (kDenseMaxC & (kDenseMaxC - 1)) == 0,
              "register instances of 4, 8, ... elements a thread");
constexpr int kMaxDevices = 64;

// One bank, one warp a row (the packed carrier): every gate is a warp
// reduction; a load takes one of its own (the body leaves `nxt` alone).
struct WarpGate {
    static constexpr int bank = 0, banks = 1;
    static constexpr bool kFoldsLoad = false;
    __device__ __forceinline__ uint32_t any(uint32_t bits) {
        return __reduce_or_sync(kFull, bits);
    }
    template <int NW>
    __device__ __forceinline__ void patterns(uint32_t (&pats)[NW], int& cnt) {
        cnt = __reduce_add_sync(kFull, cnt);
#pragma unroll
        for (int h = 0; h < NW; ++h) pats[h] = __reduce_or_sync(kFull, pats[h]);
    }
    // a drain whose survivors sit in one lane skips the scan (a ballot
    // says so)
    __device__ __forceinline__ int rank(int mine, int& total, uint32_t&) {
        total = __reduce_add_sync(kFull, mine);
        const uint32_t holders = __ballot_sync(kFull, mine != 0);
        return (holders & (holders - 1u))
                   ? warp_inclusive_scan(mine, threadIdx.x & 31) - mine : 0;
    }
    __device__ __forceinline__ void done() { __syncwarp(); }
    __device__ __forceinline__ bool lead() const { return threadIdx.x == 0; }
};

// One bank of W warps a row (the dense carrier).  Each warp reduces with
// one REDUX a word; W > 1 warps then meet once in shared memory (`xch`,
// two buffers of [NW + 1][W] words: the pattern words, then the counts)
// behind one barrier.  The buffers alternate (`par`), so one barrier a
// round suffices: no warp rewrites a buffer before every warp has passed
// the barrier after its last read.  A load takes a round of its own, as in
// WarpGate.
template <int W, int NW = pat_words(kFuse)>
struct BlockGate {
    static constexpr int bank = 0, banks = 1;
    static constexpr bool kFoldsLoad = false;
    static constexpr int kSlot = (NW + 1) * W;         // words a buffer
    static constexpr int kWords = W > 1 ? 2 * kSlot : 0;   // shared words
    uint32_t* xch;
    int par = 0;
    __device__ explicit BlockGate(uint32_t* x) : xch(x) {}

    __device__ __forceinline__ uint32_t any(uint32_t bits) {
        bits = __reduce_or_sync(kFull, bits);
        if (W > 1) {
            uint32_t* xb = xch + par * kSlot;
            if ((threadIdx.x & 31) == 0) xb[threadIdx.x >> 5] = bits;
            __syncthreads();
            bits = 0u;
#pragma unroll
            for (int i = 0; i < W; ++i) bits |= xb[i];
            par ^= 1;
        }
        return bits;
    }
    __device__ __forceinline__ void patterns(uint32_t (&bits)[NW], int& cnt) {
#pragma unroll
        for (int h = 0; h < NW; ++h) bits[h] = __reduce_or_sync(kFull, bits[h]);
        cnt = __reduce_add_sync(kFull, cnt);
        if (W > 1) {
            uint32_t* xb = xch + par * kSlot;
            const int warp = threadIdx.x >> 5;
            if ((threadIdx.x & 31) == 0) {
#pragma unroll
                for (int h = 0; h < NW; ++h) xb[h * W + warp] = bits[h];
                xb[NW * W + warp] = (uint32_t)cnt;
            }
            __syncthreads();
            cnt = 0;
#pragma unroll
            for (int h = 0; h < NW; ++h) bits[h] = 0u;
#pragma unroll
            for (int i = 0; i < W; ++i) {
#pragma unroll
                for (int h = 0; h < NW; ++h) bits[h] |= xb[h * W + i];
                cnt += (int)xb[NW * W + i];
            }
            par ^= 1;
        }
    }
    // one warp skips the scan when a single lane holds every survivor
    __device__ __forceinline__ int rank(int mine, int& total, uint32_t&) {
        const int lane = threadIdx.x & 31;
        if (W == 1) {
            total = __reduce_add_sync(kFull, mine);
            const uint32_t holders = __ballot_sync(kFull, mine != 0);
            return (holders & (holders - 1u))
                       ? warp_inclusive_scan(mine, lane) - mine : 0;
        }
        const int incl = warp_inclusive_scan(mine, lane);
        uint32_t* xb = xch + par * kSlot;
        const int warp = threadIdx.x >> 5;
        if (lane == 31) xb[warp] = (uint32_t)incl;
        __syncthreads();
        int before = 0;
        total = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) {
            const int c = (int)xb[i];
            total += c;
            before += i < warp ? c : 0;
        }
        par ^= 1;
        return before + incl - mine;
    }
    __device__ __forceinline__ void done() {
        if (W > 1) __syncthreads(); else __syncwarp();
    }
    __device__ __forceinline__ bool lead() const { return threadIdx.x == 0; }
};

// One warp per row.  WPL = packed words a lane holds (ceil(N/1024) rounded
// up to a power of two).  Up to WPL = 2 the planes and the table masks
// live in registers and the block walk is unrolled; wider rows keep them
// in shared memory and take the walk rolled (packed_row, colskip_body.cuh).
template <int WPL>
__global__ void __launch_bounds__(32)
colskip_sort_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ vals,
                    int32_t* __restrict__ order, int32_t* __restrict__ crs_out,
                    int32_t* __restrict__ cyc_out, int n, int w, int k,
                    int stop) {
    extern __shared__ uint32_t smem[];
    const int row = blockIdx.x;
    const uint32_t* xr = x + (size_t)row * n;
    int32_t* ordr = order + (size_t)row * stop;
    WarpGate g;
    int crs = 0, drains = 0;
    packed_row<WPL, kFuse>(g, xr, ordr, n, 0, w, k, stop, smem, crs, drains);
    g.done();                                 // order[] written by all lanes
    finish_row(g, xr, vals + (size_t)row * stop, ordr, stop, crs, drains,
               crs_out, cyc_out, row);
}

// Dense carrier (see the note at the head of this file): a row of W warps
// (dense_row, colskip_body.cuh); C elements a thread in registers, or the
// rolled one-warp instance (C = 0) in shared memory.
template <int C, bool kRegTab, int W>
__global__ void __launch_bounds__(32 * W)
colskip_dense_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ vals,
                     int32_t* __restrict__ order, int32_t* __restrict__ crs_out,
                     int32_t* __restrict__ cyc_out, int n, int w, int k,
                     int stop) {
    extern __shared__ uint32_t smem[];
    const int row = blockIdx.x;
    const uint32_t* xr = x + (size_t)row * n;
    int32_t* ordr = order + (size_t)row * stop;
    BlockGate<W> g(smem);                  // exchange words at the head
    int crs = 0, drains = 0;
    dense_row<C, kRegTab, W, kFuse>(g, xr, ordr, n, 0, w, k, stop,
                                    smem + BlockGate<W>::kWords, crs, drains);
    g.done();                                 // order[] written by all
    finish_row(g, xr, vals + (size_t)row * stop, ordr, stop, crs, drains,
               crs_out, cyc_out, row);
}

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device, once per device (`done` is the kernel's own flag array); a race
// between two first calls only sets the attribute twice.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool>* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool keep = dev >= 0 && dev < kMaxDevices;
    if (keep && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess && keep)
        done[dev].store(true, std::memory_order_release);
    return err;
}

template <int WPL>
int launch(const uint32_t* x, uint32_t* vals, int32_t* order, int32_t* crs,
           int32_t* cyc, int b, int n, int w, int k, int stop,
           cudaStream_t stream) {
    const int kk = k > 0 ? k : 1;
    constexpr bool kRegs = packed_in_registers(WPL, kFuse);
    const int masks = kRegs ? 0 : kPlanes + kk;
    const size_t smem = (size_t)masks * 32 * WPL * sizeof(uint32_t);
    if (!kRegs) {
        static std::atomic<bool> done[kMaxDevices];
        const int most = (kPlanes + kMaxK) * 32 * WPL * (int)sizeof(uint32_t);
        cudaError_t err = allow_smem(colskip_sort_kernel<WPL>, most, done);
        if (err != cudaSuccess) return (int)err;
    }
    colskip_sort_kernel<WPL><<<b, 32, smem, stream>>>(x, vals, order, crs, cyc,
                                                      n, w, k, stop);
    return (int)cudaGetLastError();
}

template <int C, bool kRegTab, int W>
int launch_dense_at(const uint32_t* x, uint32_t* vals, int32_t* order,
                    int32_t* crs, int32_t* cyc, int b, int n, int w, int k,
                    int stop, cudaStream_t stream) {
    const int kk = k > 0 ? k : 1;
    constexpr int T = 32 * W;
    size_t smem = BlockGate<W>::kWords * sizeof(uint32_t);   // exchange words
    if (C == 0) {
        // values and (2 + kk) flag bytes an element, in shared memory
        const int c = (n + T - 1) / T;
        smem += (size_t)c * T * (4 + 2 + kk);
        static std::atomic<bool> done[kMaxDevices];
        int dev = 0, optin = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = allow_smem(colskip_dense_kernel<C, kRegTab, W>, optin, done);
        if (err != cudaSuccess) return (int)err;
    } else if (!kRegTab) {
        smem += (size_t)kk * C * T;        // table flag bytes
    }
    colskip_dense_kernel<C, kRegTab, W><<<b, T, smem, stream>>>(
        x, vals, order, crs, cyc, n, w, k, stop);
    return (int)cudaGetLastError();
}

// The dense register instance for the row: the smallest C (4, 8, ... up
// to kDenseMaxC) that holds per = ceil(n / (32 * kDenseWarps)) elements
template <int C, bool kRegTab>
int launch_dense_reg(int per, const uint32_t* x, uint32_t* vals,
                     int32_t* order, int32_t* crs, int32_t* cyc, int b, int n,
                     int w, int k, int stop, cudaStream_t stream) {
    if constexpr (C < kDenseMaxC) {
        if (per > C)
            return launch_dense_reg<2 * C, kRegTab>(
                per, x, vals, order, crs, cyc, b, n, w, k, stop, stream);
    }
    return launch_dense_at<C, kRegTab, kDenseWarps>(
        x, vals, order, crs, cyc, b, n, w, k, stop, stream);
}

// The dense instance for the row: registers up to kDenseRegN (the table
// too at k <= kRegTable), the rolled one-warp instance past that
int launch_dense(const uint32_t* x, uint32_t* vals, int32_t* order,
                 int32_t* crs, int32_t* cyc, int b, int n, int w, int k,
                 int stop, cudaStream_t stream) {
    const int per = (n + 32 * kDenseWarps - 1) / (32 * kDenseWarps);
    if (n > kDenseRegN)
        return launch_dense_at<0, false, 1>(x, vals, order, crs, cyc, b, n,
                                            w, k, stop, stream);
    if (k > kRegTable)
        return launch_dense_reg<4, false>(per, x, vals, order, crs, cyc, b,
                                          n, w, k, stop, stream);
    return launch_dense_reg<4, true>(per, x, vals, order, crs, cyc, b, n, w,
                                     k, stop, stream);
}

// One warp, `rounds` dependent __any_sync votes: each predicate depends on
// the previous verdict, as a CR's alive mask depends on the last one.  The
// time per round is the latency of one step of a row's chain; it prices
// the sort kernels' bounds and is not on the serving path.
__global__ void __launch_bounds__(32)
vote_chain_kernel(int32_t* __restrict__ out, uint32_t seed, int rounds) {
    const uint32_t v = seed ^ threadIdx.x;
    int acc = 0;
    for (int r = 0; r < rounds; ++r)
        acc += __any_sync(kFull, ((v >> (r & 31)) ^ (uint32_t)acc) & 1u);
    if (threadIdx.x == 0) out[0] = acc;
}

// The same chain with __reduce_or_sync (one REDUX a round), the reduction
// the packed kernel's fused verdicts and loads take.
__global__ void __launch_bounds__(32)
redux_chain_kernel(int32_t* __restrict__ out, uint32_t seed, int rounds) {
    const uint32_t v = seed ^ threadIdx.x;
    int acc = 0;
    for (int r = 0; r < rounds; ++r)
        acc += (int)__reduce_or_sync(kFull,
                                     ((v >> (r & 31)) ^ (uint32_t)acc) & 1u);
    if (threadIdx.x == 0) out[0] = acc;
}

bool bad_args(int b, int n, int w, int k, int stop) {
    return b <= 0 || n <= 0 || w < 1 || w > 32 || k < 0 || k > kMaxK ||
           stop < 1 || stop > n;
}

}  // namespace

extern "C" {

// out (1,) int32 <- the count of true verdicts in a chain of `rounds`
// dependent warp rounds (one warp): __any_sync votes (redux = 0) or
// __reduce_or_sync (redux != 0).  Returns cudaGetLastError().
int colskip_chain_launch(void* out, unsigned seed, int rounds, int redux,
                         void* stream) {
    if (rounds < 0) return (int)cudaErrorInvalidValue;
    auto o = static_cast<int32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (redux)
        redux_chain_kernel<<<1, 32, 0, st>>>(o, seed, rounds);
    else
        vote_chain_kernel<<<1, 32, 0, st>>>(o, seed, rounds);
    return (int)cudaGetLastError();
}

// Widest row each carrier takes at state depth k.  Packed: 32 words per
// lane, 1024 words per mask.  Dense: (4 + 2 + kk) bytes of shared memory
// an element, within the current card's per-block opt-in maximum.
int colskip_max_n(int packed, int k) {
    if (k < 0 || k > kMaxK) return 0;
    if (packed) return 32 * 32 * 32;
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    const int kk = k > 0 ? k : 1;
    return optin / (6 + kk) / 32 * 32;
}
int colskip_max_k(void) { return kMaxK; }
int colskip_fuse(void) { return kFuse; }

// x (b, n) uint32 -> vals (b, stop) uint32, order (b, stop) int32,
// crs (b,) int32, cyc (b,) int32, on the packed (packed != 0) or the dense
// carrier.  Returns cudaGetLastError() after the launch (0 on success);
// launches on `stream` and does not synchronise.
int colskip_sort_launch(const void* x, void* vals, void* order, void* crs,
                        void* cyc, int b, int n, int w, int k, int stop,
                        int packed, void* stream) {
    if (bad_args(b, n, w, k, stop) || n > colskip_max_n(packed, k))
        return (int)cudaErrorInvalidValue;
    auto xs = static_cast<const uint32_t*>(x);
    auto vs = static_cast<uint32_t*>(vals);
    auto os = static_cast<int32_t*>(order);
    auto cs = static_cast<int32_t*>(crs);
    auto ys = static_cast<int32_t*>(cyc);
    auto st = static_cast<cudaStream_t>(stream);
#define COLSKIP_ARGS xs, vs, os, cs, ys, b, n, w, k, stop, st
    if (!packed) return launch_dense(COLSKIP_ARGS);
    const int wpl = ((n + 31) / 32 + 31) / 32;
    if (wpl <= 1) return launch<1>(COLSKIP_ARGS);
    if (wpl <= 2) return launch<2>(COLSKIP_ARGS);
    if (wpl <= 4) return launch<4>(COLSKIP_ARGS);
    if (wpl <= 8) return launch<8>(COLSKIP_ARGS);
    if (wpl <= 16) return launch<16>(COLSKIP_ARGS);
    return launch<32>(COLSKIP_ARGS);
#undef COLSKIP_ARGS
}

}  // extern "C"
