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
// Its top-k instance (kTopk) runs the same descent and then, in the same
// launch, what the reference's radix_topk does around the Pallas call
// (repro/kernels/radix_topk/ops.py:74-120, one XLA program there; some 20
// to 40 eager torch ops here before): every word above the threshold T
// and the first `need` words equal to T by index are selected.  Each of
// the 16 warps takes a contiguous segment of the row and counts its words
// above and equal to T; after one barrier a warp sums the counts of the
// warps before it, which gives its first slot and its first tie rank, and
// a ballot and a popcount over the lower lanes place each selected word,
// 32 words a step, in compact_sortable's slot (index order, exact_k_mask's
// lowest-index tie rule).  The k slots hold 64-bit keys (~v << 32 | j),
// which order (value desc, index asc); k <= kRankK slots rank themselves
// by counting, more are sorted by a bitonic network over k keys (pairs
// past k skipped: those would hold +inf).  The slots live in shared
// memory after the row; a streamed row whose k slots do not fit there
// keeps them in its own output row in device memory.  Options: the
// complement (select on ~u, write ~value back: kmin), the row's mixed
// planes popc(OR ^ AND) (the serving backend's plane reads), banked rows
// (a (B, V) row read in place as ceil(V / W) banks of W words, a block
// each, the columns past V as sortable(-inf), indices bank * W + j) and a
// payload (an int32 (B, N) row written in place of each index).
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
//   * its top-k entry selects as the block instance does (a ballot a
//     register word ranks the ties), places the slots in shared memory in
//     index order, ranks them under (value desc, index asc) by counting
//     against the k slots, and writes them with their int32 indices (or
//     the payload's words), mapped back from the sortable domain; with the
//     same complement and plane-read options.

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
// the dynamic shared memory a block may opt in to on an H100
constexpr int kSmemOptin = 232448;
// the top-k instance: slots ranked by counting up to kRankK, sorted above
constexpr int kRankK = 64;
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

// What a top-k launch writes, and how it reads its rows.  Output row r
// (a block row of the block instance, a row of the narrow one) holds its
// k values at vals + r * ld_out, its k indices at idxs + r * ld_out and
// its mixed planes at reads[r * ld_reads] (where reads is not null).
struct Select {
    uint32_t* vals;              // null: the threshold entry
    int32_t* idxs;
    int32_t* reads;              // popc(OR ^ AND) of the row, or null
    const int32_t* payload;      // (B, ld_in): written in place of j
    int ld_out, ld_reads;
    int ld_in;                   // words between input rows (banked: V)
    int banks;                   // block rows an input row (1: unbanked)
    int complement;              // select on ~u, write ~value back
    int smem_slots;              // the slots in shared memory, else in
                                 // the output row (streamed rows only)
};

// The k slots of a row: 64-bit keys (~v << 32 | j), ascending in (value
// desc, index asc); in shared memory, or split over the output row's
// values (high words) and indices (low words).
struct Slots {
    uint64_t* sm;
    uint32_t* hi;
    int32_t* lo;
    __device__ uint64_t get(int s) const {
        return sm ? sm[s] : ((uint64_t)hi[s] << 32) | (uint32_t)lo[s];
    }
    __device__ void put(int s, uint64_t key) const {
        if (sm) {
            sm[s] = key;
        } else {
            hi[s] = (uint32_t)(key >> 32);
            lo[s] = (int32_t)(uint32_t)key;
        }
    }
};

__device__ __forceinline__ uint64_t slot_key(uint32_t v, int j) {
    return ((uint64_t)~v << 32) | (uint32_t)j;
}

template <bool kFloatIn, bool kStream, bool kTopk>
__global__ void __launch_bounds__(kThreads)
radix_threshold_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ thresh,
                       int32_t* __restrict__ visited, const Select s, int b,
                       int n, int k) {
    extern __shared__ uint32_t smem[];
    uint32_t* hist = smem;                     // [2][kBins]
    uint32_t* red = hist + 2 * kBins;          // [2][kWarps] OR, AND
    uint32_t* sel = red + 2 * kWarps;          // digit, need, mixed, AND
    uint32_t* srow = smem + kHead;             // [n] (!kStream)
    cg::cluster_group cluster = cg::this_cluster();
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int row = blockIdx.x;                // the block's row (banked:
    const bool real = row < b;                 // a bank of a row)
    const int iters = (n + kThreads - 1) / kThreads;
    // the row's words: banked rows read words past V as sortable(-inf)
    const uint32_t* xr;
    int bank = 0, valid = n;
    if constexpr (kTopk) {
        const int src = real ? row / s.banks : 0;
        bank = real ? row % s.banks : 0;
        xr = x + (size_t)src * s.ld_in + (size_t)bank * n;
        valid = min(n, s.ld_in - bank * n);
    } else {
        xr = x + (size_t)(real ? row : 0) * n;
    }
    auto word = [&](int j) -> uint32_t {
        if constexpr (kTopk) {
            const uint32_t v = j < valid ? sortable<kFloatIn>(xr[j])
                                         : (kFloatIn ? 0x007FFFFFu : 0u);
            return s.complement ? ~v : v;
        } else {
            return sortable<kFloatIn>(xr[j]);
        }
    };

    // pass 1: the row into shared memory, OR / AND -> its mixed planes
    uint32_t v_or = 0u, v_and = kFull;
    if (real) {
        for (int j = t; j < n; j += kThreads) {
            const uint32_t v = word(j);
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

    uint32_t prefix = 0u, need = (uint32_t)k;
    if (real) {
        // prefix pre-load: the bits above s_top are uniform in every row
        const uint32_t hi0 = s_top >= 31 ? 0u
                           : (s_top < 0 ? kFull : ~((2u << s_top) - 1u));
        prefix = sel[3] & hi0;
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
                    const uint32_t v = kStream ? word(j) : srow[j];
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
        if (!kTopk && t == 0) {
            thresh[row] = prefix;
            visited[row] = s_top + 1;
        }
    }
    // no block leaves while a partner may still read its mixed word
    cluster.sync();
    if constexpr (kTopk) {
        if (!real) return;
        const int ties_need = (int)need;       // ties at T to take
        if (s.reads && t == 0) s.reads[(size_t)row * s.ld_reads] = __popc(sel[2]);
        uint32_t* vr = s.vals + (size_t)row * s.ld_out;
        int32_t* ir = s.idxs + (size_t)row * s.ld_out;
        const Slots slots{
            s.smem_slots ? reinterpret_cast<uint64_t*>(
                               smem + kHead + (kStream ? 0 : ((n + 1) & ~1)))
                         : nullptr,
            vr, ir};
        // each warp a contiguous segment of whole 32-word steps: its words
        // above T and equal to T (the histograms are free now)
        const int seg = (n + kThreads - 1) / kThreads * 32;
        const int j0 = warp * seg, j1 = min(n, j0 + seg);
        int gt = 0, eq = 0;
        for (int j = j0 + lane; j < j1; j += 32) {
            const uint32_t v = kStream ? word(j) : srow[j];
            gt += v > prefix ? 1 : 0;
            eq += v == prefix ? 1 : 0;
        }
        gt = __reduce_add_sync(kFull, gt);
        eq = __reduce_add_sync(kFull, eq);
        if (lane == 0) {
            hist[warp] = (uint32_t)gt;
            hist[kWarps + warp] = (uint32_t)eq;
        }
        __syncthreads();
        // the warps before this one: its first slot and first tie rank
        int taken = 0, ties = 0;
        for (int w = 0; w < warp; ++w) {
            taken += (int)hist[w];
            ties += (int)hist[kWarps + w];
        }
        taken += min(ties, ties_need);
        const unsigned lower = (1u << lane) - 1u;
        for (int base = j0; base < j1; base += 32) {
            const int j = base + lane;
            const bool live = j < j1;
            const uint32_t v = live ? (kStream ? word(j) : srow[j]) : 0u;
            const bool at_t = live && v == prefix;
            const unsigned eqs = __ballot_sync(kFull, at_t);
            const bool pick = live && (v > prefix ||
                                       (at_t && ties + __popc(eqs & lower) < ties_need));
            const unsigned picks = __ballot_sync(kFull, pick);
            if (pick) slots.put(taken + __popc(picks & lower), slot_key(v, j));
            ties += __popc(eqs);
            taken += __popc(picks);
        }
        __syncthreads();
        // a slot's final place: its rank among the k keys
        auto emit = [&](int place, uint64_t key) {
            uint32_t v = ~(uint32_t)(key >> 32);
            if (s.complement) v = ~v;
            const int gj = bank * n + (int)(uint32_t)key;
            vr[place] = unsortable<kFloatIn>(v);
            ir[place] = s.payload ? s.payload[(size_t)(row / s.banks) * s.ld_in + gj]
                                  : gj;
        };
        if (k <= kRankK && slots.sm) {
            for (int q = t; q < k; q += kThreads) {
                const uint64_t key = slots.get(q);
                int rank = 0;
                for (int o = 0; o < k; ++o) rank += slots.get(o) < key ? 1 : 0;
                emit(rank, key);
            }
            return;
        }
        // a bitonic network over the next power of two, each merge opened
        // by a flip (so every exchange puts the smaller key first); pairs
        // reaching past k are skipped, as they would meet +inf
        int width = 1;
        while (width < k) width <<= 1;
        for (int size = 2; size <= width; size <<= 1) {
            for (int stride = size >> 1; stride > 0; stride >>= 1) {
                for (int q = t; q < width / 2; q += kThreads) {
                    const int off = q % stride;
                    int a, c;
                    if (stride == size >> 1) {
                        a = (q / stride) * size + off;
                        c = a - off + size - 1 - off;
                    } else {
                        a = (q / stride) * 2 * stride + off;
                        c = a + stride;
                    }
                    if (c < k) {
                        const uint64_t ka = slots.get(a), kc = slots.get(c);
                        if (kc < ka) {
                            slots.put(a, kc);
                            slots.put(c, ka);
                        }
                    }
                }
                __syncthreads();
            }
        }
        for (int q = t; q < k; q += kThreads) emit(q, slots.get(q));
    }
}

// The narrow instance.  Warp w of block t holds row 8 t + w in registers
// (kWpl words a lane).  Writes thresh and visited where they are not null;
// where s.vals is not null (the top-k entry) also the row's k largest
// words in (value desc, index asc) order, with 2 k words of shared memory
// a warp for the slots.
template <bool kFloatIn, int kWpl>
__global__ void __launch_bounds__(kNarrowThreads)
radix_narrow_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ thresh,
                    int32_t* __restrict__ visited, const Select s, int b, int n,
                    int k) {
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
            if (s.complement) w[i] = ~w[i];
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
        if (s.reads) s.reads[(size_t)row * s.ld_reads] = __popc(v_or ^ v_and);
    }
    if (!s.vals) return;

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
    uint32_t* vr = s.vals + (size_t)row * s.ld_out;
    int32_t* ir = s.idxs + (size_t)row * s.ld_out;
    for (int q = lane; q < k; q += 32) {
        const uint32_t v = sv[q];
        int rank = 0;
        for (int o = 0; o < k; ++o) {
            const uint32_t u = sv[o];
            rank += (u > v || (u == v && o < q)) ? 1 : 0;
        }
        vr[rank] = unsortable<kFloatIn>(s.complement ? ~v : v);
        ir[rank] = s.payload ? s.payload[(size_t)row * n + si[q]] : (int32_t)si[q];
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

// b block rows of n words
template <bool kFloatIn, bool kStream, bool kTopk>
int launch(const uint32_t* x, uint32_t* thresh, int32_t* visited,
           const Select& s, int b, int n, int k, cudaStream_t stream) {
    auto kernel = radix_threshold_kernel<kFloatIn, kStream, kTopk>;
    size_t words = (size_t)kHead + (kStream ? 0 : n);
    if (kTopk) {
        words = (size_t)kHead + (kStream ? 0 : ((n + 1) & ~1)) +
                (s.smem_slots ? 2 * (size_t)k : 0);
    }
    if (kTopk || !kStream) {
        static std::atomic<bool> done[kMaxDevices];
        const int err = opt_in(kernel, kTopk ? kSmemOptin
                                             : (int)((kHead + kSmemN) * sizeof(uint32_t)),
                               done);
        if (err) return err;
    }
    const int tiles = (b + kTileRows - 1) / kTileRows;
    return launch_tiles(kernel, tiles, words * sizeof(uint32_t), stream, x,
                        thresh, visited, s, b, n, k);
}

template <bool kFloatIn, int kWpl>
int launch_narrow_wpl(const uint32_t* x, uint32_t* thresh, int32_t* visited,
                      const Select& s, int b, int n, int k,
                      cudaStream_t stream) {
    auto kernel = radix_narrow_kernel<kFloatIn, kWpl>;
    // the tile's words, and 2 k slot words a warp for the top-k entry (past
    // 48 KB only at k > 767)
    const size_t smem = (size_t)(kTileRows + (s.vals ? 2 * kTileRows * k : 0)) *
                        sizeof(uint32_t);
    static std::atomic<bool> done[kMaxDevices];
    const int err = opt_in(
        kernel, (int)((kTileRows + 2 * kTileRows * kNarrowN) * sizeof(uint32_t)),
        done);
    if (err) return err;
    const int tiles = (b + kTileRows - 1) / kTileRows;
    return launch_grid(kernel, tiles, kNarrowThreads, 1, smem, stream, x,
                       thresh, visited, s, b, n, k);
}

// kWpl: the least of 2, 4, 8, 32 that holds the row
template <bool kFloatIn>
int launch_narrow(const uint32_t* x, uint32_t* thresh, int32_t* visited,
                  const Select& s, int b, int n, int k, cudaStream_t stream) {
    const int wpl = (n + 31) / 32;
    if (wpl <= 2)
        return launch_narrow_wpl<kFloatIn, 2>(x, thresh, visited, s, b, n, k,
                                              stream);
    if (wpl <= 4)
        return launch_narrow_wpl<kFloatIn, 4>(x, thresh, visited, s, b, n, k,
                                              stream);
    if (wpl <= 8)
        return launch_narrow_wpl<kFloatIn, 8>(x, thresh, visited, s, b, n, k,
                                              stream);
    return launch_narrow_wpl<kFloatIn, 32>(x, thresh, visited, s, b, n, k,
                                           stream);
}

// the top-k entry's instance by the block row's width
template <bool kFloatIn>
int launch_select(const uint32_t* x, const Select& s, int b, int n, int k,
                  bool narrow, cudaStream_t stream) {
    if (narrow) return launch_narrow<kFloatIn>(x, nullptr, nullptr, s, b, n, k, stream);
    if (n <= kSmemN)
        return launch<kFloatIn, false, true>(x, nullptr, nullptr, s, b, n, k, stream);
    return launch<kFloatIn, true, true>(x, nullptr, nullptr, s, b, n, k, stream);
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
    const Select none{nullptr, nullptr, nullptr, nullptr, 0, 0, n, 1, 0, 0};
    if (n <= kNarrowN) {
        if (float_in) return launch_narrow<true>(xs, ts, vs, none, b, n, k, st);
        return launch_narrow<false>(xs, ts, vs, none, b, n, k, st);
    }
    if (float_in) return launch<true, false, false>(xs, ts, vs, none, b, n, k, st);
    if (n > kSmemN) return launch<false, true, false>(xs, ts, vs, none, b, n, k, st);
    return launch<false, false, false>(xs, ts, vs, none, b, n, k, st);
}

// The top-k entry.  x (b, n) float32 (flags & 1) or sortable uint32 ->
// vals (of x's type) and idxs int32: each row's k largest, ordered (value
// desc, index asc), the lowest indices taken among ties at the k-th value
// (lax.top_k's rule).  One launch: rows of at most radix_narrow_n() words
// take the narrow instance, wider ones a block a row, streamed past
// radix_smem_n() (sortable words only).  Options:
//   flags & 2    the complement: the k smallest (select on ~u, write the
//                values back), sortable words only;
//   reads        not null: int32, each row's popc(OR ^ AND);
//   payload      not null: int32 (b, n), payload[row, j] written in place
//                of each index j;
//   bank > 0     float32 only, no payload: each row is read in place as
//                ceil(n / bank) banks of `bank` words (at most
//                radix_smem_n()), a block each, the columns past n as
//                -inf; block row r = row * banks + bank writes its k <=
//                bank largest with indices bank * `bank` + j;
//   ld_out       elements between output rows of vals, idxs and reads (0:
//                k for vals and idxs, 1 for reads), so that one buffer can
//                hold all three.
// Returns cudaGetLastError() after the launch, as above.
int radix_select_launch(const void* x, void* vals, void* idxs, void* reads,
                        const void* payload, int b, int n, int k, int bank,
                        int ld_out, int flags, void* stream) {
    const bool float_in = flags & 1, complement = flags & 2;
    if (b <= 0 || n <= 0 || k < 1 || ld_out < 0 || (ld_out && ld_out < k) ||
        (float_in && complement) || b > 0x7FFFFFFF - kTileRows)
        return (int)cudaErrorInvalidValue;
    int banks = 1, width = n;
    if (bank > 0) {
        if (!float_in || payload || bank > kSmemN || k > bank)
            return (int)cudaErrorInvalidValue;
        banks = (n + bank - 1) / bank;
        width = bank;
        if ((long long)b * banks > 0x7FFFFFFF - kTileRows)
            return (int)cudaErrorInvalidValue;
    } else if (k > n || (float_in && n > kSmemN)) {
        return (int)cudaErrorInvalidValue;
    }
    const int rows = b * banks;
    const bool narrow = bank == 0 && n <= kNarrowN;
    Select s{static_cast<uint32_t*>(vals), static_cast<int32_t*>(idxs),
             static_cast<int32_t*>(reads), static_cast<const int32_t*>(payload),
             ld_out ? ld_out : k, ld_out ? ld_out : 1, n, banks, complement ? 1 : 0,
             1};
    // a streamed row keeps its slots in shared memory where they fit
    if (!narrow && width > kSmemN)
        s.smem_slots = (size_t)(kHead + 2 * (size_t)k) * sizeof(uint32_t) <=
                       (size_t)kSmemOptin;
    auto xs = static_cast<const uint32_t*>(x);
    auto st = static_cast<cudaStream_t>(stream);
    if (float_in) return launch_select<true>(xs, s, rows, width, k, narrow, st);
    return launch_select<false>(xs, s, rows, width, k, narrow, st);
}

// An empty kernel launched as one tile is (a cluster of kTileRows blocks
// of kThreads): its time, taken as the kernel's is, is the card's launch
// floor for this launch.  Returns cudaGetLastError().
int radix_empty_launch(void* stream) {
    return launch_tiles(empty_kernel, 1, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
