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
//     2^F-bit word when one of its alive elements shows the F-bit pattern
//     p on the block's planes; one __reduce_or_sync gives the warp's
//     patterns, and the verdicts resolve in registers plane by plane: a
//     plane is mixed when the patterns still alive show both of its bits,
//     and then keeps those with a 0.  This is the reference's speculation
//     (a saw-a-1 and a saw-a-0 bit for each plane under each hypothesis of
//     the earlier planes' verdicts) in 2^F bits instead of 2 (2^F - 1).
//     kFuse = 2 (COLSKIP_FUSE at build time: 1, 2 or 4).  On an H100 it
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
//     is a shift;
//   * planes and table in registers up to WPL = 2 (N <= 2048, the serving
//     cap): the 32 x WPL plane words and the kMaxK x WPL table words of a
//     lane are register arrays indexed only by compile-time constants
//     (the block walk is unrolled over the 32 / kFuse blocks), so a table
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

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 8;        // deepest state table the kernel holds
#ifndef COLSKIP_FUSE
#define COLSKIP_FUSE 2
#endif
constexpr int kFuse = COLSKIP_FUSE;     // planes resolved per verdict round
constexpr int kPlanes = 32;     // bit planes packed per row (w <= 32)
constexpr int kDenseWarps = 4;     // dense: warps a row, registers
constexpr int kDenseRegN = 2048;   // dense: widest row held in registers
// dense: most elements a thread of a register instance holds
constexpr int kDenseMaxC = kDenseRegN / (32 * kDenseWarps);
static_assert(kDenseMaxC >= 4 && (kDenseMaxC & (kDenseMaxC - 1)) == 0,
              "register instances of 4, 8, ... elements a thread");
constexpr int kRegTable = 2;       // dense: table entries held in registers
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += t;
    }
    return v;
}

// 1 if any bit of `t` is set, else 0 (one IMNMX, no compare and select)
__device__ __forceinline__ uint32_t nonzero(uint32_t t) { return min(t, 1u); }

// The F-bit patterns (plane i of a block at bit F - 1 - i) whose bit j is
// set, as a 2^F-bit mask.
__host__ __device__ constexpr uint32_t pattern_mask(int f, int j) {
    uint32_t m = 0u;
    for (int p = 0; p < (1 << f); ++p)
        if ((p >> j) & 1) m |= 1u << p;
    return m;
}

// OR of bits[p] << p over p < n, as a balanced tree (no serial chain)
template <int N>
__device__ __forceinline__ uint32_t pack_bits(uint32_t (&bits)[N]) {
#pragma unroll
    for (int p = 0; p < N; ++p) bits[p] <<= p;
#pragma unroll
    for (int d = 1; d < N; d <<= 1)
#pragma unroll
        for (int p = 0; p + d < N; p += 2 * d) bits[p] |= bits[p + d];
    return bits[0];
}

// The verdicts of one block of kFuse planes (plane i of the block is
// base + F - 1 - i) from the set of F-bit patterns that the block's alive
// elements show (plane i at bit F - 1 - i of a pattern).  Bit i of the
// result is set when plane i is active (at or below `start`) and mixed:
// the patterns still alive show both of its bits; a mixed plane then keeps
// those with a 0 there.  Both carriers resolve their blocks here, as the
// reference's carriers share _traverse_planes.
__device__ __forceinline__ uint32_t resolve_block(uint32_t pats, int base,
                                                  int start) {
    uint32_t mixed = 0u;
#pragma unroll
    for (int i = 0; i < kFuse; ++i) {
        const uint32_t has1 = pattern_mask(kFuse, kFuse - 1 - i);
        const uint32_t ones = pats & has1;
        const uint32_t zeros = pats & ~has1;
        const bool on = base + kFuse - 1 - i <= start && ones != 0u &&
                        zeros != 0u;
        pats = on ? zeros : pats;
        mixed |= (uint32_t)on << i;
    }
    return mixed;
}

// One warp per row.  WPL = packed words a lane holds (ceil(N/1024) rounded
// up to a power of two).  Up to WPL = 2 the planes and the table masks
// live in registers and the block walk is unrolled; wider rows keep them
// in shared memory and take the walk rolled.
template <int WPL>
__global__ void __launch_bounds__(32)
colskip_sort_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ vals,
                    int32_t* __restrict__ order, int32_t* __restrict__ crs_out,
                    int32_t* __restrict__ cyc_out, int n, int w, int k,
                    int stop) {
    constexpr int F = kFuse;
    static_assert(kPlanes % F == 0, "blocks tile the 32 planes");
    constexpr bool kRegs = WPL <= 2;       // planes and table in registers
    constexpr int kStride = 32 * WPL;      // shared words of one mask
    constexpr int kPR = kRegs ? kPlanes : 1, kPC = kRegs ? WPL : 1;
    constexpr int kTR = kRegs ? kMaxK : 1, kTC = kRegs ? WPL : 1;
    extern __shared__ uint32_t smem[];
    const int row = blockIdx.x;
    const int lane = threadIdx.x;
    const int nw = (n + 31) >> 5;
    const int kk = k > 0 ? k : 1;
    uint32_t* splanes = smem;              // [32][kStride] (!kRegs)
    uint32_t* stable = smem + (kRegs ? 0 : kPlanes * kStride);  // [kk][kStride]
    const uint32_t* xr = x + (size_t)row * n;
    int32_t* ordr = order + (size_t)row * stop;

    uint32_t pl[kPR][kPC];                 // planes (register path)
    uint32_t tm[kTR][kTC];                 // table masks (register path)
#pragma unroll
    for (int s = 0; s < kPR; ++s)
#pragma unroll
        for (int q = 0; q < kPC; ++q) pl[s][q] = 0u;

    // pack the bit planes: word i = o * WPL + q is owned by lane o; the
    // ballot of bit s over the word's 32 elements is its plane-s word
    for (int o = 0; o * WPL < nw; ++o) {
#pragma unroll
        for (int q = 0; q < WPL; ++q) {
            const int i = o * WPL + q;
            if (i >= nw) break;
            const int j = i * 32 + lane;
            const uint32_t v = j < n ? xr[j] : 0u;
            uint32_t mine = 0u;
#pragma unroll
            for (int s = 0; s < kPlanes; ++s) {
                const uint32_t bits = __ballot_sync(kFull, (v >> s) & 1u);
                if (kRegs) {
                    if (lane == o) pl[kRegs ? s : 0][kRegs ? q : 0] = bits;
                } else if (lane == s) {
                    mine = bits;
                }
            }
            if (!kRegs) splanes[lane * kStride + q * 32 + o] = mine;
        }
    }
    __syncwarp();

    uint32_t alive[WPL], srt[WPL], vmask[WPL];
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
        const int i = lane * WPL + q;
        const int rem = n - i * 32;        // valid bits of word i
        vmask[q] = i >= nw ? 0u : (rem >= 32 ? kFull : ((1u << rem) - 1u));
        srt[q] = 0u;
        alive[q] = 0u;
        if (kRegs) {
#pragma unroll
            for (int e = 0; e < kTR; ++e) tm[e][kRegs ? q : 0] = 0u;
        }
    }
    // table entry e: its sig in byte e of tsig, its mask slot (shared path)
    // in nibble e of tslot; scalars, so a push is a shift
    uint64_t tsig = 0u;
    uint32_t tslot = 0x76543210u;
    uint32_t tvalid = 0u;                  // bit e: table entry e is valid
    const uint32_t kkmask = (1u << kk) - 1u;
    const uint64_t sigmask = kk >= 8 ? ~0ull : (1ull << (8 * kk)) - 1u;
    const uint32_t slotmask = kk >= 8 ? kFull : (1u << (4 * kk)) - 1u;
    int s_top = w - 1, count = 0, crs = 0, drains = 0;

    // plane s, the lane's word q; table entry e's mask word q (compile-time
    // indices on the register path: the walk below is unrolled there)
#define COL(s, q) (kRegs ? pl[kRegs ? (s) : 0][kRegs ? (q) : 0] \
                         : splanes[(s) * kStride + (q) * 32 + lane])
#define TMASK(e, q) (kRegs ? tm[kRegs ? (e) : 0][kRegs ? (q) : 0] \
                           : stable[((tslot >> (4 * (e))) & 15u) * kStride \
                                    + (q) * 32 + lane])
    constexpr int kWalkUnroll = kRegs ? kPlanes / F : 1;
    constexpr int kPats = 1 << F;          // patterns of a block's planes
    bool fresh = true, seen = false;
    int start = 0;

    while (count < stop) {
        // --- load: the newest live table entry (one round), else fresh
        uint32_t live = 0u;
        if (tvalid != 0u) {
            uint32_t hit = 0u;
#pragma unroll
            for (int e = 0; e < kMaxK; ++e) {
                if (e < kk) {
                    uint32_t h = 0u;
#pragma unroll
                    for (int q = 0; q < WPL; ++q) h |= TMASK(e, q) & ~srt[q];
                    hit |= nonzero(h) << e;
                }
            }
            live = tvalid & __reduce_or_sync(kFull, hit);
        }
        if (live != 0u) {
            const int first = __ffs(live) - 1;
            start = (int)((tsig >> (8 * first)) & 0xFFu) - 1;
#pragma unroll
            for (int e = 0; e < kMaxK; ++e) {
                if (e == first) {
#pragma unroll
                    for (int q = 0; q < WPL; ++q)
                        alive[q] = TMASK(e, q) & ~srt[q];
                }
            }
            tvalid &= ~((1u << first) - 1u);   // drop the newer entries
            fresh = false;
        } else {
#pragma unroll
            for (int q = 0; q < WPL; ++q) alive[q] = ~srt[q] & vmask[q];
            start = s_top;
            tvalid = 0u;
            fresh = true;
        }

        crs += start + 1;                     // start >= -1
        // --- traverse planes start..0 in blocks of F, one round a block
        // (plane i of the block is base + F - 1 - i)
        seen = false;
        bool lone = false;                 // the walk stopped at one element
#pragma unroll (kWalkUnroll)
        for (int bi = kPlanes / F - 1; bi >= 0; --bi) {
            if (bi * F > start) continue;
            const int base = bi * F;
            // in the same round as the verdicts: the alive count.  A lone
            // element makes every plane from here down uniform, so the rest
            // of the walk would change nothing (its CRs are counted above)
            int here = 0;
#pragma unroll
            for (int q = 0; q < WPL; ++q) here += __popc(alive[q]);
            const bool alone = __reduce_add_sync(kFull, here) <= 1;
            // the set of F-bit patterns (plane i of the block at bit
            // F - 1 - i) that the alive elements show.  A plane is mixed
            // when the patterns still alive show both of its bits; it then
            // keeps those with a 0 there
            uint32_t bits[kPats];
            if (kRegs) {
                uint32_t pm[kPats][WPL];
#pragma unroll
                for (int q = 0; q < WPL; ++q) pm[0][q] = alive[q];
#pragma unroll
                for (int i = 0; i < F; ++i) {
                    const int s = base + F - 1 - i;
#pragma unroll
                    for (int p = kPats - 1; p >= 0; --p) {
                        if (p >= (1 << i)) continue;
#pragma unroll
                        for (int q = 0; q < WPL; ++q) {
                            const uint32_t v = pm[p][q];
                            pm[(2 * p + 1) % kPats][q] = v & COL(s, q);
                            pm[(2 * p) % kPats][q] = v & ~COL(s, q);
                        }
                    }
                }
#pragma unroll
                for (int p = 0; p < kPats; ++p) {
                    uint32_t t = 0u;
#pragma unroll
                    for (int q = 0; q < WPL; ++q) t |= pm[p][q];
                    bits[p] = nonzero(t);
                }
            } else {
                uint32_t t[kPats];
#pragma unroll
                for (int p = 0; p < kPats; ++p) t[p] = 0u;
#pragma unroll
                for (int q = 0; q < WPL; ++q) {
                    uint32_t pm[kPats];
                    pm[0] = alive[q];
#pragma unroll
                    for (int i = 0; i < F; ++i) {
                        const uint32_t c = COL(base + F - 1 - i, q);
#pragma unroll
                        for (int p = kPats - 1; p >= 0; --p) {
                            if (p >= (1 << i)) continue;
                            const uint32_t v = pm[p];
                            pm[(2 * p + 1) % kPats] = v & c;
                            pm[(2 * p) % kPats] = v & ~c;
                        }
                    }
#pragma unroll
                    for (int p = 0; p < kPats; ++p) t[p] |= pm[p];
                }
#pragma unroll
                for (int p = 0; p < kPats; ++p) bits[p] = nonzero(t[p]);
            }
            const uint32_t seen_pats =
                __reduce_or_sync(kFull, pack_bits(bits));
            if (alone) {
                lone = true;
                break;
            }
            const uint32_t mixed = resolve_block(seen_pats, base, start);
            if (mixed == 0u) continue;     // uniform block: alive unchanged
            if (!fresh || k == 0) {
                // no table push: exclude the 1s of every mixed plane at once
#pragma unroll
                for (int q = 0; q < WPL; ++q) {
                    uint32_t ones = 0u;
#pragma unroll
                    for (int i = 0; i < F; ++i)
                        if ((mixed >> i) & 1u) ones |= COL(base + F - 1 - i, q);
                    alive[q] &= ~ones;
                }
            } else {
#pragma unroll
                for (int i = 0; i < F; ++i) {
                    if (((mixed >> i) & 1u) == 0u) continue;
                    const int sig = base + F - 1 - i;
#pragma unroll
                    for (int q = 0; q < WPL; ++q) alive[q] &= ~COL(sig, q);
                    // push (sig, alive) as entry 0: older entries shift on
                    if (kRegs) {
#pragma unroll
                        for (int e = kMaxK - 1; e > 0; --e) {
                            if (e < kk) {
#pragma unroll
                                for (int q = 0; q < WPL; ++q)
                                    tm[kRegs ? e : 0][kRegs ? q : 0] =
                                        tm[kRegs ? e - 1 : 0]
                                          [kRegs ? q : 0];
                            }
                        }
#pragma unroll
                        for (int q = 0; q < WPL; ++q)
                            tm[0][kRegs ? q : 0] = alive[q];
                    } else {
                        // the oldest entry's slot takes the new mask
                        const uint32_t recycled =
                            (tslot >> (4 * (kk - 1))) & 15u;
                        tslot = ((tslot << 4) | recycled) & slotmask;
#pragma unroll
                        for (int q = 0; q < WPL; ++q)
                            stable[recycled * kStride + q * 32 + lane] =
                                alive[q];
                    }
                    tsig = ((tsig << 8) | (uint64_t)sig) & sigmask;
                    tvalid = ((tvalid << 1) | 1u) & kkmask;
                }
            }
            if (fresh && !seen) {
                s_top = base + F - __ffs(mixed);   // the first mixed plane
                seen = true;
            }
        }

        // --- drain the survivors in element order, up to `stop`.  A walk
        // that stopped at a lone element already knows the count (one) and
        // the rank (0): its lane writes it, with no warp round
        if (lone) {
#pragma unroll
            for (int q = 0; q < WPL; ++q) {
                if (alive[q] != 0u)
                    ordr[count] = (lane * WPL + q) * 32 + __ffs(alive[q]) - 1;
                srt[q] |= alive[q];
            }
            ++count;
            continue;
        }
        int mine = 0;
#pragma unroll
        for (int q = 0; q < WPL; ++q) mine += __popc(alive[q]);
        const int m_tot = __reduce_add_sync(kFull, mine);
        const uint32_t holders = __ballot_sync(kFull, mine != 0);
        const int m_eff = min(m_tot, stop - count);
        if (m_eff <= 0) break;                // unreachable: a search always
                                              // keeps a survivor; never spin
        int r = 0;                            // rank of the lane's first
        if (holders & (holders - 1u))         // survivors in several lanes
            r = warp_inclusive_scan(mine, lane) - mine;
        if (mine != 0 && r < m_eff) {
#pragma unroll
            for (int q = 0; q < WPL; ++q) {
                uint32_t a = alive[q], kept = 0u;
                while (a != 0u && r < m_eff) {
                    const int bpos = __ffs(a) - 1;
                    a &= a - 1u;
                    ordr[count + r] = (lane * WPL + q) * 32 + bpos;
                    kept |= 1u << bpos;
                    ++r;
                }
                srt[q] |= kept;
            }
        }
        count += m_eff;
        drains += max(m_eff - 1, 0);
    }

#undef COL
#undef TMASK
    __syncwarp();                             // order[] written by all lanes
    uint32_t* vr = vals + (size_t)row * stop;
    for (int t = lane; t < stop; t += 32) vr[t] = xr[ordr[t]];
    if (lane == 0) {
        crs_out[row] = crs;
        cyc_out[row] = crs + drains;
    }
}


// Row-wide reductions of the dense carrier, whose row is W warps.  Each
// warp reduces with one REDUX; W > 1 warps then meet once in shared memory
// (`xch`, two buffers of [2][W] words) behind one barrier.  The buffers
// alternate (`par`), so one barrier a round suffices: no warp rewrites a
// buffer before every warp has passed the barrier after its last read.

// OR of `bits` and sum of `cnt` over the row
template <int W>
__device__ __forceinline__ void row_or_add(uint32_t& bits, int& cnt,
                                           uint32_t* xch, int& par) {
    bits = __reduce_or_sync(kFull, bits);
    cnt = __reduce_add_sync(kFull, cnt);
    if (W > 1) {
        uint32_t* xb = xch + par * 2 * W;
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) {
            xb[warp] = bits;
            xb[W + warp] = (uint32_t)cnt;
        }
        __syncthreads();
        bits = 0u;
        cnt = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) {
            bits |= xb[i];
            cnt += (int)xb[W + i];
        }
        par ^= 1;
    }
}

// OR of `bits` over the row
template <int W>
__device__ __forceinline__ uint32_t row_or(uint32_t bits, uint32_t* xch,
                                           int& par) {
    bits = __reduce_or_sync(kFull, bits);
    if (W > 1) {
        uint32_t* xb = xch + par * 2 * W;
        if ((threadIdx.x & 31) == 0) xb[threadIdx.x >> 5] = bits;
        __syncthreads();
        bits = 0u;
#pragma unroll
        for (int i = 0; i < W; ++i) bits |= xb[i];
        par ^= 1;
    }
    return bits;
}

// The row's sum of `mine` (into `total`) and this thread's exclusive
// prefix of it in thread order: a drain's rank.  One warp skips the scan
// when a single lane holds every survivor (a ballot says so)
template <int W>
__device__ __forceinline__ int row_rank(int mine, int& total, uint32_t* xch,
                                        int& par) {
    const int lane = threadIdx.x & 31;
    if (W == 1) {
        total = __reduce_add_sync(kFull, mine);
        const uint32_t holders = __ballot_sync(kFull, mine != 0);
        return (holders & (holders - 1u))
                   ? warp_inclusive_scan(mine, lane) - mine : 0;
    }
    const int incl = warp_inclusive_scan(mine, lane);
    uint32_t* xb = xch + par * 2 * W;
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

// Dense carrier (see the note at the head of this file).  Thread t of the
// row's 32 * W holds elements t * c .. t * c + c - 1.  C = c at compile
// time (a multiple of 4: values in registers, flags one byte an element,
// four to a register), or 0 for the rolled instance (one warp; values and
// flag bytes in shared memory, lane-interleaved).  kRegTab: the table
// masks (k <= kRegTable) live in registers too, else in shared memory.
template <int C, bool kRegTab, int W>
__global__ void __launch_bounds__(32 * W)
colskip_dense_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ vals,
                     int32_t* __restrict__ order, int32_t* __restrict__ crs_out,
                     int32_t* __restrict__ cyc_out, int n, int w, int k,
                     int stop) {
    static_assert(C % 4 == 0 && (C > 0 || (W == 1 && !kRegTab)),
                  "register instances hold whole flag words");
    using Unit = typename std::conditional<C == 0, uint8_t, uint32_t>::type;
    constexpr int T = 32 * W;              // threads a row
    constexpr int E = C ? 4 : 1;           // elements a flag unit holds
    constexpr uint32_t kOne = C ? 0x01010101u : 0x01u;  // a unit's flags
    constexpr int kPats = 1 << kFuse;
    constexpr int kTE = kRegTab ? kRegTable : 1;
    extern __shared__ uint32_t smem[];
    const int row = blockIdx.x;
    const int t = threadIdx.x;
    const int c = C ? C : (n + T - 1) / T;      // elements a thread
    const int U = C ? C / 4 : c;                // flag units a thread
    const int kk = k > 0 ? k : 1;
    // shared memory: values, alive and sorted flags (rolled), the table
    // (!kRegTab), the exchange words (W > 1); slot [i][t] is i * T + t
    uint32_t* sv = smem;                                     // [c][T]
    Unit* sa = reinterpret_cast<Unit*>(smem + (C ? 0 : c * T));  // [U][T]
    Unit* ss = sa + (C ? 0 : U * T);                         // [U][T]
    Unit* stab = ss + (C ? 0 : U * T);                       // [kk][U][T]
    uint32_t* xch = reinterpret_cast<uint32_t*>(stab + (kRegTab ? 0 : kk * U * T));
    const uint32_t* xr = x + (size_t)row * n;
    int32_t* ordr = order + (size_t)row * stop;
    const int first_el = t * c;

    uint32_t v[C ? C : 1];                 // values (register instances)
    Unit ra[C ? C / 4 : 1], rs[C ? C / 4 : 1];    // alive, sorted flags
    Unit rt[kTE][kRegTab ? C / 4 : 1];     // table masks (kRegTab)
    // table entry e: its sig in byte e of tsig, its mask slot (shared
    // table) in nibble e of tslot; scalars, so a push is a shift
    uint64_t tsig = 0u;
    uint32_t tslot = 0x76543210u;
#define DV(e) (C ? v[C ? (e) : 0] : sv[(e) * T + t])
#define DA(u) (C ? ra[C ? (u) : 0] : sa[(u) * T + t])
#define DS(u) (C ? rs[C ? (u) : 0] : ss[(u) * T + t])
#define DT(e, u) (kRegTab ? rt[kRegTab ? (e) : 0][kRegTab ? (u) : 0] \
                          : stab[(((tslot >> (4 * (e))) & 15u) * U + (u)) * T + t])

    if constexpr (C > 0) {
#pragma unroll
        for (int e = 0; e < C; ++e) {
            const int j = first_el + e;
            v[e] = j < n ? xr[j] : 0u;
        }
    } else {
        // coalesced: element j of the row is thread j / c's element j % c
        for (int j = t; j < c * T; j += T)
            sv[(j % c) * T + j / c] = j < n ? xr[j] : 0u;
    }
    // padding elements count as sorted, so they are never alive
#pragma unroll
    for (int u = 0; u < U; ++u) {
        uint32_t s = 0u;
#pragma unroll
        for (int j = 0; j < E; ++j)
            if (first_el + u * E + j >= n) s |= 1u << (8 * j);
        DS(u) = (Unit)s;
    }
    if (!C) __syncwarp();                  // values written across lanes

    uint32_t tvalid = 0u;                  // bit e: table entry e is valid
    const uint32_t kkmask = (1u << kk) - 1u;
    const uint64_t sigmask = kk >= 8 ? ~0ull : (1ull << (8 * kk)) - 1u;
    const uint32_t slotmask = kk >= 8 ? kFull : (1u << (4 * kk)) - 1u;
    int s_top = w - 1, count = 0, crs = 0, drains = 0, par = 0;
    bool fresh = true;
    int start = 0;

    while (count < stop) {
        // --- load: the newest live table entry (one round), else fresh
        uint32_t live = 0u;
        if (tvalid != 0u) {
            uint32_t hit = 0u;
#pragma unroll
            for (int e = 0; e < (kRegTab ? kRegTable : kMaxK); ++e) {
                if (e < kk) {
                    uint32_t h = 0u;
#pragma unroll
                    for (int u = 0; u < U; ++u) h |= DT(e, u) & ~DS(u);
                    hit |= nonzero(h) << e;
                }
            }
            live = tvalid & row_or<W>(hit, xch, par);
        }
        if (live != 0u) {
            const int first = __ffs(live) - 1;
            start = (int)((tsig >> (8 * first)) & 0xFFu) - 1;
            if constexpr (kRegTab) {
#pragma unroll
                for (int e = 0; e < kRegTable; ++e)
                    if (e == first) {
#pragma unroll
                        for (int u = 0; u < U; ++u)
                            DA(u) = DT(e, u) & ~DS(u);
                    }
            } else {
#pragma unroll
                for (int u = 0; u < U; ++u) DA(u) = DT(first, u) & ~DS(u);
            }
            tvalid &= ~((1u << first) - 1u);   // drop the newer entries
            fresh = false;
        } else {
#pragma unroll
            for (int u = 0; u < U; ++u) DA(u) = ~DS(u) & kOne;
            start = s_top;
            tvalid = 0u;
            fresh = true;
        }

        crs += start + 1;                     // start >= -1
        // --- traverse planes start..0 in blocks of kFuse, one round a
        // block: each thread ORs the one-hot pattern of every alive
        // element (a column read is (v >> sig) & 1 of its value), and the
        // alive count rides in the same round
        bool seen = false, lone = false;
        for (int bi = start >= 0 ? start / kFuse : -1; bi >= 0; --bi) {
            const int base = bi * kFuse;
            uint32_t pats = 0u;
            int here = 0;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const uint32_t a = DA(u);
                here += __popc(a);
#pragma unroll
                for (int j = 0; j < E; ++j)
                    pats |= ((a >> (8 * j)) & 1u)
                            << ((DV(u * E + j) >> base) & (kPats - 1));
            }
            row_or_add<W>(pats, here, xch, par);
            // a lone element makes every plane from here down uniform
            if (here <= 1) {
                lone = true;
                break;
            }
            const uint32_t mixed = resolve_block(pats, base, start);
            if (mixed == 0u) continue;     // uniform block: alive unchanged
            // mixed planes as bits of a pattern (plane i at F - 1 - i)
            uint32_t mp = 0u;
#pragma unroll
            for (int i = 0; i < kFuse; ++i)
                mp |= ((mixed >> i) & 1u) << (kFuse - 1 - i);
            if (!fresh || k == 0) {
                // no table push: exclude the 1s of every mixed plane at once
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    uint32_t keep = 0u;
#pragma unroll
                    for (int j = 0; j < E; ++j)
                        keep |= (uint32_t)(((DV(u * E + j) >> base) & mp) == 0u)
                                << (8 * j);
                    DA(u) &= keep;
                }
            } else {
#pragma unroll
                for (int i = 0; i < kFuse; ++i) {
                    if (((mixed >> i) & 1u) == 0u) continue;
                    const int sig = base + kFuse - 1 - i;
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        uint32_t keep = 0u;
#pragma unroll
                        for (int j = 0; j < E; ++j)
                            keep |= (~(DV(u * E + j) >> sig) & 1u) << (8 * j);
                        DA(u) &= keep;
                    }
                    // push (sig, alive) as entry 0: older entries shift on
                    if constexpr (kRegTab) {
#pragma unroll
                        for (int e = kRegTable - 1; e > 0; --e)
#pragma unroll
                            for (int u = 0; u < U; ++u) DT(e, u) = DT(e - 1, u);
#pragma unroll
                        for (int u = 0; u < U; ++u) DT(0, u) = DA(u);
                    } else {
                        // the oldest entry's slot takes the new mask
                        const uint32_t recycled =
                            (tslot >> (4 * (kk - 1))) & 15u;
                        tslot = ((tslot << 4) | recycled) & slotmask;
#pragma unroll
                        for (int u = 0; u < U; ++u) DT(0, u) = DA(u);
                    }
                    tsig = ((tsig << 8) | (uint64_t)sig) & sigmask;
                    tvalid = ((tvalid << 1) | 1u) & kkmask;
                }
            }
            if (fresh && !seen) {
                s_top = base + kFuse - __ffs(mixed);   // the first mixed plane
                seen = true;
            }
        }

        // --- drain the survivors in element order, up to `stop`.  A walk
        // that stopped at a lone element already knows the count (one) and
        // the rank (0): its thread writes it, with no round
        if (lone) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const uint32_t a = DA(u);
                if (a != 0u)
                    ordr[count] = first_el + u * E + ((__ffs(a) - 1) >> 3);
                DS(u) |= a;
            }
            ++count;
            continue;
        }
        int mine = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) mine += __popc(DA(u));
        int m_tot = 0;
        int r = row_rank<W>(mine, m_tot, xch, par);   // rank of the first
        const int m_eff = min(m_tot, stop - count);
        if (m_eff <= 0) break;                // unreachable: a search always
                                              // keeps a survivor; never spin
        if (mine != 0 && r < m_eff) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                uint32_t a = DA(u), kept = 0u;
                while (a != 0u && r < m_eff) {
                    const int bpos = __ffs(a) - 1;
                    a &= a - 1u;
                    ordr[count + r] = first_el + u * E + (bpos >> 3);
                    kept |= 1u << bpos;
                    ++r;
                }
                DS(u) |= kept;
            }
        }
        count += m_eff;
        drains += max(m_eff - 1, 0);
    }
#undef DV
#undef DA
#undef DS
#undef DT

    if (W > 1) __syncthreads(); else __syncwarp();   // order[] written
    uint32_t* vr = vals + (size_t)row * stop;
    for (int j = t; j < stop; j += T) vr[j] = xr[ordr[j]];
    if (t == 0) {
        crs_out[row] = crs;
        cyc_out[row] = crs + drains;
    }
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
    const int masks = WPL <= 2 ? 0 : kPlanes + kk;
    const size_t smem = (size_t)masks * 32 * WPL * sizeof(uint32_t);
    if (WPL > 2) {
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
    size_t smem = W > 1 ? 4 * W * sizeof(uint32_t) : 0;   // exchange words
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
