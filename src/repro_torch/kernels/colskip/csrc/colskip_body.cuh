// The §III machine of a colskip row on both mask carriers, shared by the
// single-bank kernels of colskip.cu and the mesh kernels of
// colskip_mesh.cu, as the reference's carriers and its bank realizations
// share colskip_machine (repro/kernels/colskip/kernel.py:54-90).
//
// A row body runs on the threads of one bank (one CTA) and reaches the
// rest of the row only through its Gate, the §IV manager's combine points:
//
//   * g.any(bits): OR of a per-thread word over the row's threads (the SL
//     gate of a load: each table entry's still-live bit);
//   * g.patterns(pats, cnt): OR of the words `pats` and sum of `cnt` over
//     the row, in one round (a fused block's set of F-bit patterns, 2^F
//     bits in pat_words(F) words, and the alive count);
//   * g.rank(mine, total): this thread's exclusive prefix of `mine` in
//     element order over the row (bank-major, then thread order) and the
//     row's total (a drain's rank and survivor count);
//   * g.done(): the barrier after which every thread of the row sees the
//     order[] written by all of them; g.bank, g.banks, g.lead() place the
//     values gather and the counters' write.
//
// For one bank (colskip.cu) the gates are warp reductions (and one
// shared-memory meeting of the warps); for a mesh (colskip_mesh.cu) each
// is one exchange between the CTAs of a cluster.  Every verdict comes out
// of a gate, so every bank of a row takes the same decisions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 8;        // deepest state table the kernels hold
constexpr int kPlanes = 32;     // bit planes packed per row (w <= 32)
constexpr int kRegTable = 2;    // dense: table entries held in registers

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

// Words of a block's pattern set: 2^F bits, pattern p at bit p % 32 of
// word p / 32 (one word up to F = 5; 2, 4 and 8 words at F = 6, 7, 8).
__host__ __device__ constexpr int pat_words(int f) {
    return f <= 5 ? 1 : 1 << (f - 5);
}

// Word h of the set of F-bit patterns (plane i of a block at bit F - 1 - i)
// whose bit j is set.
__host__ __device__ constexpr uint32_t pattern_mask(int f, int j, int h) {
    uint32_t m = 0u;
    for (int b = 0; b < 32; ++b) {
        const int p = 32 * h + b;
        if (p < (1 << f) && ((p >> j) & 1)) m |= 1u << b;
    }
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

// The verdicts of one block of F planes (plane i of the block is
// base + F - 1 - i) from the set of F-bit patterns that the block's alive
// elements show (plane i at bit F - 1 - i of a pattern).  Bit i of the
// result is set when plane i is active (at or below `start`) and mixed:
// the patterns still alive show both of its bits; a mixed plane then keeps
// those with a 0 there.  A plane above 31 (the top block when F does not
// divide 32) is above every start, so never active.  Both carriers resolve
// their blocks here, as the reference's carriers share _traverse_planes.
template <int F>
__device__ __forceinline__ uint32_t resolve_block(
        const uint32_t (&set)[pat_words(F)], int base, int start) {
    constexpr int NW = pat_words(F);
    uint32_t pats[NW];
#pragma unroll
    for (int h = 0; h < NW; ++h) pats[h] = set[h];
    uint32_t mixed = 0u;
#pragma unroll
    for (int i = 0; i < F; ++i) {
        uint32_t ones = 0u, zeros = 0u;
#pragma unroll
        for (int h = 0; h < NW; ++h) {
            ones |= pats[h] & pattern_mask(F, F - 1 - i, h);
            zeros |= pats[h] & ~pattern_mask(F, F - 1 - i, h);
        }
        const bool on = base + F - 1 - i <= start && ones != 0u &&
                        zeros != 0u;
#pragma unroll
        for (int h = 0; h < NW; ++h)
            pats[h] = on ? pats[h] & ~pattern_mask(F, F - 1 - i, h) : pats[h];
        mixed |= (uint32_t)on << i;
    }
    return mixed;
}

// The packed carrier keeps planes and table masks in registers (and
// unrolls its block walk) up to WPL = 2 words a lane and F = 4 planes a
// block; past either, in shared memory ([32 + kk] masks of 32 * WPL
// words), with the walk rolled.  (At F > 4 the unrolled walk's pattern
// trees spill and take minutes of ptxas.)
__host__ __device__ constexpr bool packed_in_registers(int wpl, int f) {
    return wpl <= 2 && f <= 4;
}

// The bits of `alive` (one packed word) whose top kHi planes of the block
// at `base` (planes base + F - 1 .. base + F - kHi) read h, top plane
// first; col(s) is the word's plane s.
template <int F, int kHi, class Col>
__device__ __forceinline__ uint32_t select_high(uint32_t alive, int h,
                                                Col col, int base) {
#pragma unroll
    for (int i = 0; i < kHi; ++i) {
        const uint32_t c = col(base + F - 1 - i);
        alive &= ((h >> (kHi - 1 - i)) & 1) ? c : ~c;
    }
    return alive;
}

// Packed carrier, one warp a bank.  The bank holds `nl` elements of the
// row at xr (columns col0 ..), lane l the packed words l * WPL .. l * WPL
// + WPL - 1 (word i holds elements 32i .. 32i + 31).  On the register
// path (packed_in_registers) the planes and the table masks live in
// registers and the block walk is unrolled; otherwise they live in shared
// memory (`smem`) and the walk is rolled.  Writes order[] (in
// row columns) for the elements it drains; returns the row's CRs and
// drains (the same in every bank).
//
// Blocks are aligned at multiples of F, ceil(32 / F) of them; when F does
// not divide 32 the top block runs past plane 31, and such a plane reads
// as a zero column (never active: resolve_block).  A search from `start`
// walks floor(start / F) + 1 blocks, at most ceil(w / F).
template <int WPL, int F, class Gate>
__device__ __forceinline__ void packed_row(
        Gate& g, const uint32_t* __restrict__ xr, int32_t* __restrict__ ordr,
        int nl, int col0, int w, int k, int stop, uint32_t* smem,
        int& crs_out, int& drains_out) {
    static_assert(F >= 1 && F <= 8, "a block of 1 to 8 planes");
    constexpr bool kRegs = packed_in_registers(WPL, F);
    constexpr int kStride = 32 * WPL;      // shared words of one mask
    constexpr int kPR = kRegs ? kPlanes : 1, kPC = kRegs ? WPL : 1;
    constexpr int kTR = kRegs ? kMaxK : 1, kTC = kRegs ? WPL : 1;
    const int lane = threadIdx.x & 31;
    const int nw = (nl + 31) >> 5;
    const int kk = k > 0 ? k : 1;
    uint32_t* splanes = smem;              // [32][kStride] (!kRegs)
    uint32_t* stable = smem + (kRegs ? 0 : kPlanes * kStride);  // [kk][kStride]

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
            const uint32_t v = j < nl ? xr[j] : 0u;
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
        const int rem = nl - i * 32;       // valid bits of word i
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

    // plane s, the lane's word q (zero above plane 31); table entry e's
    // mask word q (compile-time indices on the register path: the walk
    // below is unrolled there)
#define COL(s, q) ((s) >= kPlanes ? 0u                                     \
                   : kRegs ? pl[kRegs && (s) < kPlanes ? (s) : 0]          \
                               [kRegs ? (q) : 0]                           \
                           : splanes[(s) * kStride + (q) * 32 + lane])
#define TMASK(e, q) (kRegs ? tm[kRegs ? (e) : 0][kRegs ? (q) : 0] \
                           : stable[((tslot >> (4 * (e))) & 15u) * kStride \
                                    + (q) * 32 + lane])
    constexpr int kBlocks = (kPlanes + F - 1) / F;
    constexpr int kWalkUnroll = kRegs ? kBlocks : 1;
    // a block's pattern set is built kT <= 4 planes at a time: each of the
    // 2^kHi settings of its top kHi planes selects the alive elements that
    // show it, and a tree over the low kT planes gives their 2^kT patterns,
    // so the registers do not grow with 2^F
    constexpr int kT = F < 4 ? F : 4, kHi = F - kT;
    constexpr int kPats = 1 << kT;         // patterns of a subset
    constexpr int kNW = pat_words(F);
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
            live = tvalid & g.any(hit);
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
        for (int bi = kBlocks - 1; bi >= 0; --bi) {
            if (bi * F > start) continue;
            const int base = bi * F;
            // in the same round as the verdicts: the alive count.  A lone
            // element makes every plane from here down uniform, so the rest
            // of the walk would change nothing (its CRs are counted above)
            int here = 0;
#pragma unroll
            for (int q = 0; q < WPL; ++q) here += __popc(alive[q]);
            // the set of F-bit patterns (plane i of the block at bit
            // F - 1 - i) that the alive elements show.  A plane is mixed
            // when the patterns still alive show both of its bits; it then
            // keeps those with a 0 there
            uint32_t seen_pats[kNW];
#pragma unroll
            for (int h = 0; h < kNW; ++h) seen_pats[h] = 0u;
#pragma unroll
            // the lane's word q of the alive elements whose top kHi planes
            // read h
#define SEL(h, q) select_high<F, kHi>(alive[q], h, [&](int s) {     \
                      return COL(s, q); }, base)
            // (rolled: unrolled over 2^kHi subsets, and 32 words a lane
            // on the shared path, a block took ptxas a minute at F = 8)
#pragma unroll 1
            for (int h = 0; h < (1 << kHi); ++h) {
                uint32_t bits[kPats];
                if (kRegs) {
                    uint32_t pm[kPats][WPL];
#pragma unroll
                    for (int q = 0; q < WPL; ++q) pm[0][q] = SEL(h, q);
#pragma unroll
                    for (int i = 0; i < kT; ++i) {
                        const int s = base + kT - 1 - i;
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
                        pm[0] = SEL(h, q);
#pragma unroll
                        for (int i = 0; i < kT; ++i) {
                            const uint32_t c = COL(base + kT - 1 - i, q);
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
                // patterns h * 2^kT .. of the set (word h * 2^kT / 32)
                const uint32_t word = pack_bits(bits) << ((h * kPats) & 31);
#pragma unroll
                for (int i = 0; i < kNW; ++i)
                    seen_pats[i] |= i == (h * kPats) >> 5 ? word : 0u;
            }
#undef SEL
            g.patterns(seen_pats, here);
            if (here <= 1) {
                lone = true;
                break;
            }
            const uint32_t mixed = resolve_block<F>(seen_pats, base, start);
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
        // the rank (0): its lane writes it, with no round
        if (lone) {
#pragma unroll
            for (int q = 0; q < WPL; ++q) {
                if (alive[q] != 0u)
                    ordr[count] = col0 + (lane * WPL + q) * 32 +
                                  __ffs(alive[q]) - 1;
                srt[q] |= alive[q];
            }
            ++count;
            continue;
        }
        int mine = 0;
#pragma unroll
        for (int q = 0; q < WPL; ++q) mine += __popc(alive[q]);
        int m_tot = 0;
        int r = g.rank(mine, m_tot);          // rank of the lane's first
        const int m_eff = min(m_tot, stop - count);
        if (m_eff <= 0) break;                // unreachable: a search always
                                              // keeps a survivor; never spin
        if (mine != 0 && r < m_eff) {
#pragma unroll
            for (int q = 0; q < WPL; ++q) {
                uint32_t a = alive[q], kept = 0u;
                while (a != 0u && r < m_eff) {
                    const int bpos = __ffs(a) - 1;
                    a &= a - 1u;
                    ordr[count + r] = col0 + (lane * WPL + q) * 32 + bpos;
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
    crs_out = crs;
    drains_out = drains;
}

// Dense carrier (see colskip.cu's head), W warps a bank.  Thread t of the
// bank's 32 * W holds its elements t * c .. t * c + c - 1.  C = c at
// compile time (a multiple of 4: values in registers, flags one byte an
// element, four to a register), or 0 for the rolled instance (one warp;
// values and flag bytes in shared memory `smem`, lane-interleaved, slot
// [i][t] at i * T + t).  kRegTab: the table masks (k <= kRegTable) live in
// registers too, else in shared memory.  Writes order[] (in row columns)
// for the elements it drains; returns the row's CRs and drains.
template <int C, bool kRegTab, int W, int F, class Gate>
__device__ __forceinline__ void dense_row(
        Gate& g, const uint32_t* __restrict__ xr, int32_t* __restrict__ ordr,
        int nl, int col0, int w, int k, int stop, uint32_t* smem,
        int& crs_out, int& drains_out) {
    static_assert(C % 4 == 0 && (C > 0 || (W == 1 && !kRegTab)),
                  "register instances hold whole flag words");
    using Unit = typename std::conditional<C == 0, uint8_t, uint32_t>::type;
    constexpr int T = 32 * W;              // threads a bank
    constexpr int E = C ? 4 : 1;           // elements a flag unit holds
    constexpr uint32_t kOne = C ? 0x01010101u : 0x01u;  // a unit's flags
    constexpr uint32_t kPatMask = (1u << F) - 1u;  // a block's F bits
    constexpr int kNW = pat_words(F);
    constexpr int kTE = kRegTab ? kRegTable : 1;
    const int t = threadIdx.x;
    const int c = C ? C : (nl + T - 1) / T;     // elements a thread
    const int U = C ? C / 4 : c;                // flag units a thread
    const int kk = k > 0 ? k : 1;
    // shared memory: values, alive and sorted flags (rolled), the table
    // (!kRegTab); slot [i][t] is i * T + t
    uint32_t* sv = smem;                                     // [c][T]
    Unit* sa = reinterpret_cast<Unit*>(smem + (C ? 0 : c * T));  // [U][T]
    Unit* ss = sa + (C ? 0 : U * T);                         // [U][T]
    Unit* stab = ss + (C ? 0 : U * T);                       // [kk][U][T]
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
            v[e] = j < nl ? xr[j] : 0u;
        }
    } else {
        // coalesced: element j of the bank is thread j / c's element j % c
        for (int j = t; j < c * T; j += T)
            sv[(j % c) * T + j / c] = j < nl ? xr[j] : 0u;
    }
    // padding elements count as sorted, so they are never alive
#pragma unroll
    for (int u = 0; u < U; ++u) {
        uint32_t s = 0u;
#pragma unroll
        for (int j = 0; j < E; ++j)
            if (first_el + u * E + j >= nl) s |= 1u << (8 * j);
        DS(u) = (Unit)s;
    }
    if (!C) __syncwarp();                  // values written across lanes

    uint32_t tvalid = 0u;                  // bit e: table entry e is valid
    const uint32_t kkmask = (1u << kk) - 1u;
    const uint64_t sigmask = kk >= 8 ? ~0ull : (1ull << (8 * kk)) - 1u;
    const uint32_t slotmask = kk >= 8 ? kFull : (1u << (4 * kk)) - 1u;
    int s_top = w - 1, count = 0, crs = 0, drains = 0;
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
            live = tvalid & g.any(hit);
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
        // --- traverse planes start..0 in blocks of F aligned at multiples
        // of F (a plane above 31 reads 0), one round a block: each thread
        // ORs the one-hot pattern of every alive element (a column read is
        // (v >> sig) & 1 of its value) into the block's pattern set, and
        // the alive count rides in the same round
        bool seen = false, lone = false;
        for (int bi = start >= 0 ? start / F : -1; bi >= 0; --bi) {
            const int base = bi * F;
            uint32_t pats[kNW];
#pragma unroll
            for (int h = 0; h < kNW; ++h) pats[h] = 0u;
            int here = 0;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const uint32_t a = DA(u);
                here += __popc(a);
#pragma unroll
                for (int j = 0; j < E; ++j) {
                    const uint32_t p = (DV(u * E + j) >> base) & kPatMask;
                    const uint32_t on = (a >> (8 * j)) & 1u;
#pragma unroll
                    for (int h = 0; h < kNW; ++h)
                        pats[h] |= (kNW == 1 || (p >> 5) == (uint32_t)h
                                        ? on : 0u) << (p & 31u);
                }
            }
            g.patterns(pats, here);
            // a lone element makes every plane from here down uniform
            if (here <= 1) {
                lone = true;
                break;
            }
            const uint32_t mixed = resolve_block<F>(pats, base, start);
            if (mixed == 0u) continue;     // uniform block: alive unchanged
            // mixed planes as bits of a pattern (plane i at F - 1 - i)
            uint32_t mp = 0u;
#pragma unroll
            for (int i = 0; i < F; ++i)
                mp |= ((mixed >> i) & 1u) << (F - 1 - i);
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
                for (int i = 0; i < F; ++i) {
                    if (((mixed >> i) & 1u) == 0u) continue;
                    const int sig = base + F - 1 - i;
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
                s_top = base + F - __ffs(mixed);   // the first mixed plane
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
                    ordr[count] = col0 + first_el + u * E +
                                  ((__ffs(a) - 1) >> 3);
                DS(u) |= a;
            }
            ++count;
            continue;
        }
        int mine = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) mine += __popc(DA(u));
        int m_tot = 0;
        int r = g.rank(mine, m_tot);          // rank of the thread's first
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
                    ordr[count + r] = col0 + first_el + u * E + (bpos >> 3);
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
    crs_out = crs;
    drains_out = drains;
}

// The row's epilogue, after g.done(): values gathered through order[]
// (split over the row's banks), CRs and cycles by the row's lead thread.
template <class Gate>
__device__ __forceinline__ void finish_row(
        Gate& g, const uint32_t* __restrict__ xrow, uint32_t* __restrict__ vr,
        const int32_t* __restrict__ ordr, int stop, int crs, int drains,
        int32_t* crs_out, int32_t* cyc_out, int row) {
    const int T = blockDim.x;
    for (int j = g.bank * T + (int)threadIdx.x; j < stop; j += g.banks * T)
        vr[j] = xrow[ordr[j]];
    if (g.lead()) {
        crs_out[row] = crs;
        cyc_out[row] = crs + drains;
    }
}

}  // namespace
