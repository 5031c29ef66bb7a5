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
// kernel's, as the reference's two carriers equal each other.  Design:
//
//   * one warp per row; lane l owns the contiguous chunk of C = ceil(N/32)
//     elements [l*C, l*C + C), so a drain rank is the lane's running
//     count plus a warp exclusive scan (the reference's cumsum runs in
//     element order);
//   * the row's values stay in shared memory, and the alive, sorted and
//     k table masks are one byte per element there ((4 + 2 + kk) bytes an
//     element: 28 KB at N=2048, k=8).  Storage is lane-interleaved:
//     element l*C + i sits in slot i*32 + l, so the warp touches 32
//     consecutive words or bytes at each step (no bank conflicts) and
//     every lane reads and writes only its own slots (no barriers);
//   * a column read is (v >> sig) & 1 over the lane's alive elements,
//     then __any_sync on the saw-a-1 and saw-a-0 predicates;
//   * table entries live in physical mask slots named by warp-uniform
//     registers, so a push writes one mask and renames the rest.
//
// It walks one plane per round (two votes a CR), and each CR costs a lane
// C shifts and byte reads instead of one word.  colskip_max_n() gives the
// widest row its shared memory holds on the current card; a wider row is
// refused, never split.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 8;        // deepest state table the kernel holds
#ifndef COLSKIP_FUSE
#define COLSKIP_FUSE 2
#endif
constexpr int kFuse = COLSKIP_FUSE;     // planes resolved per verdict round
constexpr int kPlanes = 32;     // bit planes packed per row (w <= 32)
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
            uint32_t mixed = 0u;           // bit i: plane i mixed
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
            uint32_t seen_pats = __reduce_or_sync(kFull, pack_bits(bits));
            if (alone) {
                lone = true;
                break;
            }
#pragma unroll
            for (int i = 0; i < F; ++i) {
                const uint32_t has1 = pattern_mask(F, F - 1 - i);
                const uint32_t ones = seen_pats & has1;
                const uint32_t zeros = seen_pats & ~has1;
                const bool on = base + F - 1 - i <= start && ones != 0u &&
                                zeros != 0u;
                seen_pats = on ? zeros : seen_pats;
                mixed |= (uint32_t)on << i;
            }
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


// Dense carrier: masks as bytes in shared memory, one warp per row (see
// the note at the head of this file).
__global__ void __launch_bounds__(32)
colskip_dense_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ vals,
                     int32_t* __restrict__ order, int32_t* __restrict__ crs_out,
                     int32_t* __restrict__ cyc_out, int n, int w, int k,
                     int stop) {
    extern __shared__ uint32_t smem[];
    const int row = blockIdx.x;
    const int lane = threadIdx.x;
    const int c = (n + 31) >> 5;           // elements per lane
    const int s = c * 32;                  // slots
    const int kk = k > 0 ? k : 1;
    uint32_t* sv = smem;                                   // [s] values
    uint8_t* alive = reinterpret_cast<uint8_t*>(smem + s); // [s]
    uint8_t* srt = alive + s;                              // [s] sorted
    uint8_t* tm = srt + s;                                 // [kk][s] table
    const uint32_t* xr = x + (size_t)row * n;
    int32_t* ordr = order + (size_t)row * stop;

    // element j (lane j / c, position j % c) -> slot (j % c) * 32 + j / c;
    // padding slots count as sorted, so they are never alive
    for (int j = lane; j < s; j += 32) {
        const int q = (j % c) * 32 + j / c;
        sv[q] = j < n ? xr[j] : 0u;
        srt[q] = j < n ? 0 : 1;
    }
    __syncwarp();

    int tsig[kMaxK], tslot[kMaxK];         // entry e -> (sig, mask slot)
#pragma unroll
    for (int e = 0; e < kMaxK; ++e) {
        tsig[e] = 0;
        tslot[e] = e;
    }
    uint32_t tvalid = 0u;                  // bit e: table entry e is valid
    const uint32_t kkmask = (kk >= 32) ? kFull : ((1u << kk) - 1u);
    int s_top = w - 1, count = 0, crs = 0, drains = 0;

    while (count < stop) {
        // --- load: the newest live table entry, else a fresh search
        int first = -1, fslot = 0, fsig = 0;
#pragma unroll
        for (int e = 0; e < kMaxK; ++e) {
            if (e < kk && first < 0 && ((tvalid >> e) & 1u)) {
                const uint8_t* m = tm + (size_t)tslot[e] * s;
                bool h = false;
                for (int i = 0; i < c; ++i) {
                    const int q = i * 32 + lane;
                    h |= (m[q] & (srt[q] ^ 1)) != 0;
                }
                if (__any_sync(kFull, h)) {
                    first = e;
                    fslot = tslot[e];
                    fsig = tsig[e];
                }
            }
        }
        int start;
        bool fresh;
        if (first >= 0) {
            const uint8_t* m = tm + (size_t)fslot * s;
            for (int i = 0; i < c; ++i) {
                const int q = i * 32 + lane;
                alive[q] = m[q] & (srt[q] ^ 1);
            }
            start = fsig - 1;
            tvalid &= ~((1u << first) - 1u);   // drop the newer entries
            fresh = false;
        } else {
            for (int i = 0; i < c; ++i) {
                const int q = i * 32 + lane;
                alive[q] = srt[q] ^ 1;
            }
            start = s_top;
            tvalid = 0u;
            fresh = true;
        }

        // --- traverse planes start..0, one CR each
        bool seen = false;
        for (int sig = start; sig >= 0; --sig) {
            bool t1 = false, t0 = false;
            for (int i = 0; i < c; ++i) {
                const int q = i * 32 + lane;
                if (alive[q]) {
                    const bool bit = (sv[q] >> sig) & 1u;
                    t1 |= bit;
                    t0 |= !bit;
                }
            }
            const bool p1 = __any_sync(kFull, t1);
            const bool p0 = __any_sync(kFull, t0);
            if (p1 && p0) {                   // mixed column: exclude the 1s
                for (int i = 0; i < c; ++i) {
                    const int q = i * 32 + lane;
                    if (alive[q] && ((sv[q] >> sig) & 1u)) alive[q] = 0;
                }
                if (fresh) {
                    if (k > 0) {              // push (sig, alive) as entry 0
                        int recycled = 0;     // the oldest entry's slot
#pragma unroll
                        for (int e = 0; e < kMaxK; ++e)
                            if (e == kk - 1) recycled = tslot[e];
#pragma unroll
                        for (int e = kMaxK - 1; e > 0; --e) {
                            if (e < kk) {
                                tsig[e] = tsig[e - 1];
                                tslot[e] = tslot[e - 1];
                            }
                        }
                        tsig[0] = sig;
                        tslot[0] = recycled;
                        uint8_t* m = tm + (size_t)recycled * s;
                        for (int i = 0; i < c; ++i) {
                            const int q = i * 32 + lane;
                            m[q] = alive[q];
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

        // --- drain the survivors in element order, up to `stop`
        int mine = 0;
        for (int i = 0; i < c; ++i) mine += alive[i * 32 + lane];
        const int incl = warp_inclusive_scan(mine, lane);
        const int m_tot = __shfl_sync(kFull, incl, 31);
        const int m_eff = min(m_tot, stop - count);
        if (m_eff <= 0) break;                // unreachable: a search always
                                              // keeps a survivor; never spin
        int r = incl - mine;                  // rank of the lane's first
        for (int i = 0; i < c && r < m_eff; ++i) {
            const int q = i * 32 + lane;
            if (alive[q]) {
                ordr[count + r] = lane * c + i;
                srt[q] = 1;
                ++r;
            }
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
    if (!packed) {
        const int kk = k > 0 ? k : 1;
        const size_t slots = (size_t)((n + 31) / 32) * 32;
        const size_t smem = slots * (4 + 2 + kk);
        static std::atomic<bool> done[kMaxDevices];
        int dev = 0, optin = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = allow_smem(colskip_dense_kernel, optin, done);
        if (err != cudaSuccess) return (int)err;
        colskip_dense_kernel<<<b, 32, smem, st>>>(xs, vs, os, cs, ys, n, w, k,
                                                  stop);
        return (int)cudaGetLastError();
    }
    const int wpl = ((n + 31) / 32 + 31) / 32;
#define COLSKIP_ARGS xs, vs, os, cs, ys, b, n, w, k, stop, st
    if (wpl <= 1) return launch<1>(COLSKIP_ARGS);
    if (wpl <= 2) return launch<2>(COLSKIP_ARGS);
    if (wpl <= 4) return launch<4>(COLSKIP_ARGS);
    if (wpl <= 8) return launch<8>(COLSKIP_ARGS);
    if (wpl <= 16) return launch<16>(COLSKIP_ARGS);
    return launch<32>(COLSKIP_ARGS);
#undef COLSKIP_ARGS
}

}  // extern "C"
