// Column-skipping sort over a mesh of banks (paper §III machine, §IV
// manager) for Hopper: the banks of a row are the CTAs of one thread-block
// cluster.
//
// Replaces the body that the reference runs under shard_map,
// repro/dist/bankmesh.py:_colskip_tile_local (not a Pallas kernel: a jnp
// machine whose manager gates are psum / all_gather collectives).  Each
// row of a (B, N) uint32 tile is split into D contiguous column shards of
// N / D, one a bank; the outputs (values and order (B, stop), CRs and
// cycles per row) are bit-identical to the single-bank kernels' and to the
// plain mesh (kernels/colskip/ref.py:sort_mesh_ref) for every D, k,
// stop_after, fuse and carrier, as §V.C says bank management never
// changes them.
//
// Layout: one cluster of D CTAs a row, each CTA a bank running the row
// body of colskip_body.cuh on its shard, the same body the single-bank
// kernels of colskip.cu run on a whole row: on the packed carrier one
// warp holding the shard as packed bit planes (planes and table in
// registers up to a shard of 2048, in shared memory beyond, up to
// 32768); on the dense carrier four warps holding values and flag bytes
// in registers up to a shard of 2048, one warp in shared memory beyond.
// Every verdict comes out of a gate, so all CTAs of a row take identical
// decisions and meet at every cluster barrier.  A whole 8-row tile in one
// cluster was not taken: its rows finish after different numbers of
// rounds, and a cluster barrier spans every thread of the cluster
// (per-row mbarriers in DSMEM would be needed); one cluster a row keeps
// one barrier a round.
//
// The manager gates (ClusterGate), each one exchange ("round"): every
// warp reduces its word (one REDUX), its lane 0 posts it with a count in
// its CTA's shared memory, a cluster barrier (barrier.cluster.arrive.
// release / wait.acquire, as cluster.sync()) follows, and lane i < D * W
// reads warp i % W's slot of CTA i / W through DSMEM
// (cluster.map_shared_rank); one more REDUX ORs the words and adds the
// counts, so one round reduces over the CTA's warps and over the banks.
// Slots are double-buffered by round parity: a fast CTA cannot overwrite
// a slot a slow one has not read, because it reaches that slot's next
// write only past the barrier the slow one arrives at after its read, so
// one barrier a round suffices.
//
//   * OR-gate round, one a fused block of F planes: the set of F-bit
//     patterns present among the shard's alive elements (the single-bank
//     kernels' verdict words); the union over the banks is the row's set,
//     so resolve_block<F>() runs unchanged and locally.  Blocks above the
//     search's start are skipped with no exchange;
//   * lone-element stop: the alive count rides in the same round (added,
//     not ORed); one alive element in the row makes every lower plane
//     uniform, the walk stops, and only the bank that owns it drains it;
//   * SL gate: each table entry's still-live bit (kk <= 8 bits) in one
//     exchange, as or_any(hit) in the reference's load (kernel.py:171-174);
//   * drain: one exchange of survivor counts gives every bank the row's
//     total and its exclusive bank-major prefix; a bank writes the order
//     of its drained elements straight to order[count + prefix + local
//     rank], in global column numbering (bank * N / D + j), capped at
//     stop - count (the k-early exit).  After the last round's cluster
//     barrier the row's CTAs gather the values through order[] together;
//     no assembly pass follows.
//
// fuse (F) is a template parameter, built for F in 1..8 on both carriers
// (blocks aligned at multiples of F, the top one ragged when F does not
// divide 32; the pattern set of 2^F bits in pat_words(F) words, which one
// exchange carries together); any other F is refused.  Each row returns
// the exchanges it made ("rounds"), at most the reference's static account
// collective_rounds(w, stop, fuse)["rounds"], since a search walks at most
// ceil(w / F) blocks, and skipped planes, lone elements and a load with an
// empty table make none.
//
// What bounds it: latency.  A row is one dependency chain of exchanges,
// each a cluster barrier plus a DSMEM read, so the least time is the
// slowest row's min searches times one dependent cross-bank round, which
// mesh_chain_kernel below times.  The bytes (one read of the tile, one
// write of values and order) are negligible.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "colskip_body.cuh"

// The library is built in parts (kernels/_build.py, PARTS): nvcc compiles
// part p of COLSKIP_MESH_PARTS with -DCOLSKIP_MESH_PART=p, which holds the
// instances of the fuse values F with (F - 1) % parts == p (part 0 also
// the C interface and the chain probe), and the parts link into one
// library, so its 104 instances build side by side (at 8 parts, one fuse
// value a part).  Compiled as one unit
// (the defaults) the library holds everything.
#ifndef COLSKIP_MESH_PARTS
#define COLSKIP_MESH_PARTS 1
#endif
#ifndef COLSKIP_MESH_PART
#define COLSKIP_MESH_PART 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBanks = 8;    // the portable cluster size
constexpr int kDenseWarps = 4;  // dense: warps a bank, registers
constexpr int kDenseRegN = 2048;   // dense: widest shard held in registers
constexpr int kMaxDevices = 64;
constexpr int kMaxFuse = 8;     // planes a round: built for 1 to 8
static_assert(COLSKIP_MESH_PARTS >= 1 && COLSKIP_MESH_PARTS <= kMaxFuse &&
                  COLSKIP_MESH_PART >= 0 &&
                  COLSKIP_MESH_PART < COLSKIP_MESH_PARTS,
              "one to eight parts");

// The §IV manager between the D CTAs of a row's cluster, W warps each
// (see the head of this file).  Slots: two buffers (round parity) of
// [NW + 1][W] words: NW words a warp (a block's pattern set; the other
// gates post one) and a count per warp.  `rounds` counts the exchanges
// made.
template <int W, int NW = 1>
struct ClusterGate {
    static constexpr int kSlot = (NW + 1) * W;  // words a buffer
    static constexpr int kWords = 2 * kSlot;    // shared words of the slots
    static_assert(kMaxBanks * W <= 32, "a lane reads each bank's warp slot");
    uint32_t* xch;
    int banks, bank, par = 0, rounds = 0;
    __device__ ClusterGate(uint32_t* x, int nb, int b)
        : xch(x), banks(nb), bank(b) {}

    // `bits` (N <= NW words) and `cnt` are the warp's (warp-reduced);
    // returns the row's ORs and sum, and in `below` the sum over the warps
    // before this one in element order (bank-major).  Lane i < D * W reads
    // warp i % W's slot of CTA i / W: N + 1 words, one barrier a round
    template <int N>
    __device__ __forceinline__ void exchange(uint32_t (&bits)[N], int& cnt,
                                             int* below) {
        static_assert(N <= NW, "the slots hold NW words a warp");
        cg::cluster_group cluster = cg::this_cluster();
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        uint32_t* xb = xch + par * kSlot;
        if (lane == 0) {
#pragma unroll
            for (int h = 0; h < N; ++h) xb[h * W + warp] = bits[h];
            xb[NW * W + warp] = (uint32_t)cnt;
        }
        cluster.sync();
        uint32_t b[N];
#pragma unroll
        for (int h = 0; h < N; ++h) b[h] = 0u;
        int c = 0;
        if (lane < banks * W) {
            const uint32_t* remote =
                cluster.map_shared_rank(xb, (unsigned)(lane / W));
#pragma unroll
            for (int h = 0; h < N; ++h) b[h] = remote[h * W + lane % W];
            c = (int)remote[NW * W + lane % W];
        }
#pragma unroll
        for (int h = 0; h < N; ++h) bits[h] = __reduce_or_sync(kFull, b[h]);
        cnt = __reduce_add_sync(kFull, c);
        if (below != nullptr)
            *below = __reduce_add_sync(kFull,
                                       lane < bank * W + warp ? c : 0);
        par ^= 1;
        ++rounds;
    }
    __device__ __forceinline__ uint32_t any(uint32_t bits) {
        uint32_t word[1] = {__reduce_or_sync(kFull, bits)};
        int none = 0;
        exchange(word, none, nullptr);
        return word[0];
    }
    __device__ __forceinline__ void patterns(uint32_t (&pats)[NW], int& cnt) {
#pragma unroll
        for (int h = 0; h < NW; ++h) pats[h] = __reduce_or_sync(kFull, pats[h]);
        cnt = __reduce_add_sync(kFull, cnt);
        exchange(pats, cnt, nullptr);
    }
    __device__ __forceinline__ int rank(int mine, int& total) {
        const int incl = warp_inclusive_scan(mine, threadIdx.x & 31);
        uint32_t none[1] = {0u};
        int cnt = __shfl_sync(kFull, incl, 31), below = 0;
        exchange(none, cnt, &below);
        total = cnt;
        return below + incl - mine;
    }
    // no CTA leaves (or gathers) before every partner is past its last
    // read of the slots and its last write of order[]
    __device__ __forceinline__ void done() { cg::this_cluster().sync(); }
    __device__ __forceinline__ bool lead() const {
        return bank == 0 && threadIdx.x == 0;
    }
};

// The gate of a mesh kernel at F planes a round, W warps a bank
template <int W, int F>
using MeshGate = ClusterGate<W, pat_words(F)>;

// The bank's place in its cluster and row
struct MeshRow {
    int bank, row, nl;
    __device__ MeshRow(int banks, int n)
        : bank((int)cg::this_cluster().block_rank()),
          row((int)blockIdx.x / banks), nl(n / banks) {}
};

// Packed carrier: one warp a bank
template <int WPL, int F>
__global__ void __launch_bounds__(32)
colskip_mesh_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ vals,
                    int32_t* __restrict__ order, int32_t* __restrict__ crs_out,
                    int32_t* __restrict__ cyc_out,
                    int32_t* __restrict__ rounds_out, int n, int banks, int w,
                    int k, int stop) {
    extern __shared__ uint32_t smem[];
    const MeshRow m(banks, n);
    const uint32_t* xrow = x + (size_t)m.row * n;
    int32_t* ordr = order + (size_t)m.row * stop;
    MeshGate<1, F> g(smem, banks, m.bank);
    int crs = 0, drains = 0;
    packed_row<WPL, F>(g, xrow + (size_t)m.bank * m.nl, ordr, m.nl,
                       m.bank * m.nl, w, k, stop,
                       smem + MeshGate<1, F>::kWords, crs, drains);
    g.done();
    finish_row(g, xrow, vals + (size_t)m.row * stop, ordr, stop, crs, drains,
               crs_out, cyc_out, m.row);
    if (g.lead()) rounds_out[m.row] = g.rounds;
}

// Dense carrier: W warps a bank, C elements a thread in registers, or one
// warp in shared memory (C = 0)
template <int C, bool kRegTab, int W, int F>
__global__ void __launch_bounds__(32 * W)
colskip_mesh_dense_kernel(const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ vals,
                          int32_t* __restrict__ order,
                          int32_t* __restrict__ crs_out,
                          int32_t* __restrict__ cyc_out,
                          int32_t* __restrict__ rounds_out, int n, int banks,
                          int w, int k, int stop) {
    extern __shared__ uint32_t smem[];
    const MeshRow m(banks, n);
    const uint32_t* xrow = x + (size_t)m.row * n;
    int32_t* ordr = order + (size_t)m.row * stop;
    MeshGate<W, F> g(smem, banks, m.bank);
    int crs = 0, drains = 0;
    dense_row<C, kRegTab, W, F>(g, xrow + (size_t)m.bank * m.nl, ordr, m.nl,
                                m.bank * m.nl, w, k, stop,
                                smem + MeshGate<W, F>::kWords, crs, drains);
    g.done();
    finish_row(g, xrow, vals + (size_t)m.row * stop, ordr, stop, crs, drains,
               crs_out, cyc_out, m.row);
    if (g.lead()) rounds_out[m.row] = g.rounds;
}

#if COLSKIP_MESH_PART == 0
// `rounds` dependent exchanges between the `banks` CTAs of one cluster:
// each posted word depends on the last round's OR, as a block's patterns
// depend on the last verdict.  The time per round prices one step of a
// mesh row's chain; it is not on the serving path.
__global__ void __launch_bounds__(32)
mesh_chain_kernel(int32_t* __restrict__ out, uint32_t seed, int rounds,
                  int banks) {
    extern __shared__ uint32_t smem[];
    ClusterGate<1> g(smem, banks, (int)cg::this_cluster().block_rank());
    int acc = 0;
    for (int r = 0; r < rounds; ++r) {
        uint32_t bits[1] = {((seed >> (r & 31)) ^ (uint32_t)acc ^ g.bank) & 1u};
        int cnt = 1;
        g.exchange(bits, cnt, nullptr);
        acc += (int)bits[0];
    }
    g.done();
    if (g.lead()) out[0] = acc;
}
#endif

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device, once per device (`done` is the kernel's own flag array)
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

// The current card's per-block shared-memory opt-in, or 0
int smem_optin() {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    return optin;
}

// `clusters` clusters of `banks` CTAs of `threads` threads
template <typename... Args>
int launch_clusters(void (*kernel)(Args...), int clusters, int banks,
                    int threads, size_t smem, cudaStream_t stream,
                    Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(clusters * banks));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)banks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

namespace colskip_mesh {

// one launch's arguments, the same type in every part
struct Args {
    const uint32_t* x;
    uint32_t* vals;
    int32_t *order, *crs, *cyc, *rounds;
    int b, n, banks, w, k, stop, packed;
    cudaStream_t stream;
};

// the launch of fuse values of part p ((fuse - 1) % parts == p), defined
// by that part
int launch_part_0(const Args& a, int fuse);
int launch_part_1(const Args& a, int fuse);
int launch_part_2(const Args& a, int fuse);
int launch_part_3(const Args& a, int fuse);
int launch_part_4(const Args& a, int fuse);
int launch_part_5(const Args& a, int fuse);
int launch_part_6(const Args& a, int fuse);
int launch_part_7(const Args& a, int fuse);

}  // namespace colskip_mesh

namespace {

using colskip_mesh::Args;

template <int WPL, int F>
int launch_packed(const Args& a) {
    auto kernel = colskip_mesh_kernel<WPL, F>;
    const int kk = a.k > 0 ? a.k : 1;
    constexpr bool kRegs = packed_in_registers(WPL, F);
    const int masks = kRegs ? 0 : kPlanes + kk;
    const size_t smem = (size_t)(MeshGate<1, F>::kWords + masks * 32 * WPL) *
                        sizeof(uint32_t);
    if (!kRegs) {
        static std::atomic<bool> done[kMaxDevices];
        const int most = (MeshGate<1, F>::kWords +
                          (kPlanes + kMaxK) * 32 * WPL) * (int)sizeof(uint32_t);
        cudaError_t err = allow_smem(kernel, most, done);
        if (err != cudaSuccess) return (int)err;
    }
    return launch_clusters(kernel, a.b, a.banks, 32, smem, a.stream, a.x,
                           a.vals, a.order, a.crs, a.cyc, a.rounds, a.n,
                           a.banks, a.w, a.k, a.stop);
}

template <int F>
int launch_packed_f(const Args& a) {
    const int wpl = ((a.n / a.banks + 31) / 32 + 31) / 32;
    if (wpl <= 1) return launch_packed<1, F>(a);
    if (wpl <= 2) return launch_packed<2, F>(a);
    if (wpl <= 4) return launch_packed<4, F>(a);
    if (wpl <= 8) return launch_packed<8, F>(a);
    if (wpl <= 16) return launch_packed<16, F>(a);
    return launch_packed<32, F>(a);
}

template <int C, bool kRegTab, int W, int F>
int launch_dense_at(const Args& a) {
    auto kernel = colskip_mesh_dense_kernel<C, kRegTab, W, F>;
    const int kk = a.k > 0 ? a.k : 1;
    constexpr int T = 32 * W;
    size_t smem = (size_t)MeshGate<W, F>::kWords * sizeof(uint32_t);
    if (C == 0) {
        // values and (2 + kk) flag bytes an element, in shared memory
        const int c = (a.n / a.banks + T - 1) / T;
        smem += (size_t)c * T * (4 + 2 + kk);
        static std::atomic<bool> done[kMaxDevices];
        cudaError_t err = allow_smem(kernel, smem_optin(), done);
        if (err != cudaSuccess) return (int)err;
    } else if (!kRegTab) {
        smem += (size_t)kk * C * T;        // table flag bytes
    }
    return launch_clusters(kernel, a.b, a.banks, T, smem, a.stream, a.x,
                           a.vals, a.order, a.crs, a.cyc, a.rounds, a.n,
                           a.banks, a.w, a.k, a.stop);
}

// the register instance of the smallest C (4, 8, 16) that holds the
// shard, four warps a bank; the rolled one-warp instance past 2048
template <bool kRegTab, int F>
int launch_dense_reg(const Args& a) {
    const int per = (a.n / a.banks + 32 * kDenseWarps - 1) / (32 * kDenseWarps);
    if (per <= 4) return launch_dense_at<4, kRegTab, kDenseWarps, F>(a);
    if (per <= 8) return launch_dense_at<8, kRegTab, kDenseWarps, F>(a);
    return launch_dense_at<16, kRegTab, kDenseWarps, F>(a);
}

template <int F>
int launch_dense_f(const Args& a) {
    static_assert(kDenseRegN == 16 * 32 * kDenseWarps, "C = 4, 8, 16");
    if (a.n / a.banks > kDenseRegN) return launch_dense_at<0, false, 1, F>(a);
    if (a.k > kRegTable) return launch_dense_reg<false, F>(a);
    return launch_dense_reg<true, F>(a);
}

// the carrier's instance for `fuse`, among this part's fuse values F..8
template <int F>
int launch_owned(const Args& a, int fuse) {
    if constexpr (F <= kMaxFuse) {
        if constexpr ((F - 1) % COLSKIP_MESH_PARTS == COLSKIP_MESH_PART) {
            if (fuse == F)
                return a.packed ? launch_packed_f<F>(a) : launch_dense_f<F>(a);
        }
        return launch_owned<F + 1>(a, fuse);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

#define COLSKIP_MESH_PART_FN_(p) launch_part_##p
#define COLSKIP_MESH_PART_FN(p) COLSKIP_MESH_PART_FN_(p)
int colskip_mesh::COLSKIP_MESH_PART_FN(COLSKIP_MESH_PART)(const Args& a,
                                                         int fuse) {
    return launch_owned<1>(a, fuse);
}

#if COLSKIP_MESH_PART == 0
namespace {

// the launch at `fuse` planes a round, in the part that owns it
int launch_fuse(const Args& a, int fuse) {
    using namespace colskip_mesh;
    const int part = (fuse - 1) % COLSKIP_MESH_PARTS;
    if (part == 0) return launch_part_0(a, fuse);
    if constexpr (COLSKIP_MESH_PARTS > 1)
        if (part == 1) return launch_part_1(a, fuse);
    if constexpr (COLSKIP_MESH_PARTS > 2)
        if (part == 2) return launch_part_2(a, fuse);
    if constexpr (COLSKIP_MESH_PARTS > 3)
        if (part == 3) return launch_part_3(a, fuse);
    if constexpr (COLSKIP_MESH_PARTS > 4)
        if (part == 4) return launch_part_4(a, fuse);
    if constexpr (COLSKIP_MESH_PARTS > 5)
        if (part == 5) return launch_part_5(a, fuse);
    if constexpr (COLSKIP_MESH_PARTS > 6)
        if (part == 6) return launch_part_6(a, fuse);
    if constexpr (COLSKIP_MESH_PARTS > 7)
        if (part == 7) return launch_part_7(a, fuse);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Widest shard a bank of the carrier holds at state depth k: packed, 32
// words a lane, 1024 words a mask; dense, (4 + 2 + kk) bytes of shared
// memory an element within the current card's per-block opt-in (the
// rolled instance), as the single-bank kernels.
int colskip_mesh_shard_max(int packed, int k) {
    if (k < 0 || k > kMaxK) return 0;
    if (packed) return 32 * 32 * 32;
    const int kk = k > 0 ? k : 1;
    const int optin = smem_optin() - MeshGate<1, kMaxFuse>::kWords * 4;
    return optin > 0 ? optin / (6 + kk) / 32 * 32 : 0;
}
int colskip_mesh_max_banks(void) { return kMaxBanks; }
int colskip_mesh_max_k(void) { return kMaxK; }
// 1 when the kernels are built for `fuse` planes a round (1 to 8)
int colskip_mesh_fuse_built(int fuse) { return fuse >= 1 && fuse <= kMaxFuse; }

// x (b, n) uint32 over `banks` banks of n / banks columns -> vals (b, stop)
// uint32, order (b, stop) int32, crs, cyc and rounds (b,) int32, on the
// packed (packed != 0) or the dense carrier, with `fuse` planes a round.
// Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream` and does not synchronise.
int colskip_mesh_launch(const void* x, void* vals, void* order, void* crs,
                        void* cyc, void* rounds, int b, int n, int banks,
                        int w, int k, int stop, int fuse, int packed,
                        void* stream) {
    if (b <= 0 || n <= 0 || banks < 1 || banks > kMaxBanks || n % banks ||
        w < 1 || w > 32 || k < 0 || k > kMaxK || stop < 1 || stop > n ||
        !colskip_mesh_fuse_built(fuse) ||
        n / banks > colskip_mesh_shard_max(packed, k))
        return (int)cudaErrorInvalidValue;
    const Args a{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(vals),
                 static_cast<int32_t*>(order), static_cast<int32_t*>(crs),
                 static_cast<int32_t*>(cyc), static_cast<int32_t*>(rounds),
                 b, n, banks, w, k, stop, packed,
                 static_cast<cudaStream_t>(stream)};
    return launch_fuse(a, fuse);
}

// out (1,) int32 <- the count of true words in a chain of `rounds`
// dependent exchanges between the `banks` CTAs of one cluster.  Returns
// cudaGetLastError().
int colskip_mesh_chain_launch(void* out, unsigned seed, int rounds, int banks,
                              void* stream) {
    if (rounds < 0 || banks < 1 || banks > kMaxBanks)
        return (int)cudaErrorInvalidValue;
    return launch_clusters(mesh_chain_kernel, 1, banks, 32,
                           (size_t)ClusterGate<1>::kWords * sizeof(uint32_t),
                           static_cast<cudaStream_t>(stream),
                           static_cast<int32_t*>(out), seed, rounds, banks);
}

}  // extern "C"
#endif  // COLSKIP_MESH_PART == 0
