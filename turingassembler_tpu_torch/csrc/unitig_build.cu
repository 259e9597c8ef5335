// The level-0 unitig build's device program for Hopper: sorted unique
// k-edges ((k+1)-mer limb rows and their counts) -> unitig arrays and
// their base pool.  Directed k-edge lanes are [0, n) in canonical
// orientation and [n, 2n) reverse-complemented, D = 2n < 2^29, so every
// lane, node key and distance fits an int32.
//
// Replaces jitted JAX device code (XLA, not Pallas), of
// turingassembler_tpu/graph/device_build.py:
//   - _front :71-86 and _fingerprints :51-58: entry ub_front_launch
//     (front_kernel);
//   - _front :90-143, node ids, adjacency, successor and predecessor
//     pointers: ub_link_launch (link_runs_kernel, link_lanes_kernel);
//   - _rank_chains :150-186: ub_rank_launch (rank_link_kernel,
//     rank_walk_kernel, rank_rulers_kernel, rank_finish_kernel,
//     rank_cycles_kernel);
//   - _assemble :228-319: ub_assemble_launch (the Heads scan,
//     unitig_sums_kernel, the SeqOff scan, write_seq_kernel,
//     ends_kernel, the Used scan and renumber_kernel).
// Between the first two the caller sorts the fingerprints
// (ops/kmer_sort.py:lex_order, csrc/kmer_sort.cu).  The port's plain
// versions of the four entries are the tensor code of
// ops/unitig_build.py; each entry computes their integers exactly.
//
// What bounds each on an H100, and what the design does about it (bytes
// at 3.35 TB/s):
//
// front_keys.  Reads the n limb rows once and writes the (2n, 2) int32
// fingerprints and a byte a row: about 85 MB at the bench (n = 2 M, nl
// 3).  The tensor code spent about 430 launches here, each 32-bit product
// of the two murmur mixes split into int64 pieces.  A thread a row keeps
// the (k+1)-mer in registers and does everything in native uint32
// arithmetic: the first and last base, the prefix and suffix k-mers,
// their reverse complements (the 2-bit groups of each limb reversed, the
// limbs reversed and realigned by the pad bits), the orientation flags,
// both mixes of each canonical node k-mer.  Bytes-bound.
//
// link_nodes.  A lane's source node is its own fingerprint row's node, so
// the lanes of node v are the positions of v's run in the sorted order,
// and all that the plain version scatters by node is a reduction over a
// run.  link_runs_kernel takes a tile of 512 sorted positions a block,
// in ticket order: each position's lane read once (order, streamed), its
// fingerprint gathered once (the previous position's from the thread
// before) and its flag byte; the run starts numbered by a decoupled
// look-back over the tiles' start counts (64-bit status words, as the
// extraction of csrc/kmer_sort.cu scans; ascending-fingerprint numbering,
// as the JAX package's segment ids give); each run that starts in the
// tile reduced into a slot in shared memory by shared atomics: its
// adjacency byte (the forward nibble in bits 0-3, the reverse in 4-7, a
// degree the popcount of a nibble), and for each source orientation its
// highest lane (the successor) and its two highest reverse-complement
// lanes.  The last run, where it goes on past the tile, is followed by
// its own block to its end (a run of more than 8 lanes needs a
// fingerprint collision, so one step of 32 positions, then 256 at a
// time).  A lane's prev_ptr is then its key's pred where it is its key's
// successor on a chain, else -1 (see below), so each lane leaves one
// 4-byte word (its source key and that flag, a scattered store into 16
// MB at the bench) and each key its pred (in node order, coalesced);
// link_lanes_kernel, a thread a k-edge, reads the words of lanes i and n
// + i (coalesced) and writes the four outputs, each target key the other
// lane's source key with the orientation bit flipped, each prev_ptr a
// gather of pred where flagged.  The highest lane wins everywhere, as the
// port's scatter_reduce "amax" and the JAX package's in-order scatter
// leave it, whatever the order of equal rows.  No global atomic but the
// tickets, no memset but the status words.  The inputs and outputs are
// 118 MB at the bench (0.035 ms at 3.35 TB/s); what bounds it on the
// card is random access: of link_runs_kernel's 0.27 ms there on an H100,
// the fingerprint gather and the word scatter take about 0.12 each, the
// rest 0.11 (chip_smoke.py phase 25 times it with each cut out).  An
// 8-byte word a lane, or the four outputs scattered from here, cost
// more; an L2 prefetch of the fingerprints or a pre-touch of the words
// gained nothing.
//
// rank_chains.  A ruling set.  prev_ptr is injective, so the lanes form
// disjoint chains and pure cycles.  Wyllie's doubling would gather an
// 8-byte row a lane in each of ceil(log2 D) + 1 rounds, and at the bench
// (one genome-length unitig a strand) every round would run: 23 passes
// of about 190 MB of sectors.  Here each lane is touched about three
// times:
//   1. rank_link_kernel: each lane's successor (succ[prev[d]] = d), the
//      heads listed (an atomic a block), every lane's word unvisited;
//   2. the rulers: every head, and one sampled lane in each block of 16
//      lanes (RANK_SHIFT), at an offset a hash of the block picks
//      (ruler_lane), so the samples fall about 16 apart along any chain
//      whatever the lanes' order; rulerhood is arithmetic;
//   3. rank_walk_kernel, a thread a ruler: it walks the successors to the
//      next sample or the chain's end, packing each lane's (ruler id,
//      offset) into a 4-byte word, and at the next sample writes that
//      sample's ruler row (this ruler, the gap).  The lane 2^ob steps
//      past a walk's ruler becomes a ruler of its own, so an offset fits
//      its bits; ob = walk_bits(D, n_r) leaves the ruler ids room for D
//      heads: 8 at the bench (D = 3,999,906), 5 at D = 2^25;
//   4. rank_rulers_kernel, one cooperative launch: Wyllie on the ruler
//      rows (about D / 16 of them, in L2), in place, a grid-wide
//      barrier a round, ending on the device once no row is pending; the
//      heads' rows are settled from the start;
//   5. rank_finish_kernel: head_of and dist of each lane from its word
//      and its ruler's row, written in lane order;
//   6. the cycles: a lane no walk reached (a cycle without a sample) or
//      whose ruler stays pending (a cycle of samples) is a cycle lane.
//      The plain version's R = ceil(log2 D) + 1 rounds leave on it the
//      lane 2^R steps back and the distance 2^R; rank_cycles_kernel,
//      cooperative, doubles the listed cycle lanes among themselves to
//      that, and returns at once when there is none.
// What bounds it: the walk's D dependent successor reads and D scattered
// word stores.  Scattered stores cost their sector a read and a write
// back unless it stays in L2, so the layout is set by L2: 4-byte words
// beside the 4-byte successors (32 MB at the bench) run the walk in half
// the time of 8-byte rows (48 MB with the successors) on the card, and a
// 16-byte record a lane (64 MB) ran 4x slower than those.  Then the
// ruler rounds' barriers, about 4 us a round.  No host sync.
//
// assemble_unitigs.  A scan of the head lanes numbers the unitigs and
// lists their heads; a lane's unitig is its head's number.  Lengths and
// count sums by integer atomics (exact in any order): a warp's lanes that
// share a unitig are grouped first (__match_any_sync, their counts summed
// as 16-bit halves), the groups' leaders add into a block's table in
// shared memory (a unitig a slot, four probes, a global atomic only past
// them), and each tile of 4,096 lanes adds its table to the unitig rows:
// at the bench's two unitigs two atomics a row a tile, where grouping by
// warp alone sends two a warp, all serialised in L2 on the same two rows.
// The sums, the scans' status words and the used marks are zeroed by one
// memset.  seq_off is a look-back scan of k + ulen.  One pass over the
// lanes then writes each lane's last base at seq_off + k + dist (a random
// byte store each, the pool in L2) and lists the tail lanes (dist = ulen
// - 1); a warp takes 32 unitigs at a time and writes their first k bases
// from their heads' rows.  The
// ends (count sum, reverse-complement partner, endpoint keys) are taken a
// unitig a thread, marking the endpoint nodes; the marks' scan numbers
// them densely in ascending order (torch.unique's), and a pass over the
// unitigs renumbers the endpoints: one path at every n_e (a one-block
// sort of the endpoints for few unitigs would save 0.023 ms at the
// bench's two, on an H100).  Bound at the bench by the pool's random
// byte stores.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SCAN_PER = 8;                       // positions a thread
constexpr long long SCAN_TILE = (long long)THREADS * SCAN_PER;
constexpr unsigned long long ST_AGG = 1, ST_PREFIX = 2;   // status flags
constexpr long long MAX_GRID = 132 * 16;          // blocks of a lane pass
constexpr long long MAX_LANES = 1LL << 29;        // D: int32 keys, dists
constexpr size_t ALIGN = 256;                     // scratch carving
constexpr int NO_RULER = INT_MIN;                 // a block without a sample
constexpr int SUM_PER = 16;                       // lanes a thread a tile
constexpr long long SUM_TILE = (long long)THREADS * SUM_PER;
constexpr int SUM_SLOTS = 1024;                   // a block's unitig table
constexpr int SUM_PROBES = 4;
constexpr int RANK_SHIFT = 4;                     // a ruler block: 16 lanes
constexpr int RUN_PER = 2;                        // link_nodes: positions a
constexpr long long RUN_TILE = (long long)THREADS * RUN_PER;   // thread, a
constexpr int RUN_FIRST = 32;                     // block; the first step
constexpr int LINK_SUCC = 1 << 30;                // past a tile; a lane
                                                  // word's flag (keys < 2^30)

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
    return (a + b - 1) / b;
}

unsigned grid_of(long long len) {
    const long long b = cdiv(len, THREADS);
    return (unsigned)(b < 1 ? 1 : (b > MAX_GRID ? MAX_GRID : b));
}

#define LANES(i, len)                                                     \
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;     \
         i < (len); i += (long long)gridDim.x * THREADS)

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// Reverse the sixteen 2-bit groups of x (ops/limbs.py:_rev2bits_in_u32).
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
    x = __brev(x);
    return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

__device__ __forceinline__ unsigned long long ld_acquire(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// ---------------------------------------------------------------------------
// front_keys
// ---------------------------------------------------------------------------

// murmur3's 32-bit mix of NL limbs from seed h (ops/limbs.py:hash_limbs).
template <int NL>
__device__ __forceinline__ uint32_t murmur(const uint32_t (&c)[NL],
                                           uint32_t h) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        uint32_t x = c[l] * 0xCC9E2D51u;
        x = rotl(x, 15) * 0x1B873593u;
        h = rotl(h ^ x, 13) * 5u + 0xE6546B64u;
    }
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// The node fingerprint (fpA, fpB) of a canonical k-mer; fpA's all-ones
// value is remapped, as the JAX package reserves it for invalid lanes.
template <int NL>
__device__ __forceinline__ int2 fingerprint(const uint32_t (&c)[NL]) {
    uint32_t a = murmur<NL>(c, 0x9E3779B9u);
    const uint32_t b = murmur<NL>(c, 0x27D4EB2Fu);
    if (a == 0xFFFFFFFFu) a = 0xFFFFFFFEu;
    return make_int2((int)a, (int)b);
}

// y = the reverse complement of the k-mer x (ops/limbs.py:revcomp_limbs):
// the limbs complemented, their 2-bit groups and their order reversed,
// shifted up by the pad bits 32 NL - 2k, the unused low bits cleared.
template <int NL>
__device__ __forceinline__ void revcomp(const uint32_t (&x)[NL],
                                        uint32_t (&y)[NL], int pad,
                                        uint32_t last_mask) {
    uint32_t r[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) r[l] = rev2(~x[NL - 1 - l]);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        uint32_t v = r[l];
        if (pad) {
            v <<= pad;
            if (l + 1 < NL) v |= r[l + 1 < NL ? l + 1 : l] >> (32 - pad);
        }
        y[l] = v;
    }
    y[NL - 1] &= last_mask;
}

template <int NL>
__device__ __forceinline__ bool lex_lt(const uint32_t (&a)[NL],
                                       const uint32_t (&b)[NL]) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
        if (a[l] != b[l]) return a[l] < b[l];
    return false;
}

// A thread a k-edge row: uniq (n, NL1) int64 limbs of (k+1)-mers (NL1 =
// ceil((k + 1) / 16)), their nodes NL = ceil(k / 16) limbs.  fp (2n, 2):
// row i the prefix node's fingerprint, row n + i the suffix node's;
// flags (n,): o_pre | o_suf << 1 | first << 2 | last << 4.  A limb
// outside [0, 2^32) sets info[2].
template <int NL, int NL1>
__global__ void __launch_bounds__(THREADS)
front_kernel(const long long* __restrict__ uniq, long long n, int k,
             int2* __restrict__ fp, uint8_t* __restrict__ flags,
             int* __restrict__ info) {
    const int pad = 32 * NL - 2 * k;
    const int used = 2 * k - 32 * (NL - 1);            // bits of the last limb
    const uint32_t last_mask = used == 32 ? ~0u : ~0u << (32 - used);
    const int lk = k / 16, sk = 30 - 2 * (k % 16);      // where base k lies
    bool bad = false;
    LANES(i, n) {
        uint32_t x[NL1];
#pragma unroll
        for (int l = 0; l < NL1; ++l) {
            const long long v = uniq[i * NL1 + l];
            bad |= ((unsigned long long)v >> 32) != 0;
            x[l] = (uint32_t)v;
        }
        uint32_t xk = x[0];
#pragma unroll
        for (int l = 1; l < NL1; ++l)
            if (l == lk) xk = x[l];
        const uint32_t first = x[0] >> 30, last = (xk >> sk) & 3u;
        uint32_t pre[NL], suf[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) {
            pre[l] = x[l];
            suf[l] = x[l] << 2;
            if (l + 1 < NL1) suf[l] |= x[l + 1 < NL1 ? l + 1 : l] >> 30;
        }
        pre[NL - 1] &= last_mask;
        suf[NL - 1] &= last_mask;
        uint32_t pre_rc[NL], suf_rc[NL];
        revcomp<NL>(pre, pre_rc, pad, last_mask);
        revcomp<NL>(suf, suf_rc, pad, last_mask);
        const bool o_pre = lex_lt<NL>(pre_rc, pre);
        const bool o_suf = lex_lt<NL>(suf_rc, suf);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
            if (o_pre) pre[l] = pre_rc[l];
            if (o_suf) suf[l] = suf_rc[l];
        }
        fp[i] = fingerprint<NL>(pre);
        fp[n + i] = fingerprint<NL>(suf);
        flags[i] = (uint8_t)((uint32_t)o_pre | (uint32_t)o_suf << 1 |
                             first << 2 | last << 4);
    }
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(info + 2, 1);
}

template <int NL, int NL1>
int front_run(const long long* uniq, long long n, int k, int2* fp,
              uint8_t* flags, int* info, cudaStream_t st) {
    front_kernel<NL, NL1><<<grid_of(n), THREADS, 0, st>>>(uniq, n, k, fp,
                                                          flags, info);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The scan: a block a tile of SCAN_TILE positions, in ticket order, its
// offset by a decoupled look-back.  Op gives value(j) >= 0 and takes
// emit(j, the sum of the values before j, value(j)).
// ---------------------------------------------------------------------------

// Exclusive prefix of v over the block; *total gets the block's sum.
__device__ long long block_exclusive_scan(long long v, long long* total,
                                          long long* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sh[warp] = x;
    __syncthreads();
    if (warp == 0) {
        long long s = lane < WARPS ? sh[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(FULL, s, o);
            if (lane >= o) s += y;
        }
        if (lane < WARPS) sh[lane] = s;
    }
    __syncthreads();
    const long long before = warp ? sh[warp - 1] : 0;
    *total = sh[WARPS - 1];
    return before + x - v;
}

// status: one zeroed 64-bit word a block; ticket: one zeroed word after
// them.  A block takes a ticket in launch order, so every block with a
// smaller ticket has started and its status word will be published.

// Block t publishes its tile's sum agg: block 0 its inclusive prefix at
// once, the others the aggregate.  One thread calls it.
__device__ __forceinline__ void publish_agg(long long t, long long agg,
                                            unsigned long long* status) {
    st_release(&status[t],
               ((unsigned long long)agg << 2) | (t == 0 ? ST_PREFIX : ST_AGG));
}

// The sum of the tiles before block t, read back over the blocks before
// it, 32 status words a step, to the nearest inclusive prefix; then t's
// inclusive prefix is published.  Warp 0 calls it after publish_agg.
__device__ long long look_back(long long t, long long agg,
                               unsigned long long* status) {
    if (t == 0) return 0;
    const int lane = threadIdx.x & 31;
    long long excl = 0;
    for (long long kk = t - 1;; kk -= 32) {
        const long long idx = kk - lane;               // lane 0 the nearest
        unsigned long long s = idx >= 0 ? ld_acquire(&status[idx]) : ST_PREFIX;
        while (__any_sync(FULL, (s & 3) == 0))
            if ((s & 3) == 0) s = ld_acquire(&status[idx]);
        const unsigned pre = __ballot_sync(FULL, (s & 3) == ST_PREFIX);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        long long x = lane <= stop ? (long long)(s >> 2) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
        excl += x;
        if (pre) break;
    }
    if (lane == 0)
        st_release(&status[t],
                   ((unsigned long long)(excl + agg) << 2) | ST_PREFIX);
    return excl;
}

template <class Op>
__global__ void __launch_bounds__(THREADS)
scan_kernel(Op op, long long len, unsigned long long* status,
            unsigned* ticket) {
    __shared__ long long sh[WARPS];
    __shared__ long long s_off;
    __shared__ unsigned s_ticket;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long t = s_ticket;
    const long long j0 = t * SCAN_TILE + (long long)tid * SCAN_PER;
    long long v[SCAN_PER], sum = 0;
#pragma unroll
    for (int q = 0; q < SCAN_PER; ++q) {
        v[q] = j0 + q < len ? op.value(j0 + q) : 0;
        sum += v[q];
    }
    long long agg;
    const long long before = block_exclusive_scan(sum, &agg, sh);
    if (warp == 0) {
        if (lane == 0) publish_agg(t, agg, status);
        const long long excl = look_back(t, agg, status);
        if (lane == 0) s_off = excl;
    }
    __syncthreads();
    long long run = s_off + before;
#pragma unroll
    for (int q = 0; q < SCAN_PER; ++q) {
        if (j0 + q < len) op.emit(j0 + q, run, v[q]);
        run += v[q];
    }
}

// The status words and the ticket of a look-back over `tiles` blocks.
size_t status_bytes(long long tiles) {
    return (size_t)(tiles + 1) * sizeof(unsigned long long);
}

size_t scan_bytes(long long len) { return status_bytes(cdiv(len, SCAN_TILE)); }

// scratch: scan_bytes(len) bytes, zeroed by the caller.
template <class Op>
int scan(const Op& op, long long len, void* scratch, cudaStream_t st) {
    const long long blocks = cdiv(len, SCAN_TILE);
    if (blocks == 0) return 0;
    unsigned long long* status = static_cast<unsigned long long*>(scratch);
    scan_kernel<Op><<<(unsigned)blocks, THREADS, 0, st>>>(
        op, len, status, reinterpret_cast<unsigned*>(status + blocks));
    return (int)cudaGetLastError();
}

// The head lanes (head_of[d] == d) in lane order: unitig u's head is
// head_d[u], and u_all[d] = u at a head lane d.
struct Heads {
    const int* head_of;
    int* u_all;
    int* head_d;
    long long n_e;
    __device__ long long value(long long d) const { return head_of[d] == d; }
    __device__ void emit(long long d, long long run, long long v) const {
        if (v && run < n_e) {
            u_all[d] = (int)run;
            head_d[run] = (int)d;
        }
    }
};

// seq_off[u] = sum over the unitigs before u of k + ulen; seq_off[n_e]
// the total.
struct SeqOff {
    const int* ulen;
    long long* seq_off;
    long long n_e;
    int k;
    __device__ long long value(long long u) const { return k + ulen[u]; }
    __device__ void emit(long long u, long long run, long long v) const {
        seq_off[u] = run;
        if (u == n_e - 1) seq_off[n_e] = run + v;
    }
};

// The used node ids, numbered in ascending order: nid[j] at a used j;
// *n_v = twice their number.
struct Used {
    const uint8_t* used;
    int* nid;
    long long* n_v;
    long long len;
    __device__ long long value(long long j) const { return used[j]; }
    __device__ void emit(long long j, long long run, long long v) const {
        if (v) nid[j] = (int)run;
        if (j == len - 1) *n_v = 2 * (run + v);
    }
};

// ---------------------------------------------------------------------------
// link_nodes
// ---------------------------------------------------------------------------

// The lanes with source node v are the positions of v's run in the sorted
// order (a lane's source is its own fingerprint row), so node v's
// adjacency, successors and predecessor candidates are reductions over
// its run, and a lane's prev_ptr needs only its own run's figures: lane e
// on key K = 2v + so has a predecessor only where both of v's nibbles
// hold one bit and e is the highest lane on K (succ[K] == e, so the
// plain version's nxt points at it), and then it is the highest d with
// tgt_key[d] == K, d != e: tgt_key[d] == K exactly where rc(d) leaves
// K ^ 1, so it is the highest rc lane of v's run on K ^ 1 that is not e
// (the second highest where the highest is e: a k-edge its own successor).

// A lane's source orientation and last base, from its k-edge's flags.
__device__ __forceinline__ void lane_flags(const uint8_t* __restrict__ flags,
                                           long long n, int d, unsigned* so,
                                           unsigned* lb) {
    const bool rc = d >= n;
    const unsigned f = flags[rc ? d - n : d];
    *so = rc ? 1u - ((f >> 1) & 1u) : f & 1u;
    *lb = rc ? 3u - ((f >> 2) & 3u) : (f >> 4) & 3u;
}

__device__ __forceinline__ int rc_lane(int d, long long n) {
    return d >= n ? d - (int)n : d + (int)n;
}

// The runs that start in a block's tile, a slot each (its index among
// them): the node's adjacency byte (bit so * 4 + last base: the forward
// nibble, then the reverse), and for each source orientation so the
// highest lane and the highest and second-highest rc lane.
struct RunSlots {
    unsigned adj[RUN_TILE];
    int succ[2][RUN_TILE];
    int top[2][2][RUN_TILE];
};

__device__ __forceinline__ void run_add(RunSlots& s, int r, int d,
                                        unsigned so, unsigned lb,
                                        long long n) {
    atomicOr(&s.adj[r], 1u << (so * 4 + lb));
    atomicMax(&s.succ[so][r], d);
    atomicMax(&s.top[so][0][r], rc_lane(d, n));
}

// After every run_add of the run: the second-highest rc lane.
__device__ __forceinline__ void run_second(RunSlots& s, int r, int d,
                                           unsigned so, long long n) {
    const int x = rc_lane(d, n);
    if (x != s.top[so][0][r]) atomicMax(&s.top[so][1][r], x);
}

// Both of the run's nibbles hold one bit: its keys' lanes are on chains.
__device__ __forceinline__ bool run_chain(const RunSlots& s, int r) {
    const unsigned a = s.adj[r];
    return __popc(a & 0xFu) == 1 && __popc(a >> 4) == 1;
}

// Lane d's word: its source key, and LINK_SUCC where it is its key's
// successor on a chain (its prev_ptr is then its key's entry in pred).
__device__ __forceinline__ int run_word(const RunSlots& s, int r,
                                        long long node, int d, unsigned so) {
    const int key = (int)(2 * node) + (int)so;
    return run_chain(s, r) && s.succ[so][r] == d ? key | LINK_SUCC : key;
}

// pred[2 node + so] of run r: the highest rc lane on the other
// orientation that is not the key's successor (-1 off a chain).
__device__ __forceinline__ int run_pred(const RunSlots& s, int r,
                                        unsigned so) {
    if (!run_chain(s, r)) return -1;
    const int first = s.top[so ^ 1][0][r];
    return first != s.succ[so][r] ? first : s.top[so ^ 1][1][r];
}

// The run pass: a block a tile of RUN_TILE sorted positions, in ticket
// order.  Each position's lane (order, streamed), its fingerprint (one
// gather) and its flags; the previous position's fingerprint from the
// thread before (one more gather at the tile's start).  The runs that
// start in the tile are numbered by a look-back over the tiles' start
// counts and reduced in shared memory; the last of them, where it goes on
// past the tile, is followed by this block (RUN_FIRST positions, then
// THREADS at a time) to its end, and the positions of the tile before its
// first start are left to the block whose run they end.  Each lane's
// word goes to word[lane], a scattered 4-byte store, and each run's two
// keys' pred to pred in node order, coalesced.
__global__ void __launch_bounds__(THREADS)
link_runs_kernel(const uint2* __restrict__ fp,
                 const long long* __restrict__ order,
                 const uint8_t* __restrict__ flags, long long n,
                 int* __restrict__ word, int* __restrict__ pred,
                 unsigned long long* status, unsigned* ticket) {
    __shared__ RunSlots s;
    __shared__ uint2 s_last[THREADS];
    __shared__ long long sh[WARPS];
    __shared__ long long s_off;
    __shared__ unsigned s_ticket;
    const int tid = threadIdx.x;
    const long long D = 2 * n;
    if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long t = s_ticket;
    const long long tile_end = (t + 1) * RUN_TILE < D ? (t + 1) * RUN_TILE : D;
    const long long j0 = t * RUN_TILE + (long long)tid * RUN_PER;
    int d[RUN_PER];
    uint2 v[RUN_PER];
    unsigned so[RUN_PER], lb[RUN_PER];
#pragma unroll
    for (int q = 0; q < RUN_PER; ++q)
        d[q] = j0 + q < D ? (int)__ldcs(order + j0 + q) : 0;   // streamed
#pragma unroll
    for (int q = 0; q < RUN_PER; ++q) {
        v[q] = make_uint2(0, 0);
        so[q] = lb[q] = 0;
        if (j0 + q < D) {
            v[q] = fp[d[q]];
            lane_flags(flags, n, d[q], &so[q], &lb[q]);
        }
    }
    uint2 prev = make_uint2(0, 0);
    if (tid == 0 && t > 0) prev = fp[order[j0 - 1]];
    s_last[tid] = v[RUN_PER - 1];
    __syncthreads();
    if (tid > 0) prev = s_last[tid - 1];
    bool start[RUN_PER];
    long long cnt = 0;
#pragma unroll
    for (int q = 0; q < RUN_PER; ++q) {
        const uint2 p = q ? v[q - 1] : prev;
        start[q] = j0 + q < D &&
                   (j0 + q == 0 || v[q].x != p.x || v[q].y != p.y);
        cnt += start[q];
    }
    long long runs;
    const long long before = block_exclusive_scan(cnt, &runs, sh);
    if (tid < 32) {
        if (tid == 0) publish_agg(t, runs, status);
        const long long excl = look_back(t, runs, status);
        if (tid == 0) s_off = excl;
    }
    int r[RUN_PER];                 // the run's slot; -1: an earlier tile's
    int rr = (int)before - 1;
#pragma unroll
    for (int q = 0; q < RUN_PER; ++q) {
        rr += start[q];
        r[q] = j0 + q < D ? rr : -1;
    }
    for (int i = tid; i < runs; i += THREADS) {
        s.adj[i] = 0;
        s.succ[0][i] = s.succ[1][i] = -1;
        s.top[0][0][i] = s.top[0][1][i] = s.top[1][0][i] = s.top[1][1][i] = -1;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RUN_PER; ++q)
        if (r[q] >= 0) run_add(s, r[q], d[q], so[q], lb[q], n);
    // the last run, on past a full tile: the positions [tile_end, ext)
    // that hold its fingerprint (sorted, so they follow on)
    const int last = (int)runs - 1;
    long long ext = tile_end;
    if (runs > 0 && tile_end < D) {
        const uint2 w = s_last[THREADS - 1];
        for (int step = RUN_FIRST;; step = THREADS) {
            const long long j = ext + tid;
            bool in = false;
            if (tid < step && j < D) {
                const int e = (int)order[j];
                const uint2 x = fp[e];
                in = x.x == w.x && x.y == w.y;
                if (in) {
                    unsigned o, b;
                    lane_flags(flags, n, e, &o, &b);
                    run_add(s, last, e, o, b, n);
                }
            }
            const int c = __syncthreads_count(in);
            ext += c;
            if (c < step) break;
        }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RUN_PER; ++q)
        if (r[q] >= 0) run_second(s, r[q], d[q], so[q], n);
    for (long long j = tile_end + tid; j < ext; j += THREADS) {
        const int e = (int)order[j];
        unsigned o, b;
        lane_flags(flags, n, e, &o, &b);
        run_second(s, last, e, o, n);
    }
    __syncthreads();
    const long long base = s_off;
#pragma unroll
    for (int q = 0; q < RUN_PER; ++q)
        if (r[q] >= 0)
            word[d[q]] = run_word(s, r[q], base + r[q], d[q], so[q]);
    for (long long j = tile_end + tid; j < ext; j += THREADS) {
        const int e = (int)order[j];
        unsigned o, b;
        lane_flags(flags, n, e, &o, &b);
        word[e] = run_word(s, last, base + last, e, o);
    }
    for (int i = tid; i < 2 * runs; i += THREADS)
        pred[2 * base + i] = run_pred(s, i >> 1, i & 1);
}

// The lane pass, a thread a k-edge i: lanes i and n + i from their words;
// each one's target key is the other's source key with the orientation
// flipped (tgt_key[d] = src_key[rc(d)] ^ 1), its prev_ptr its key's pred
// where the word says so, its last base from the flags.
__global__ void __launch_bounds__(THREADS)
link_lanes_kernel(const int* __restrict__ word, const int* __restrict__ pred,
                  const uint8_t* __restrict__ flags, long long n,
                  int* __restrict__ src_key, int* __restrict__ tgt_key,
                  uint8_t* __restrict__ lastbase,
                  int* __restrict__ prev_ptr) {
    LANES(i, n) {
        const int a = word[i], b = word[n + i];
        const int ka = a & ~LINK_SUCC, kb = b & ~LINK_SUCC;
        const unsigned f = flags[i];
        src_key[i] = ka;
        src_key[n + i] = kb;
        tgt_key[i] = kb ^ 1;
        tgt_key[n + i] = ka ^ 1;
        lastbase[i] = (uint8_t)((f >> 4) & 3u);
        lastbase[n + i] = (uint8_t)(3u - ((f >> 2) & 3u));
        prev_ptr[i] = a & LINK_SUCC ? pred[ka] : -1;
        prev_ptr[n + i] = b & LINK_SUCC ? pred[kb] : -1;
    }
}

// ---------------------------------------------------------------------------
// block helpers
// ---------------------------------------------------------------------------

// A slot for each flagged thread of the block in a list whose length is
// *count: one atomic a block a call, none (and one barrier) when no
// thread is flagged.  Every thread of the block calls it; sh holds WARPS
// + 1 ints.
__device__ int block_append(bool flag, int* count, int* sh) {
    if (!__syncthreads_or(flag)) return 0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned b = __ballot_sync(FULL, flag);
    if (lane == 0) sh[warp] = __popc(b);
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int c = sh[w];
            sh[w] = total;
            total += c;
        }
        sh[WARPS] = total ? atomicAdd(count, total) : 0;
    }
    __syncthreads();
    const int at = sh[WARPS] + sh[warp] + __popc(b & ((1u << lane) - 1));
    __syncthreads();
    return at;
}

// *out += the block's sum of v: one atomic a block, none for 0.  Every
// thread of the block calls it.
__device__ void block_add(unsigned v, int* out, unsigned* sh) {
    v = __reduce_add_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned total = 0;
        for (int w = 0; w < WARPS; ++w) total += sh[w];
        if (total) atomicAdd(out, (int)total);
    }
}

// ---------------------------------------------------------------------------
// rank_chains
// ---------------------------------------------------------------------------

// murmur3's 32-bit finalizer: the offset of each ruler block's sample.
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// Ruler block i (lanes [i << RANK_SHIFT, (i + 1) << RANK_SHIFT)) samples
// one lane.
constexpr uint32_t RULER_MASK = (1u << RANK_SHIFT) - 1;

__device__ __forceinline__ long long ruler_lane(long long i) {
    return (i << RANK_SHIFT) | (long long)(mix32((uint32_t)i) & RULER_MASK);
}

__device__ __forceinline__ bool is_ruler_lane(long long d) {
    return (d & RULER_MASK) ==
           (long long)(mix32((uint32_t)(d >> RANK_SHIFT)) & RULER_MASK);
}

// A lane's word in st: UNVISITED until a walk packs (ruler id << ob |
// offset) into it.  Ruler ids: the n_r blocks' samples, then the rulers
// that over-long walks promote (at most D >> ob + 1), then from hbase one
// a head.
constexpr int UNVISITED = -1;
constexpr int MAX_WALK_BITS = 10;         // offsets 0..1,023 at most

// succ[p] = d for each lane d after p (succ all -1 before); every lane's
// word UNVISITED; heads[] lists the lanes with no predecessor (counts[0]
// of them), head t's ruler row (hbase + t) settled at (~head, 0); the row
// of a block whose sampled lane is a head, or lies past D, NO_RULER.
__global__ void __launch_bounds__(THREADS)
rank_link_kernel(const int* __restrict__ prev_ptr, long long D,
                 long long hbase, int* __restrict__ succ,
                 int* __restrict__ heads, int* counts, int* __restrict__ st,
                 int2* __restrict__ rs) {
    __shared__ int sh_app[WARPS + 1];
    // whole blocks to the end: every thread takes part in the append
    for (long long base = blockIdx.x * (long long)THREADS; base < D;
         base += (long long)gridDim.x * THREADS) {
        const long long d = base + threadIdx.x;
        const bool ok = d < D;
        int p = 0;
        if (ok) {
            p = prev_ptr[d];
            st[d] = UNVISITED;
            if (p >= 0)
                succ[p] = (int)d;
            else if (is_ruler_lane(d))
                rs[d >> RANK_SHIFT] = make_int2(NO_RULER, 0);
            if (d == D - 1 && ruler_lane(d >> RANK_SHIFT) > d)
                rs[d >> RANK_SHIFT] = make_int2(NO_RULER, 0);
        }
        const bool head = ok && p < 0;
        const int at = block_append(head, counts, sh_app);
        if (head) {
            heads[at] = (int)d;
            rs[hbase + at] = make_int2(~(int)d, 0);
        }
    }
}

// A thread a walk: head t = heads[t] (ruler hbase + t) for t <
// counts[0], then ruler block i = t - counts[0] where its sampled lane
// has a predecessor.  A walk follows the successors to the next sampled
// lane or the chain's end, packing each lane's (ruler id, offset) into
// its word: 4 bytes a lane, so the successors and the words (32 MB at
// the bench) stay in L2 while the walks scatter into them.  At a sampled
// lane it writes that ruler's row (this ruler, the gap), pending; after
// the offset 2^ob - 1 it makes the next lane a ruler of its own (id n_r +
// counts[2]++, row (this ruler, 2^ob)).  With tally (null on the
// build's path) the walks are added to tally[0] and tally[1] is raised to
// the longest walk's lanes (its start and each lane it packs, across its
// promotions), a block's figures at once.
__global__ void __launch_bounds__(THREADS)
rank_walk_kernel(const int* __restrict__ prev_ptr,
                 const int* __restrict__ succ, const int* __restrict__ heads,
                 int* counts, long long D, long long n_r, long long hbase,
                 int ob, int* __restrict__ st, int2* __restrict__ rs,
                 int* tally) {
    __shared__ int sh_walks[WARPS], sh_long[WARPS];
    const long long n_heads = counts[0];
    const int last = (1 << ob) - 1;
    int walks = 0, longest = 0;
    for (long long t = blockIdx.x * (long long)THREADS + threadIdx.x;
         t < n_heads + n_r; t += (long long)gridDim.x * THREADS) {
        int id, start;
        if (t < n_heads) {
            id = (int)(hbase + t);
            start = heads[t];
        } else {
            id = (int)(t - n_heads);
            const long long r = ruler_lane(id);
            if (r >= D || prev_ptr[r] < 0) continue;
            start = (int)r;
        }
        st[start] = id << ob;
        int lanes = 1;
        for (int cur = start, off = 1;; ++off, ++lanes) {
            const int x = succ[cur];
            if (x < 0) break;
            if (is_ruler_lane(x)) {
                rs[x >> RANK_SHIFT] = make_int2(id, off);
                break;
            }
            if (off > last) {
                const int next = (int)n_r + atomicAdd(counts + 2, 1);
                rs[next] = make_int2(id, off);
                id = next;
                off = 0;
            }
            st[x] = id << ob | off;
            cur = x;
        }
        ++walks;
        longest = lanes > longest ? lanes : longest;
    }
    if (!tally) return;
    walks = __reduce_add_sync(FULL, walks);
    longest = __reduce_max_sync(FULL, longest);
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        sh_walks[w] = walks;
        sh_long[w] = longest;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int i = 1; i < WARPS; ++i) {
            walks += sh_walks[i];
            longest = sh_long[i] > longest ? sh_long[i] : longest;
        }
        atomicAdd(tally, walks);
        atomicMax(tally + 1, longest);
    }
}

__device__ __forceinline__ unsigned long long ld_relaxed(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// Wyllie on the ruler rows of the samples and the promoted rulers (n_r +
// *extra; the heads' rows are settled from the start and only read), in
// one cooperative launch, in place.  A row (anc, dist), one 64-bit word
// (anc the low half), with anc < 0 is settled (head ~anc; NO_RULER a
// block without a sample), else pending on ruler anc at dist.  A round
// replaces each pending row by (the anc of its anc, the sum of the
// dists), reading and writing whole words: a row read mid-round, old or
// new, is an ancestor and its distance either way, so a round moves a row
// at least as far as a double-buffered round would, often farther.
// moved[r] is set while a row stays pending; every block reads it after
// the grid's barrier, so all leave together: once no row is pending, or
// after cap rounds (the rows on a cycle of samples stay pending; their
// sums wrap, unread).
__global__ void __launch_bounds__(THREADS)
rank_rulers_kernel(int2* rows, const int* extra, long long n_r, int cap,
                   int* moved) {
    cg::grid_group grid = cg::this_grid();
    unsigned long long* rs = reinterpret_cast<unsigned long long*>(rows);
    const long long n = n_r + __ldcg(extra);
    for (int r = 0; r < cap; ++r) {
        bool pending = false;
        for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
             i < n; i += (long long)gridDim.x * THREADS) {
            const unsigned long long s = ld_relaxed(rs + i);
            const int anc = (int)(unsigned)s;
            if (anc >= 0) {
                const unsigned long long a = ld_relaxed(rs + anc);
                const unsigned dist = (unsigned)(s >> 32) +
                                      (unsigned)(a >> 32);
                st_relaxed(rs + i, (a & 0xFFFFFFFFull) |
                                       (unsigned long long)dist << 32);
                pending |= (int)(unsigned)a >= 0;
            }
        }
        if (__syncthreads_or(pending) && threadIdx.x == 0) moved[r] = 1;
        grid.sync();
        if (__ldcg(moved + r) == 0) break;
    }
}

// head_of and dist of each lane from its word: its ruler's head, and the
// ruler's distance plus its offset; info[1] = the heads (every chain's
// own).  A lane no walk reached, or whose ruler is still pending, lies on
// a pure cycle: listed in cyc (counts[1] of them) with anc[d] =
// prev_ptr[d].  With tally: tally[2] = the promoted rulers, tally[3] =
// ob.
__global__ void __launch_bounds__(THREADS)
rank_finish_kernel(const int* __restrict__ prev_ptr,
                   const int* __restrict__ st, const int2* __restrict__ rs,
                   long long D, int ob, int* __restrict__ head_of,
                   int* __restrict__ dist, int* __restrict__ cyc, int* counts,
                   int* __restrict__ anc, int* info, int* tally) {
    __shared__ int sh_app[WARPS + 1];
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        info[1] = counts[0];
        if (tally) {
            tally[2] = counts[2];
            tally[3] = ob;
        }
    }
    for (long long base = blockIdx.x * (long long)THREADS; base < D;
         base += (long long)gridDim.x * THREADS) {
        const long long d = base + threadIdx.x;
        bool on_cycle = false;
        if (d < D) {
            const int w = st[d];
            on_cycle = w == UNVISITED;
            if (!on_cycle) {
                const int2 g = rs[w >> ob];
                on_cycle = g.x >= 0;
                if (!on_cycle) {
                    head_of[d] = ~g.x;
                    dist[d] = g.y + (w & ((1 << ob) - 1));
                }
            }
            if (on_cycle) anc[d] = prev_ptr[d];
        }
        const int at = block_append(on_cycle, counts + 1, sh_app);
        if (on_cycle) cyc[at] = (int)d;
    }
}

// The cycle lanes, in one cooperative launch: R doubling rounds among
// themselves (after round r anc holds the lane 2^(r+1) steps back), then
// head_of = the lane 2^R steps back and dist = 2^R, what the plain
// version's R rounds leave there; info[0] = their number, info[1] += the
// lanes that are their own.  Returns at once when there is none.
__global__ void __launch_bounds__(THREADS)
rank_cycles_kernel(const int* __restrict__ cyc, const int* counts, int* anc0,
                   int* anc1, int R, int* __restrict__ head_of,
                   int* __restrict__ dist, int* info) {
    __shared__ unsigned sh_sum[WARPS];
    const long long C = __ldcg(counts + 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) info[0] = (int)C;
    if (C == 0) return;
    cg::grid_group grid = cg::this_grid();
    const long long first = blockIdx.x * (long long)THREADS + threadIdx.x;
    const long long step = (long long)gridDim.x * THREADS;
    int* cur = anc0;
    int* nxt = anc1;
    for (int r = 0; r < R; ++r) {
        for (long long i = first; i < C; i += step) {
            const int d = cyc[i];
            nxt[d] = __ldcg(cur + __ldcg(cur + d));
        }
        grid.sync();
        int* t = cur;
        cur = nxt;
        nxt = t;
    }
    unsigned heads = 0;
    for (long long i = first; i < C; i += step) {
        const int d = cyc[i];
        const int h = __ldcg(cur + d);
        head_of[d] = h;
        dist[d] = 1 << R;
        heads += h == d;
    }
    block_add(heads, info + 1, sh_sum);
}

// ---------------------------------------------------------------------------
// assemble_unitigs
// ---------------------------------------------------------------------------

// A block's unitig sums in shared memory: a unitig a slot.
struct SumTable {
    int key[SUM_SLOTS];
    int len[SUM_SLOTS];
    unsigned long long cnt[SUM_SLOTS];
};

// (len, cnt) into unitig u's slot: its own or a free one within
// SUM_PROBES of u's; past them straight into u's row.
__device__ void table_add(SumTable& t, int u, int len, unsigned long long cnt,
                          int* ulen, unsigned long long* esum) {
    int slot = u & (SUM_SLOTS - 1);
    for (int p = 0; p < SUM_PROBES; ++p) {
        const int was = atomicCAS(&t.key[slot], -1, u);
        if (was == -1 || was == u) {
            atomicAdd(&t.len[slot], len);
            atomicAdd(&t.cnt[slot], cnt);
            return;
        }
        slot = (slot + 1) & (SUM_SLOTS - 1);
    }
    atomicAdd(ulen + u, len);
    atomicAdd(esum + u, cnt);
}

// ulen[u] += 1 and esum[u] += the count of d's k-edge for each lane d
// of unitig u (its head's number): a warp's lanes that share u as one
// group (the counts' 16-bit halves summed), the groups into the block's
// table, the table into the unitig rows once a tile of SUM_TILE lanes.
__global__ void __launch_bounds__(THREADS)
unitig_sums_kernel(const int* __restrict__ head_of,
                   const int* __restrict__ u_all,
                   const int* __restrict__ counts, long long n, int* ulen,
                   unsigned long long* esum) {
    __shared__ SumTable t;
    const long long D = 2 * n;
    const int lane = threadIdx.x & 31;
    for (long long tile = blockIdx.x * SUM_TILE; tile < D;
         tile += (long long)gridDim.x * SUM_TILE) {
        for (int s = threadIdx.x; s < SUM_SLOTS; s += THREADS) {
            t.key[s] = -1;
            t.len[s] = 0;
            t.cnt[s] = 0;
        }
        __syncthreads();
        // whole warps: every lane takes part in the warp's match
        for (int q = 0; q < SUM_PER; ++q) {
            const long long d = tile + (long long)q * THREADS + threadIdx.x;
            const bool ok = d < D;
            int u = -1;
            unsigned c = 0;
            if (ok) {
                u = u_all[head_of[d]];
                c = (unsigned)counts[d < n ? d : d - n];
            }
            const unsigned peers = __match_any_sync(FULL, u);
            const unsigned lo = __reduce_add_sync(peers, c & 0xFFFFu);
            const unsigned hi = __reduce_add_sync(peers, c >> 16);
            if (ok && lane == __ffs(peers) - 1)
                table_add(t, u, __popc(peers),
                          lo + ((unsigned long long)hi << 16), ulen, esum);
        }
        __syncthreads();
        for (int s = threadIdx.x; s < SUM_SLOTS; s += THREADS) {
            const int u = t.key[s];
            if (u >= 0) {
                atomicAdd(ulen + u, t.len[s]);
                atomicAdd(esum + u, t.cnt[s]);
            }
        }
        __syncthreads();
    }
}

// Each lane's last base at seq_off[u] + k + dist, but a head's; the tail
// lane of each unitig (dist = ulen - 1) into tail_d.  Then a warp takes 32
// unitigs at a time: each lane loads one's head row, pool offset and head
// base (32 independent loads, not a chain of them), and the warp writes
// each in turn, its fields passed by shuffles: the first k bases from the
// head's row (reversed and complemented for a reverse-complement head)
// and the head's last base after them, so a one-lane unitig is written in
// one piece.
__global__ void __launch_bounds__(THREADS)
write_seq_kernel(const long long* __restrict__ uniq, long long n, int nl1,
                 int k, const int* __restrict__ head_of,
                 const int* __restrict__ u_all, const int* __restrict__ dist,
                 const int* __restrict__ ulen,
                 const uint8_t* __restrict__ lastbase,
                 const int* __restrict__ head_d,
                 const long long* __restrict__ seq_off, long long n_e,
                 int* __restrict__ tail_d, uint8_t* __restrict__ seq) {
    LANES(d, 2 * n) {
        const int u = u_all[head_of[d]], ds = dist[d];
        if (ds) seq[seq_off[u] + k + ds] = lastbase[d];
        if (ds == ulen[u] - 1) tail_d[u] = (int)d;
    }
    const int lane = threadIdx.x & 31;
    const long long warps = ((long long)gridDim.x * THREADS) >> 5;
    for (long long u0 = ((blockIdx.x * (long long)THREADS + threadIdx.x) >> 5)
                        * 32;
         u0 < n_e; u0 += warps * 32) {
        int hd = 0;
        long long at = 0;
        uint32_t last = 0, limb[4] = {0, 0, 0, 0};
        if (u0 + lane < n_e) {
            hd = head_d[u0 + lane];
            at = seq_off[u0 + lane];
            last = lastbase[hd];
            const long long row = (hd >= n ? hd - n : hd) * nl1;
#pragma unroll
            for (int l = 0; l < 4; ++l)
                if (l < nl1) limb[l] = (uint32_t)uniq[row + l];
        }
        const int m = n_e - u0 < 32 ? (int)(n_e - u0) : 32;
        for (int i = 0; i < m; ++i) {
            const bool rc = __shfl_sync(FULL, hd, i) >= n;
            const long long a = __shfl_sync(FULL, at, i);
            uint32_t w[4];
#pragma unroll
            for (int l = 0; l < 4; ++l) w[l] = __shfl_sync(FULL, limb[l], i);
            const uint32_t lb = __shfl_sync(FULL, last, i);
            for (int j = lane; j <= k; j += 32) {
                if (j == k) {
                    seq[a + k] = (uint8_t)lb;
                    break;
                }
                const int pos = rc ? k - j : j, l = pos >> 4;
                const uint32_t x = l == 0 ? w[0] : l == 1 ? w[1]
                                                  : l == 2 ? w[2] : w[3];
                const uint32_t b = (x >> (30 - 2 * (pos & 15))) & 3u;
                seq[a + j] = (uint8_t)(rc ? 3u - b : b);
            }
        }
    }
}

// What a unitig's ends give: its count sum, edge_rc (the unitig of the
// reverse complement of its tail lane) and its endpoint keys (its head's
// source, its tail's target).
struct Ends {
    const int* head_of;
    const int* u_all;
    const int* head_d;
    const int* tail_d;
    const unsigned long long* esum;
    const int* src_key;
    const int* tgt_key;
    long long n;
    long long* ecount;
    long long* edge_rc;
    __device__ int2 operator()(long long u) const {
        const int td = tail_d[u];
        ecount[u] = (long long)esum[u];
        edge_rc[u] = u_all[head_of[td < n ? td + n : td - n]];
        return make_int2(src_key[head_d[u]], tgt_key[td]);
    }
};

// Each unitig's ends, its endpoint keys into edge_src and edge_tgt, their
// nodes marked in used.
__global__ void __launch_bounds__(THREADS)
ends_kernel(Ends ends, long long n_e, long long* __restrict__ edge_src,
            long long* __restrict__ edge_tgt, uint8_t* used) {
    LANES(u, n_e) {
        const int2 e = ends(u);
        edge_src[u] = e.x;
        edge_tgt[u] = e.y;
        used[e.x >> 1] = 1;
        used[e.y >> 1] = 1;
    }
}

// The endpoints through nid, the Used scan's dense ids of the marked
// nodes.
__global__ void __launch_bounds__(THREADS)
renumber_kernel(const int* __restrict__ nid, long long n_e,
                long long* __restrict__ edge_src,
                long long* __restrict__ edge_tgt) {
    LANES(u, n_e) {
        const long long es = edge_src[u], et = edge_tgt[u];
        edge_src[u] = 2LL * nid[es >> 1] + (es & 1);
        edge_tgt[u] = 2LL * nid[et >> 1] + (et & 1);
    }
}

// Scratch regions, each ALIGN-aligned, carved in order from one buffer.
struct Carve {
    uint8_t* p;
    size_t used = 0;
    explicit Carve(void* base) : p(static_cast<uint8_t*>(base)) {}
    template <typename T>
    T* take(long long count) {
        T* out = p ? reinterpret_cast<T*>(p + used) : nullptr;
        used += ((size_t)count * sizeof(T) + ALIGN - 1) / ALIGN * ALIGN;
        return out;
    }
};

struct LinkScratch {
    int* word;         // each lane's source key and LINK_SUCC
    int* pred;         // each key's successor's prev_ptr
    unsigned long long* status;
    long long tiles;
    size_t bytes;
    LinkScratch(void* base, long long n) {
        const long long D = 2 * n;
        tiles = cdiv(D, RUN_TILE);
        Carve c(base);
        word = c.take<int>(D);
        pred = c.take<int>(2 * D);
        status = c.take<unsigned long long>(tiles + 1);
        bytes = c.used;
    }
};

// ceil(log2 n) + 1 for n >= 2 (2 for n < 2): the doubling rounds that
// rank any chain of n rows.
int rounds_for(long long n) {
    int b = 0;
    while ((1LL << b) < (n < 2 ? 2 : n)) ++b;
    return b + 1;
}

constexpr int MAX_ROUNDS = 30;             // 2^R, a cycle lane's dist, fits

// The bits of a walk's offset in a lane's word: as many as leave room for
// every ruler id (n_r blocks, at most (D >> ob) + 1 promoted, at most D
// heads) in the other 31 - ob, up to MAX_WALK_BITS.
int walk_bits(long long D, long long n_r) {
    for (int ob = MAX_WALK_BITS; ob > 0; --ob)
        if (n_r + (D >> ob) + 1 + D <= (1LL << (31 - ob))) return ob;
    return 0;
}

struct RankScratch {
    int* succ;
    int* st;           // the lanes' words
    int* heads;        // then the cycle lanes
    int* anc0;         // the cycle lanes' ancestors, two buffers
    int* anc1;
    int2* rs;          // the ruler rows: samples, promoted, heads
    int* counts;       // heads, cycle lanes, promoted rulers, round flags
    size_t bytes;
    RankScratch(void* base, long long D, long long rows) {
        Carve c(base);
        succ = c.take<int>(D);
        st = c.take<int>(D);
        heads = c.take<int>(D);
        anc0 = c.take<int>(D);
        anc1 = c.take<int>(D);
        rs = c.take<int2>(rows);
        counts = c.take<int>(3 + 32);
        bytes = c.used;
    }
};

// Everything the launch zeroes comes first, in one region: the scans'
// status words, the sums, the used marks.
struct AssembleScratch {
    unsigned long long* heads_scan;
    unsigned long long* seqoff_scan;
    unsigned long long* used_scan;
    unsigned long long* esum;
    int* ulen;
    uint8_t* used;
    size_t zero_bytes;
    int* u_all;
    int* head_d;
    int* tail_d;
    int* nid;
    size_t bytes;
    AssembleScratch(void* base, long long n, long long n_e) {
        const long long D = 2 * n;
        const long long w_d = (long long)scan_bytes(D) / 8;
        const long long w_e = (long long)scan_bytes(n_e) / 8;
        Carve c(base);
        heads_scan = c.take<unsigned long long>(2 * w_d + w_e);
        seqoff_scan = heads_scan ? heads_scan + w_d : nullptr;
        used_scan = heads_scan ? heads_scan + w_d + w_e : nullptr;
        esum = c.take<unsigned long long>(n_e);
        ulen = c.take<int>(n_e);
        used = c.take<uint8_t>(D);
        zero_bytes = c.used;
        u_all = c.take<int>(D);
        head_d = c.take<int>(n_e);
        tail_d = c.take<int>(n_e);
        nid = c.take<int>(D);
        bytes = c.used;
    }
};

// Blocks of a cooperative launch of kernel: as many as fit at once, at
// most per_sm a multiprocessor.
int coop_grid(const void* kernel, int per_sm, unsigned* grid) {
    int dev, sms, fit;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fit, kernel, THREADS, 0)) != cudaSuccess)
        return (int)e;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
    *grid = (unsigned)(sms * (fit < per_sm ? fit : per_sm));
    return 0;
}

bool bad_edges(long long n) { return n < 1 || 2 * n >= MAX_LANES; }

#define UB_TRY(call)                          \
    do {                                      \
        const int rc_ = (int)(call);          \
        if (rc_ != 0) return rc_;             \
    } while (0)

}  // namespace

// front_keys: uniq (n, nl1) int64 limbs of (k+1)-mers, 1 <= k <= 63, nl1
// = ceil((k + 1) / 16); fp (2n, 2) int32, flags (n,) uint8; info (3,)
// int32, zeroed by the caller: info[2] |= 1 when a limb lies outside
// [0, 2^32).
extern "C" int ub_front_launch(const void* uniq, long long n, int k, void* fp,
                               void* flags, void* info, void* stream) {
    if (k < 1 || k > 63 || bad_edges(n)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long* u = static_cast<const long long*>(uniq);
    int2* f = static_cast<int2*>(fp);
    uint8_t* fl = static_cast<uint8_t*>(flags);
    int* in = static_cast<int*>(info);
    switch ((k + 15) / 16 * 10 + (k + 16) / 16) {
        case 11: return front_run<1, 1>(u, n, k, f, fl, in, st);
        case 12: return front_run<1, 2>(u, n, k, f, fl, in, st);
        case 22: return front_run<2, 2>(u, n, k, f, fl, in, st);
        case 23: return front_run<2, 3>(u, n, k, f, fl, in, st);
        case 33: return front_run<3, 3>(u, n, k, f, fl, in, st);
        case 34: return front_run<3, 4>(u, n, k, f, fl, in, st);
        case 44: return front_run<4, 4>(u, n, k, f, fl, in, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" long long ub_link_scratch_bytes(long long n) {
    return (long long)LinkScratch(nullptr, n).bytes;
}

// link_nodes: fp (2n, 2) int32, order (2n,) int64 (an ascending
// permutation of fp's rows as unsigned pairs; equal rows in any order),
// flags (n,) uint8 -> src_key, tgt_key (2n,) int32, lastbase (2n,) uint8,
// prev_ptr (2n,) int32.  scratch: ub_link_scratch_bytes(n) bytes,
// 256-byte aligned.
extern "C" int ub_link_launch(const void* fp, const void* order,
                              const void* flags, long long n, void* scratch,
                              void* src_key, void* tgt_key, void* lastbase,
                              void* prev_ptr, void* stream) {
    if (bad_edges(n)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LinkScratch s(scratch, n);
    const uint8_t* fl = static_cast<const uint8_t*>(flags);
    UB_TRY(cudaMemsetAsync(s.status, 0, status_bytes(s.tiles), st));
    link_runs_kernel<<<(unsigned)s.tiles, THREADS, 0, st>>>(
        static_cast<const uint2*>(fp), static_cast<const long long*>(order),
        fl, n, s.word, s.pred, s.status,
        reinterpret_cast<unsigned*>(s.status + s.tiles));
    UB_TRY(cudaGetLastError());
    link_lanes_kernel<<<grid_of(n), THREADS, 0, st>>>(
        s.word, s.pred, fl, n, static_cast<int*>(src_key),
        static_cast<int*>(tgt_key), static_cast<uint8_t*>(lastbase),
        static_cast<int*>(prev_ptr));
    return (int)cudaGetLastError();
}

// The ruler layout of a launch: n_r block rows, the promoted from n_r,
// the heads' from *hbase; the offset bits *ob; the rows to allocate.
long long rank_layout(long long D, int* ob, long long* n_r,
                      long long* hbase) {
    *n_r = cdiv(D, 1LL << RANK_SHIFT);
    *ob = walk_bits(D, *n_r);
    *hbase = *n_r + (D >> *ob) + 1;
    return *hbase + D;
}

extern "C" long long ub_rank_scratch_bytes(long long D) {
    if (D < 1 || D >= MAX_LANES) return -1;
    int ob;
    long long n_r, hbase;
    const long long rows = rank_layout(D, &ob, &n_r, &hbase);
    return (long long)RankScratch(nullptr, D, rows).bytes;
}

// rank_chains: prev_ptr (D,) int32 -> head_of, dist (D,) int32; a cycle
// lane gets what `rounds` (ceil(log2 D) + 1) doubling rounds leave.
// info[0] = the lanes on pure cycles, info[1] = the heads.  tally: null,
// or (4,) int32 zeroed, which gets the walks, the longest walk's lanes,
// the promoted rulers and ob.  scratch: ub_rank_scratch_bytes(D) bytes.
extern "C" int ub_rank_launch(const void* prev_ptr, long long D, int rounds,
                              void* scratch, void* head_of, void* dist,
                              void* info, void* tally, void* stream) {
    if (D < 1 || D >= MAX_LANES || rounds < 1 || rounds > MAX_ROUNDS)
        return (int)cudaErrorInvalidValue;
    int ob;
    long long n_r, hbase;
    const long long rows = rank_layout(D, &ob, &n_r, &hbase);
    if (ob < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    RankScratch s(scratch, D, rows);
    const int* pp = static_cast<const int*>(prev_ptr);
    int* hof = static_cast<int*>(head_of);
    int* dst = static_cast<int*>(dist);
    int* inf = static_cast<int*>(info);
    int* tl = static_cast<int*>(tally);
    int cap = rounds_for(hbase);
    int* extra = s.counts + 2;
    int* moved = s.counts + 3;
    UB_TRY(cudaMemsetAsync(s.succ, 0xFF, D * sizeof(int), st));
    UB_TRY(cudaMemsetAsync(s.counts, 0, (3 + 32) * sizeof(int), st));
    const unsigned g = grid_of(D);
    rank_link_kernel<<<g, THREADS, 0, st>>>(pp, D, hbase, s.succ, s.heads,
                                            s.counts, s.st, s.rs);
    UB_TRY(cudaGetLastError());
    rank_walk_kernel<<<g, THREADS, 0, st>>>(pp, s.succ, s.heads, s.counts, D,
                                            n_r, hbase, ob, s.st, s.rs, tl);
    UB_TRY(cudaGetLastError());
    unsigned g_r, g_c;
    UB_TRY(coop_grid((const void*)rank_rulers_kernel, 4, &g_r));
    void* r_args[] = {&s.rs, &extra, &n_r, &cap, &moved};
    UB_TRY(cudaLaunchCooperativeKernel((const void*)rank_rulers_kernel, g_r,
                                       THREADS, r_args, 0, st));
    rank_finish_kernel<<<g, THREADS, 0, st>>>(pp, s.st, s.rs, D, ob, hof, dst,
                                              s.heads, s.counts, s.anc0, inf,
                                              tl);
    UB_TRY(cudaGetLastError());
    UB_TRY(coop_grid((const void*)rank_cycles_kernel, 1, &g_c));
    void* c_args[] = {&s.heads, &s.counts, &s.anc0, &s.anc1, &rounds, &hof,
                      &dst, &inf};
    UB_TRY(cudaLaunchCooperativeKernel((const void*)rank_cycles_kernel, g_c,
                                       THREADS, c_args, 0, st));
    return 0;
}

extern "C" long long ub_assemble_scratch_bytes(long long n, long long n_e) {
    return (long long)AssembleScratch(nullptr, n, n_e).bytes;
}

// assemble_unitigs: uniq (n, nl1) int64 limbs, counts (n,) int32, the
// lanes' src_key, tgt_key (2n,) int32, lastbase (2n,) uint8, head_of,
// dist (2n,) int32, n_e >= 1 heads -> ints (5 n_e + 2,) int64: seq_off
// (n_e + 1), ecount, edge_rc, edge_source, edge_target (n_e each), n_v;
// seq (2n + k n_e,) uint8.  scratch: ub_assemble_scratch_bytes(n, n_e)
// bytes.
extern "C" int ub_assemble_launch(const void* uniq, const void* counts,
                                  long long n, int nl1, int k,
                                  const void* src_key, const void* tgt_key,
                                  const void* lastbase, const void* head_of,
                                  const void* dist, long long n_e,
                                  void* scratch, void* ints, void* seq,
                                  void* stream) {
    if (bad_edges(n) || n_e < 1 || n_e > 2 * n || k < 1 || k > 63 ||
        nl1 != (k + 16) / 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long D = 2 * n;
    AssembleScratch s(scratch, n, n_e);
    long long* seq_off = static_cast<long long*>(ints);
    long long* ecount = seq_off + n_e + 1;
    long long* edge_rc = ecount + n_e;
    long long* edge_src = edge_rc + n_e;
    long long* edge_tgt = edge_src + n_e;
    long long* n_v = edge_tgt + n_e;
    const int* hof = static_cast<const int*>(head_of);
    UB_TRY(cudaMemsetAsync(s.heads_scan, 0, s.zero_bytes, st));
    UB_TRY(scan(Heads{hof, s.u_all, s.head_d, n_e}, D, s.heads_scan, st));
    const long long sum_grid = cdiv(D, SUM_TILE);
    unitig_sums_kernel<<<(unsigned)(sum_grid < MAX_GRID ? sum_grid : MAX_GRID),
                         THREADS, 0, st>>>(
        hof, s.u_all, static_cast<const int*>(counts), n, s.ulen, s.esum);
    UB_TRY(cudaGetLastError());
    UB_TRY(scan(SeqOff{s.ulen, seq_off, n_e, k}, n_e, s.seqoff_scan, st));
    write_seq_kernel<<<grid_of(D > 32 * n_e ? D : 32 * n_e), THREADS, 0,
                       st>>>(
        static_cast<const long long*>(uniq), n, nl1, k, hof, s.u_all,
        static_cast<const int*>(dist), s.ulen,
        static_cast<const uint8_t*>(lastbase), s.head_d, seq_off, n_e,
        s.tail_d, static_cast<uint8_t*>(seq));
    UB_TRY(cudaGetLastError());
    const Ends ends{hof, s.u_all, s.head_d, s.tail_d, s.esum,
                    static_cast<const int*>(src_key),
                    static_cast<const int*>(tgt_key), n, ecount, edge_rc};
    ends_kernel<<<grid_of(n_e), THREADS, 0, st>>>(ends, n_e, edge_src,
                                                  edge_tgt, s.used);
    UB_TRY(cudaGetLastError());
    UB_TRY(scan(Used{s.used, s.nid, n_v, D}, D, s.used_scan, st));
    renumber_kernel<<<grid_of(n_e), THREADS, 0, st>>>(s.nid, n_e, edge_src,
                                                      edge_tgt);
    return (int)cudaGetLastError();
}
