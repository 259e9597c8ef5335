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
//     pointers: ub_link_launch (the NodeIds scan, link_edges_kernel,
//     link_next_kernel, link_prev_kernel);
//   - _rank_chains :150-186: ub_rank_launch (rank_init_kernel, the
//     rounds, rank_finish_kernel);
//   - _assemble :228-319: ub_assemble_launch (the Heads scan,
//     unitig_sums_kernel, the SeqOff scan, write_seq_kernel, ends_kernel,
//     the Used scan, renumber_kernel).
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
// link_nodes.  Node ids are the run starts of the sorted fingerprints,
// numbered by an inclusive scan and scattered through the permutation
// (ascending-fingerprint numbering, as the JAX package's segment ids
// give).  The scan is one launch: a block a tile of 2,048 positions, its
// offset from a decoupled look-back over blocks in ticket order (a
// 64-bit status word a block: its sum and a flag, aggregate or inclusive
// prefix; the extraction of csrc/kmer_sort.cu scans the same way).
// Adjacency is one byte a node (the forward nibble in bits 0-3, the
// reverse nibble in bits 4-7), set by atomicOr on 32-bit words, a degree
// the popcount of a nibble; the successor and predecessor tables are set
// by atomicMax, so the highest lane wins, as the port's scatter_reduce
// "amax" and the JAX package's in-order scatter leave them.  Then the
// next pointer with the palindromic self-successor cut, and prev_ptr.
// Bound by the gathers of the permutation's fingerprints and the atomics:
// about 200 MB at the bench.
//
// rank_chains.  Wyllie's pointer doubling on packed (anc, dist) int2
// rows, double-buffered, all ceil(log2 D) + 1 rounds queued at once with
// no host sync: round r sets a device flag when a lane's ancestor still
// moved, and round r + 1 returns at once when round r's flag is clear.
// A round that moves nothing writes its input again, so once the lanes
// settle both buffers hold the answer and the rounds left read nothing.
// The finish pass writes head_of and dist and counts, into info, the
// lanes whose head has a predecessor (on a pure cycle) and the heads.
// Bound by the rounds' gathers of 8-byte rows: at the bench (one
// genome-length unitig pair) every round runs, about 100 MB each.
//
// assemble_unitigs.  A scan of the head lanes numbers the unitigs and
// lists their heads; a lane's unitig is its head's number.  Lengths and
// count sums by integer atomics (exact in any order), aggregated first
// over the lanes of a warp that share a unitig (__match_any_sync and
// __reduce_add_sync), so a long unitig costs an atomic a warp.  seq_off is
// an int64 scan.  Each unitig's first k bases come from its head's row,
// reverse-complemented for a reverse-complement head, then each lane
// writes its last base at seq_off + k + dist.  The tail lanes, the
// reverse-complement pairing and the endpoint keys follow; the endpoint
// nodes are renumbered by marking the used node ids and an exclusive scan
// of the marks (the ascending order torch.unique gives, with no sort).
// About 150 MB at the bench.
#include <cuda_runtime.h>
#include <stdint.h>

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
        long long excl = 0;
        if (t == 0) {
            if (lane == 0)
                st_release(&status[0],
                           ((unsigned long long)agg << 2) | ST_PREFIX);
        } else {
            if (lane == 0)
                st_release(&status[t], ((unsigned long long)agg << 2) | ST_AGG);
            for (long long kk = t - 1;; kk -= 32) {
                const long long idx = kk - lane;       // lane 0 the nearest
                unsigned long long s = idx >= 0 ? ld_acquire(&status[idx])
                                                : ST_PREFIX;
                while (__any_sync(FULL, (s & 3) == 0))
                    if ((s & 3) == 0) s = ld_acquire(&status[idx]);
                const unsigned pre = __ballot_sync(FULL, (s & 3) == ST_PREFIX);
                const int stop = pre ? __ffs(pre) - 1 : 31;
                long long x = lane <= stop ? (long long)(s >> 2) : 0;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    x += __shfl_xor_sync(FULL, x, o);
                excl += x;
                if (pre) break;
            }
            if (lane == 0)
                st_release(&status[t],
                           ((unsigned long long)(excl + agg) << 2) | ST_PREFIX);
        }
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

size_t scan_bytes(long long len) {
    return (size_t)(cdiv(len, SCAN_TILE) + 1) * sizeof(unsigned long long);
}

template <class Op>
int scan(const Op& op, long long len, void* scratch, cudaStream_t st) {
    const long long blocks = cdiv(len, SCAN_TILE);
    if (blocks == 0) return 0;
    const cudaError_t e = cudaMemsetAsync(scratch, 0, scan_bytes(len), st);
    if (e != cudaSuccess) return (int)e;
    unsigned long long* status = static_cast<unsigned long long*>(scratch);
    scan_kernel<Op><<<(unsigned)blocks, THREADS, 0, st>>>(
        op, len, status, reinterpret_cast<unsigned*>(status + blocks));
    return (int)cudaGetLastError();
}

// node[order[j]] = (run starts of the sorted fingerprints up to j) - 1
struct NodeIds {
    const uint2* fp;
    const long long* order;
    int* node;
    __device__ long long value(long long j) const {
        if (j == 0) return 1;
        const uint2 a = fp[order[j]], b = fp[order[j - 1]];
        return a.x != b.x || a.y != b.y;
    }
    __device__ void emit(long long j, long long run, long long v) const {
        node[order[j]] = (int)(run + v - 1);
    }
};

// The head lanes (head_of[d] == d) in lane order: unitig u's head is
// head_d[u], and u_all[d] = u at a head lane d.
struct Heads {
    const int* head_of;
    int* u_all;
    int* head_d;
    __device__ long long value(long long d) const { return head_of[d] == d; }
    __device__ void emit(long long d, long long run, long long v) const {
        if (v) {
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

// Out-degree of a (node, orientation) key: the popcount of the node's
// nibble (forward bits 0-3, reverse bits 4-7 of the node's byte).
__device__ __forceinline__ int degree(const unsigned* __restrict__ adj,
                                      int key) {
    const int node = key >> 1;
    const unsigned byte = adj[node >> 2] >> ((node & 3) * 8);
    return __popc((byte >> ((key & 1) * 4)) & 0xFu);
}

// A thread a lane d: its source and target keys and last base; its
// adjacency bit (source node, source orientation, last base) and
// succ[src_key] = the highest such lane.
__global__ void __launch_bounds__(THREADS)
link_edges_kernel(const uint8_t* __restrict__ flags,
                  const int* __restrict__ node, long long n,
                  int* __restrict__ src_key, int* __restrict__ tgt_key,
                  uint8_t* __restrict__ lastbase, unsigned* adj, int* succ) {
    LANES(d, 2 * n) {
        const bool rc = d >= n;
        const long long i = rc ? d - n : d;
        const unsigned f = flags[i];
        const unsigned o_pre = f & 1u, o_suf = (f >> 1) & 1u;
        const unsigned first = (f >> 2) & 3u, last = (f >> 4) & 3u;
        const int np = node[i], ns = node[n + i];
        const int sn = rc ? ns : np, tn = rc ? np : ns;
        const unsigned so = rc ? 1u - o_suf : o_pre;
        const unsigned to = rc ? 1u - o_pre : o_suf;
        const unsigned lb = rc ? 3u - first : last;
        const int sk = 2 * sn + (int)so;
        src_key[d] = sk;
        tgt_key[d] = 2 * tn + (int)to;
        lastbase[d] = (uint8_t)lb;
        atomicOr(adj + (sn >> 2), 1u << ((sn & 3) * 8 + so * 4 + lb));
        atomicMax(succ + sk, (int)d);
    }
}

// nxt[d]: the lane after d on a chain (the target's only successor where
// the target has in- and out-degree 1, not d itself); prv[nxt] = the
// highest such d.  prev_ptr[d] = 0 where d's source has in- and
// out-degree 1, else -1 (link_prev_kernel completes it).
__global__ void __launch_bounds__(THREADS)
link_next_kernel(const int* __restrict__ src_key,
                 const int* __restrict__ tgt_key,
                 const unsigned* __restrict__ adj,
                 const int* __restrict__ succ, long long D, int* prv,
                 int* __restrict__ prev_ptr) {
    LANES(d, D) {
        const int sk = src_key[d], tk = tgt_key[d];
        int nx = -1;
        if (degree(adj, tk) == 1 && degree(adj, tk ^ 1) == 1) nx = succ[tk];
        if (nx == d) nx = -1;                 // palindromic self-successor
        if (nx >= 0) atomicMax(prv + nx, (int)d);
        prev_ptr[d] = degree(adj, sk) == 1 && degree(adj, sk ^ 1) == 1 ? 0
                                                                        : -1;
    }
}

__global__ void __launch_bounds__(THREADS)
link_prev_kernel(const int* __restrict__ prv, long long D,
                 int* __restrict__ prev_ptr) {
    LANES(d, D) prev_ptr[d] = prev_ptr[d] == 0 ? prv[d] : -1;
}

// ---------------------------------------------------------------------------
// rank_chains
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
rank_init_kernel(const int* __restrict__ prev_ptr, long long D,
                 int2* __restrict__ st) {
    LANES(d, D) {
        const int p = prev_ptr[d];
        st[d] = p < 0 ? make_int2((int)d, 0) : make_int2(p, 1);
    }
}

// Round r: nxt[d] = (anc of anc, dist + dist of anc); moved[r] = 1 when
// some lane's ancestor had a distance (had not reached its head).
// Returns at once when round r - 1 moved nothing.
__global__ void __launch_bounds__(THREADS)
rank_round_kernel(const int2* __restrict__ cur, int2* __restrict__ nxt,
                  long long D, int* moved, int r) {
    if (r > 0 && moved[r - 1] == 0) return;
    bool any = false;
    LANES(d, D) {
        const int2 s = cur[d];
        const int2 g = cur[s.x];
        nxt[d] = make_int2(g.x, s.y + g.y);
        any |= g.y > 0;
    }
    if (__syncthreads_or(any) && threadIdx.x == 0) moved[r] = 1;
}

// head_of, dist; info[0] += lanes whose head has a predecessor (a pure
// cycle), info[1] += heads.
__global__ void __launch_bounds__(THREADS)
rank_finish_kernel(const int2* __restrict__ st,
                   const int* __restrict__ prev_ptr, long long D,
                   int* __restrict__ head_of, int* __restrict__ dist,
                   int* info) {
    unsigned cyc = 0, heads = 0;
    LANES(d, D) {
        const int2 s = st[d];
        head_of[d] = s.x;
        dist[d] = s.y;
        cyc += prev_ptr[s.x] >= 0;
        heads += s.x == d;
    }
    cyc = __reduce_add_sync(FULL, cyc);
    heads = __reduce_add_sync(FULL, heads);
    if ((threadIdx.x & 31) == 0) {
        if (cyc) atomicAdd(info, (int)cyc);
        if (heads) atomicAdd(info + 1, (int)heads);
    }
}

// ---------------------------------------------------------------------------
// assemble_unitigs
// ---------------------------------------------------------------------------

// u_of[d] = the unitig of d's head; ulen[u] += 1 and ecount[u] += the
// count of d's k-edge, one atomic for the lanes of a warp that share u.
__global__ void __launch_bounds__(THREADS)
unitig_sums_kernel(const int* __restrict__ head_of,
                   const int* __restrict__ u_all,
                   const int* __restrict__ counts, long long n,
                   int* __restrict__ u_of, int* ulen,
                   unsigned long long* ecount) {
    const long long D = 2 * n;
    const int lane = threadIdx.x & 31;
    // whole warps to the end: every lane takes part in the warp's match
    for (long long base = blockIdx.x * (long long)THREADS; base < D;
         base += (long long)gridDim.x * THREADS) {
        const long long d = base + threadIdx.x;
        const bool ok = d < D;
        int u = -1;
        unsigned c = 0;
        if (ok) {
            u = u_all[head_of[d]];
            u_of[d] = u;
            c = (unsigned)counts[d < n ? d : d - n];
        }
        const unsigned peers = __match_any_sync(FULL, u);
        const unsigned lo = __reduce_add_sync(peers, c & 0xFFFFu);
        const unsigned hi = __reduce_add_sync(peers, c >> 16);
        if (ok && lane == __ffs(peers) - 1) {
            atomicAdd(ulen + u, __popc(peers));
            atomicAdd(ecount + u,
                      (unsigned long long)lo + ((unsigned long long)hi << 16));
        }
    }
}

// Each lane's last base at seq_off[u] + k + dist, the tail lane of each
// unitig (dist = ulen - 1), then each unitig's first k bases from its
// head's row (reversed and complemented for a reverse-complement head).
__global__ void __launch_bounds__(THREADS)
write_seq_kernel(const long long* __restrict__ uniq, long long n, int nl1,
                 int k, const int* __restrict__ u_of,
                 const int* __restrict__ dist, const int* __restrict__ ulen,
                 const uint8_t* __restrict__ lastbase,
                 const int* __restrict__ head_d,
                 const long long* __restrict__ seq_off, long long n_e,
                 int* __restrict__ tail_d, uint8_t* __restrict__ seq) {
    LANES(d, 2 * n) {
        const int u = u_of[d], ds = dist[d];
        seq[seq_off[u] + k + ds] = lastbase[d];
        if (ds == ulen[u] - 1) tail_d[u] = (int)d;
    }
    LANES(q, n_e * k) {
        const long long u = q / k;
        const int j = (int)(q - u * k);
        const int hd = head_d[u];
        const bool rc = hd >= n;
        const long long e = rc ? hd - n : hd;
        const int pos = rc ? k - j : j;
        const uint32_t limb = (uint32_t)uniq[e * nl1 + pos / 16];
        const uint32_t b = (limb >> (30 - 2 * (pos % 16))) & 3u;
        seq[seq_off[u] + j] = (uint8_t)(rc ? 3u - b : b);
    }
}

// edge_rc[u] = the unitig of the reverse complement of u's tail; the
// endpoint keys (source of the head, target of the tail) into edge_src,
// edge_tgt, their nodes marked used.
__global__ void __launch_bounds__(THREADS)
ends_kernel(const int* __restrict__ head_d, const int* __restrict__ tail_d,
            const int* __restrict__ u_of, const int* __restrict__ src_key,
            const int* __restrict__ tgt_key, long long n, long long n_e,
            long long* __restrict__ edge_rc, long long* __restrict__ edge_src,
            long long* __restrict__ edge_tgt, uint8_t* used) {
    LANES(u, n_e) {
        const int td = tail_d[u];
        edge_rc[u] = u_of[td < n ? td + n : td - n];
        const int es = src_key[head_d[u]], et = tgt_key[td];
        edge_src[u] = es;
        edge_tgt[u] = et;
        used[es >> 1] = 1;
        used[et >> 1] = 1;
    }
}

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
    int* node;
    unsigned* adj;
    int* succ;
    int* prv;
    void* scan;
    size_t bytes;
    LinkScratch(void* base, long long n) {
        const long long D = 2 * n;
        Carve c(base);
        node = c.take<int>(D);
        adj = c.take<unsigned>(cdiv(D, 4));
        succ = c.take<int>(2 * D);
        prv = c.take<int>(D);
        scan = c.take<uint8_t>((long long)scan_bytes(D));
        bytes = c.used;
    }
};

struct RankScratch {
    int2* st0;
    int2* st1;
    int* moved;
    size_t bytes;
    RankScratch(void* base, long long D, int rounds) {
        Carve c(base);
        st0 = c.take<int2>(D);
        st1 = c.take<int2>(D);
        moved = c.take<int>(rounds);
        bytes = c.used;
    }
};

struct AssembleScratch {
    int* u_all;
    int* u_of;
    int* head_d;
    int* ulen;
    int* tail_d;
    uint8_t* used;
    int* nid;
    void* scan;
    size_t bytes;
    AssembleScratch(void* base, long long n, long long n_e) {
        const long long D = 2 * n;
        Carve c(base);
        u_all = c.take<int>(D);
        u_of = c.take<int>(D);
        head_d = c.take<int>(n_e);
        ulen = c.take<int>(n_e);
        tail_d = c.take<int>(n_e);
        used = c.take<uint8_t>(D);
        nid = c.take<int>(D);
        scan = c.take<uint8_t>((long long)scan_bytes(D > n_e ? D : n_e));
        bytes = c.used;
    }
};

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

// link_nodes: fp (2n, 2) int32, order (2n,) int64 (the stable ascending
// permutation of fp's rows as unsigned pairs), flags (n,) uint8 ->
// src_key, tgt_key (2n,) int32, lastbase (2n,) uint8, prev_ptr (2n,)
// int32.  scratch: ub_link_scratch_bytes(n) bytes, 256-byte aligned.
extern "C" int ub_link_launch(const void* fp, const void* order,
                              const void* flags, long long n, void* scratch,
                              void* src_key, void* tgt_key, void* lastbase,
                              void* prev_ptr, void* stream) {
    if (bad_edges(n)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long D = 2 * n;
    LinkScratch s(scratch, n);
    UB_TRY(cudaMemsetAsync(s.adj, 0, cdiv(D, 4) * sizeof(unsigned), st));
    UB_TRY(cudaMemsetAsync(s.succ, 0xFF, 2 * D * sizeof(int), st));
    UB_TRY(cudaMemsetAsync(s.prv, 0xFF, D * sizeof(int), st));
    UB_TRY(scan(NodeIds{static_cast<const uint2*>(fp),
                        static_cast<const long long*>(order), s.node},
                D, s.scan, st));
    int* sk = static_cast<int*>(src_key);
    int* tk = static_cast<int*>(tgt_key);
    int* pp = static_cast<int*>(prev_ptr);
    link_edges_kernel<<<grid_of(D), THREADS, 0, st>>>(
        static_cast<const uint8_t*>(flags), s.node, n, sk, tk,
        static_cast<uint8_t*>(lastbase), s.adj, s.succ);
    link_next_kernel<<<grid_of(D), THREADS, 0, st>>>(sk, tk, s.adj, s.succ, D,
                                                     s.prv, pp);
    link_prev_kernel<<<grid_of(D), THREADS, 0, st>>>(s.prv, D, pp);
    return (int)cudaGetLastError();
}

extern "C" long long ub_rank_scratch_bytes(long long D, int rounds) {
    return (long long)RankScratch(nullptr, D, rounds).bytes;
}

// rank_chains: prev_ptr (D,) int32 -> head_of, dist (D,) int32 after
// `rounds` doubling rounds at most (ceil(log2 D) + 1); info[0] = the lanes
// on pure cycles, info[1] = the heads.  scratch:
// ub_rank_scratch_bytes(D, rounds) bytes.
extern "C" int ub_rank_launch(const void* prev_ptr, long long D, int rounds,
                              void* scratch, void* head_of, void* dist,
                              void* info, void* stream) {
    if (D < 1 || D >= MAX_LANES || rounds < 1 || rounds > 64)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    RankScratch s(scratch, D, rounds);
    const int* pp = static_cast<const int*>(prev_ptr);
    UB_TRY(cudaMemsetAsync(s.moved, 0, rounds * sizeof(int), st));
    UB_TRY(cudaMemsetAsync(info, 0, 2 * sizeof(int), st));
    const unsigned g = grid_of(D);
    rank_init_kernel<<<g, THREADS, 0, st>>>(pp, D, s.st0);
    int2* buf[2] = {s.st0, s.st1};
    for (int r = 0; r < rounds; ++r)
        rank_round_kernel<<<g, THREADS, 0, st>>>(buf[r & 1], buf[(r + 1) & 1],
                                                 D, s.moved, r);
    rank_finish_kernel<<<g, THREADS, 0, st>>>(
        buf[rounds & 1], pp, D, static_cast<int*>(head_of),
        static_cast<int*>(dist), static_cast<int*>(info));
    return (int)cudaGetLastError();
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
    UB_TRY(cudaMemsetAsync(s.ulen, 0, n_e * sizeof(int), st));
    UB_TRY(cudaMemsetAsync(s.used, 0, D, st));
    UB_TRY(cudaMemsetAsync(ecount, 0, n_e * sizeof(long long), st));
    UB_TRY(scan(Heads{hof, s.u_all, s.head_d}, D, s.scan, st));
    unitig_sums_kernel<<<grid_of(D), THREADS, 0, st>>>(
        hof, s.u_all, static_cast<const int*>(counts), n, s.u_of, s.ulen,
        reinterpret_cast<unsigned long long*>(ecount));
    UB_TRY(cudaGetLastError());
    UB_TRY(scan(SeqOff{s.ulen, seq_off, n_e, k}, n_e, s.scan, st));
    write_seq_kernel<<<grid_of(D > n_e * k ? D : n_e * k), THREADS, 0, st>>>(
        static_cast<const long long*>(uniq), n, nl1, k, s.u_of,
        static_cast<const int*>(dist), s.ulen,
        static_cast<const uint8_t*>(lastbase), s.head_d, seq_off, n_e,
        s.tail_d, static_cast<uint8_t*>(seq));
    ends_kernel<<<grid_of(n_e), THREADS, 0, st>>>(
        s.head_d, s.tail_d, s.u_of, static_cast<const int*>(src_key),
        static_cast<const int*>(tgt_key), n, n_e, edge_rc, edge_src, edge_tgt,
        s.used);
    UB_TRY(cudaGetLastError());
    UB_TRY(scan(Used{s.used, s.nid, n_v, D}, D, s.scan, st));
    renumber_kernel<<<grid_of(n_e), THREADS, 0, st>>>(s.nid, n_e, edge_src,
                                                      edge_tgt);
    return (int)cudaGetLastError();
}
