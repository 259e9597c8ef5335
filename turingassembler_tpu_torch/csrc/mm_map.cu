// The minimizer mapper's device program for Hopper: minimizer marks,
// cuckoo probe, vote and gapless bound of a read in one warp.
//
// Replaces jitted JAX functions (XLA, not Pallas) of
// turingassembler_tpu/mapper/minimizers.py:
//   - _map_batch_verified (:578) and _map_batch (:556): minimizer_mask
//     (:44), compaction to MM_CAP slots, _cuckoo_probe (:209), _vote_core
//     (:470) and, verified, _gapless_bound_dev (:706) of a batch of reads
//     (entry mm_map_batch_launch);
//   - _gapless_bound_dev alone, the bridge's rescore_hits
//     (entry mm_gapless_bound_launch);
//   - minimizer_mask inside _compact_minimizer_rows (:232), the index
//     build's segment rows (entry mm_minimizer_rows_launch).
// The port's plain versions are the tensor functions of
// turingassembler_tpu_torch/mapper/minimizers.py; every output equals
// theirs bit for bit.
//
// A warp a read (map and bound entries), a block a segment row (rows
// entry, 4,096 windows a row):
//   - hash.  The read's codes are staged in shared memory.  A thread a
//     window position p packs the k-mer's two limbs (ops/limbs.py:
//     base_shift: bases p..p+15 in limb 0, base p in the top two bits,
//     the rest of the k-mer in limb 1; codes >= 4 pack as 0) and hashes
//     them with the twin of ops/limbs.py:hash_limbs (murmur3's limb mix,
//     fmix32) on native uint32_t.  A window with a code >= 4 or past the
//     read's length hashes to 0xFFFFFFFF and is not valid.
//   - mark.  A thread a window i of the read's complete windows, i in
//     [0, length - k - w + 2), takes the leftmost minimum hash of
//     positions i..i+w-1 (positions past the row compare as 0xFFFFFFFF)
//     and marks it when it is valid: minimizer_mask's run formulation
//     elects the same positions.
//   - compact.  A ballot and a popc prefix over the marks, 32 positions
//     a step, keep the first MM_CAP marked positions in ascending order,
//     what the plain version's row sort keeps.
//   - probe.  A lane a slot recomputes its key and reads the first
//     matching slot of bucket b1's four, then b2's (int64 rows of 64
//     bytes, read as 16-byte vectors), then the slot's value row: (edge
//     + 1 when the key is a singleton, else 0; its position).  The hit
//     is (edge, position - p), the signed start.
//   - vote.  Each lane counts its slot's edge among the read's <= MM_CAP
//     hits and takes the least start of that edge; warp reductions give
//     the best count, the number of edges at it (a tie is unmapped), the
//     hits in all and the 85% / <= 2 confidence gate.  This is the row
//     sort and run-length pass of _vote_core without the sort.
//   - bound (verified).  Each lane takes read positions j, and where
//     the voted offset puts j on the edge reads the pool nibble under it
//     (the nibble-packed pool of _pack_pool_nibbles, int64 words of 8
//     nibbles, POOL_PAD_W sentinel words in front); two warp sums give
//     the matches and the on-edge positions.  For the on-edge positions
//     both branches of _gapless_bound_dev (one window a lane, or one
//     nibble a position past POOL_PAD_W words) read this same nibble,
//     and no other position counts.
//
// What bounds it on an H100: bytes, at 3.35 TB/s.  As a function the map
// reads each read's codes and length once, for each probed minimizer
// its bucket rows and value row (random 64- and 16-byte reads), the
// pool words under each read and its threshold, and writes five values
// a read; the mask, the hashes and the hit slots never leave shared
// memory.  What is left is the latency of the dependent random reads of
// a probe (bucket row, then value row), covered only by the warps in
// flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t INVALID = 0xFFFFFFFFu;   // hash of a window not valid
constexpr uint32_t SEED = 0x9E3779B9u;      // hash_limbs' default seed
constexpr int CUCKOO_CAP = 4;               // slots a bucket
constexpr int MAX_CAP = 64;                 // slots a read: two a lane
constexpr int SENT = 0x7FFFFFFF;            // a slot that votes nothing
constexpr int MAP_WARPS = 8;                // reads a block, at most
constexpr int ROW_THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 232448;         // 227 KB, a block's opt-in limit

__host__ __device__ __forceinline__ int align16(int x) {
    return (x + 15) & ~15;
}

__host__ __device__ __forceinline__ int positions(int L, int k) {
    return L - k + 1 > 0 ? L - k + 1 : 0;
}

// Shared bytes of one sequence's scratch: hashes (P), codes (L), marks (P).
__host__ __device__ __forceinline__ int seq_smem(int L, int k) {
    const int P = positions(L, k);
    return align16(4 * P) + align16(L) + align16(P);
}

// A warp's shared bytes in the map entry: the hit slots (start, edge,
// position), then the sequence's scratch.
__host__ __device__ __forceinline__ int warp_smem(int L, int k) {
    return 16 * MAX_CAP + seq_smem(L, k);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// ops/limbs.py:hash_limbs of a two-limb key at the default seed.
__device__ __forceinline__ uint32_t hash_key(uint32_t l0, uint32_t l1) {
    uint32_t h = SEED;
    const uint32_t x0 = rotl32(l0 * 0xCC9E2D51u, 15) * 0x1B873593u;
    h = rotl32(h ^ x0, 13) * 5u + 0xE6546B64u;
    const uint32_t x1 = rotl32(l1 * 0xCC9E2D51u, 15) * 0x1B873593u;
    h = rotl32(h ^ x1, 13) * 5u + 0xE6546B64u;
    return fmix32(h);
}

struct Key {
    uint32_t l0, l1;
    bool clean;      // no code >= 4 in the window
};

// The k-mer at position p of the codes in seq, 17 <= k <= 32.
__device__ __forceinline__ Key pack_key(const uint8_t* seq, int p, int k) {
    Key key{0u, 0u, true};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const uint32_t c = seq[p + j];
        key.clean = key.clean && c < 4;
        key.l0 |= (c < 4 ? c : 0u) << (30 - 2 * j);
    }
    for (int j = 16; j < k; ++j) {
        const uint32_t c = seq[p + j];
        key.clean = key.clean && c < 4;
        key.l1 |= (c < 4 ? c : 0u) << (62 - 2 * j);
    }
    return key;
}

template <bool BLOCK>
__device__ __forceinline__ void group_sync() {
    if (BLOCK)
        __syncthreads();
    else
        __syncwarp();
}

// Mark the minimizers of one sequence (its L codes in shared seq, its
// length len) by a group of `size` threads, this one of rank `rank`:
// afterwards mark[p] == 3 exactly where minimizer_mask's is_mm holds.
// km, when given, receives the (P, 2) key limbs.
template <bool BLOCK>
__device__ void mark_minimizers(const uint8_t* seq, int L, int len, int k,
                                int w, uint32_t* h, uint8_t* mark, int rank,
                                int size, long long* km) {
    const int P = positions(L, k);
    for (int p = rank; p < P; p += size) {
        const Key key = pack_key(seq, p, k);
        const bool valid = key.clean && p + k <= len;
        h[p] = valid ? hash_key(key.l0, key.l1) : INVALID;
        mark[p] = valid;
        if (km) {
            km[2 * p] = key.l0;
            km[2 * p + 1] = key.l1;
        }
    }
    group_sync<BLOCK>();
    // the read's complete windows; none when the row is too narrow for a
    // window at all (minimizer_mask's early return)
    const long long w_len = (long long)len - k - w + 2;
    const int n_win = (L - k - w + 2 <= 0 || w_len <= 0)
        ? 0 : (int)(w_len < P ? w_len : P);
    for (int i = rank; i < n_win; i += size) {
        int best = i;
        uint32_t bh = h[i];
        for (int d = 1; d < w; ++d) {
            const int j = i + d;
            const uint32_t v = j < P ? h[j] : INVALID;
            if (v < bh) {          // strict: the leftmost minimum stays
                bh = v;
                best = j;
            }
        }
        // every writer stores the same 3 over a valid mark
        if (best < P && mark[best]) mark[best] = 3;
    }
    group_sync<BLOCK>();
}

__device__ __forceinline__ uint32_t cuckoo_h(uint32_t q0, uint32_t q1,
                                             uint32_t salt, uint32_t mask,
                                             int which) {
    const uint32_t x = which == 0
        ? (q0 ^ (q1 * 0x9E3779B1u)) + salt
        : (q1 ^ (q0 * 0x85EBCA77u)) + (salt ^ 0x5BD1E995u);
    return fmix32(x) & mask;
}

// The value row index of the key's first matching slot, b1's four before
// b2's; -1 when it is in neither bucket.
__device__ __forceinline__ long long probe(const long long* __restrict__ hkeys,
                                           uint32_t mask, uint32_t salt,
                                           uint32_t q0, uint32_t q1) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
        const uint32_t b = cuckoo_h(q0, q1, salt, mask, which);
        const longlong2* row =
            reinterpret_cast<const longlong2*>(hkeys + (size_t)b * 2 * CUCKOO_CAP);
#pragma unroll
        for (int t = 0; t < CUCKOO_CAP; ++t) {
            const longlong2 kv = __ldg(row + t);
            if ((uint32_t)kv.x == q0 && (uint32_t)kv.y == q1)
                return (long long)b * CUCKOO_CAP + t;
        }
    }
    return -1;
}

__device__ __forceinline__ int warp_sum(int v) {
    return __reduce_add_sync(FULL, v);
}

__device__ __forceinline__ int warp_max(int v) {
    return __reduce_max_sync(FULL, v);
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const long long u = __shfl_xor_sync(FULL, v, o);
        v = u < v ? u : v;
    }
    return v;
}

struct Pool {
    const long long* pk;      // (nwords,) nibble-packed, sentinel words
    long long nwords;
    const long long* off;     // (n_edges + 1,)
    long long pad_nibbles;    // 8 * POOL_PAD_W
    int mt, mm;
};

// Gapless score of the query q (L codes, length len) at the signed
// offset start on edge max(edge, 0), over the on-edge positions only, by
// one warp: (bound, feasible).  q may be shared or global memory.
__device__ __forceinline__ void gapless(const Pool& pool, const uint8_t* q,
                                        int L, int len, long long edge,
                                        long long start, int lane,
                                        long long* bound, bool* feas) {
    const long long e = edge > 0 ? edge : 0;
    const long long off = pool.off[e];
    const long long elen = pool.off[e + 1] - off;
    const long long last = 8 * pool.nwords - 1;
    int nm = 0, non = 0;
    for (int j = lane; j < L; j += 32) {
        const long long tpos = start + j;
        if (tpos >= 0 && tpos < elen && j < len) {
            long long g = off + tpos + pool.pad_nibbles;
            g = g < 0 ? 0 : (g > last ? last : g);
            const uint32_t nib = (uint32_t)(
                (unsigned long long)pool.pk[g >> 3] >> (4 * (g & 7))) & 0xFu;
            ++non;
            nm += (uint32_t)q[j] == nib;
        }
    }
    nm = warp_sum(nm);
    non = warp_sum(non);
    *bound = (long long)nm * pool.mt + (long long)(non - nm) * pool.mm;
    *feas = non > 0 && edge >= 0;
}

struct MapArgs {
    const uint8_t* bases;     // (B, L)
    const int* lengths;       // (B,)
    long long B;
    int L, k, w, cap;
    const long long* hkeys;   // (NB, 8)
    const long long* vals;    // (NB * 4, 2)
    uint32_t mask, salt;
    long long big;
    Pool pool;
    const long long* thr;     // (B,), verified only
    int verified;
    long long* best_edge;
    long long* best_hits;
    long long* est_start;
    long long* bound;         // verified only
    uint8_t* fast;            // verified only
};

__global__ void __launch_bounds__(32 * MAP_WARPS)
map_kernel(MapArgs a, int warps) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
    if (b >= a.B) return;              // the whole warp: no block barrier
    const int L = a.L, k = a.k, P = positions(L, k);
    unsigned char* base = smem + (size_t)(threadIdx.x >> 5) * warp_smem(L, k);
    long long* s_start = reinterpret_cast<long long*>(base);
    int* s_edge = reinterpret_cast<int*>(base + 8 * MAX_CAP);
    int* s_pos = reinterpret_cast<int*>(base + 12 * MAX_CAP);
    uint32_t* h = reinterpret_cast<uint32_t*>(base + 16 * MAX_CAP);
    uint8_t* seq = reinterpret_cast<uint8_t*>(h) + align16(4 * P);
    uint8_t* mark = seq + align16(L);

    const uint8_t* row = a.bases + b * L;
    for (int i = lane; i < L; i += 32) seq[i] = row[i];
    __syncwarp();
    const int len = a.lengths[b];
    mark_minimizers<false>(seq, L, len, k, a.w, h, mark, lane, 32, nullptr);

    // the first cap marked positions, ascending
    int n = 0;
    for (int p0 = 0; p0 < P && n < a.cap; p0 += 32) {
        const int p = p0 + lane;
        const bool f = p < P && mark[p] == 3;
        const unsigned bal = __ballot_sync(FULL, f);
        const int r = n + __popc(bal & ((1u << lane) - 1u));
        if (f && r < a.cap) s_pos[r] = p;
        n += __popc(bal);
    }
    n = n < a.cap ? n : a.cap;
    __syncwarp();

    for (int s = lane; s < n; s += 32) {
        const int p = s_pos[s];
        const Key key = pack_key(seq, p, k);
        const long long f = probe(a.hkeys, a.mask, a.salt, key.l0, key.l1);
        int edge = SENT;
        long long start = a.big;
        if (f >= 0) {
            const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(a.vals) + f);
            if (v.x > 0) {            // a singleton: edge + 1
                edge = (int)(v.x - 1);
                start = v.y - p;      // signed: < 0 over the edge head
            }
        }
        s_edge[s] = edge;
        s_start[s] = start;
    }
    __syncwarp();

    int cnt[2] = {0, 0}, ed[2] = {SENT, SENT};
    long long mn[2] = {a.big, a.big};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        if (s < n && s_edge[s] != SENT) {
            ed[u] = s_edge[s];
            for (int t = 0; t < n; ++t) {
                if (s_edge[t] == ed[u]) {
                    ++cnt[u];
                    mn[u] = s_start[t] < mn[u] ? s_start[t] : mn[u];
                }
            }
        }
    }
    const int best = warp_max(cnt[0] > cnt[1] ? cnt[0] : cnt[1]);
    const int tot = warp_sum((ed[0] != SENT) + (ed[1] != SENT));
    // each edge at the best count holds `best` slots
    const int n_best = best > 0
        ? warp_sum((cnt[0] == best) + (cnt[1] == best)) / best : 0;
    int pick_edge = -1;
    long long pick_start = a.big;
    if (n_best == 1) {
        int e = -1;
        long long s = a.big;
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (cnt[u] == best) {
                e = ed[u];
                s = mn[u];
            }
        pick_edge = warp_max(e);
        pick_start = warp_min(s);
    }
    // confidence gate (RATIO_OF_CONFIDENT=0.85, MIN_NUMBER_SINGLETON=2)
    const bool conf = 100LL * best >= 85LL * tot || tot <= 2;
    const long long be = conf ? pick_edge : -1;
    const long long bs = be >= 0 ? pick_start : -1;
    if (lane == 0) {
        a.best_edge[b] = be;
        a.best_hits[b] = best;
        a.est_start[b] = bs;
    }
    if (a.verified) {
        long long bound;
        bool feas;
        gapless(a.pool, seq, L, len, be, bs, lane, &bound, &feas);
        if (lane == 0) {
            a.bound[b] = bound;
            a.fast[b] = feas && bound >= a.thr[b];
        }
    }
}

__global__ void __launch_bounds__(32 * MAP_WARPS)
bound_kernel(const uint8_t* __restrict__ bases, const int* __restrict__ lengths,
             const long long* __restrict__ edges,
             const long long* __restrict__ starts, long long N, int L,
             Pool pool, long long* bound, uint8_t* feas) {
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * MAP_WARPS + (threadIdx.x >> 5);
    if (b >= N) return;
    long long bd;
    bool fs;
    gapless(pool, bases + b * L, L, lengths[b], edges[b], starts[b], lane,
            &bd, &fs);
    if (lane == 0) {
        bound[b] = bd;
        feas[b] = fs;
    }
}

__global__ void __launch_bounds__(ROW_THREADS)
rows_kernel(const uint8_t* __restrict__ bases, const int* __restrict__ lengths,
            int L, int k, int w, long long* km, uint8_t* is_mm) {
    extern __shared__ __align__(16) unsigned char smem[];
    const long long b = blockIdx.x;
    const int P = positions(L, k);
    uint32_t* h = reinterpret_cast<uint32_t*>(smem);
    uint8_t* seq = smem + align16(4 * P);
    uint8_t* mark = seq + align16(L);
    const uint8_t* row = bases + b * L;
    for (int i = threadIdx.x; i < L; i += blockDim.x) seq[i] = row[i];
    __syncthreads();
    mark_minimizers<true>(seq, L, lengths[b], k, w, h, mark, threadIdx.x,
                          blockDim.x, km + b * P * 2);
    for (int p = threadIdx.x; p < P; p += blockDim.x)
        is_mm[b * P + p] = mark[p] == 3;
}

bool bad_shape(long long B, int L, int k, int w) {
    return B < 0 || L < 0 || k < 17 || k > 32 || w < 1;
}

// Opt a kernel in to smem bytes of dynamic shared memory where it needs
// more than the default; the CUDA error, 0 when it fits.
template <class F>
int fit_smem(F kernel, size_t smem) {
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem <= SMEM_DEFAULT) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// The map entry: reads (B, L) uint8 codes and (B,) int32 lengths, the
// cuckoo tables (nb, 8) and (nb * 4, 2) int64 with their salt, 17 <= k
// <= 32, w >= 1, cap <= 64 slots a read (L - k + 1 >= cap); verified:
// the nibble-packed pool (nwords,) and seq_off int64, the thresholds (B,)
// int64, the scores.  Writes best_edge, best_hits, est_start (B,) int64
// and, verified, bound (B,) int64 and fast (B,) bool.  nb is a power of
// two.
extern "C" int mm_map_batch_launch(
        const void* bases, const void* lengths, long long B, int L, int k,
        int w, const void* hkeys, long long nb, const void* vals,
        long long salt, int cap, long long big, int verified,
        const void* seq_pk, long long nwords, const void* seq_off,
        long long pad_nibbles, const void* thr, int mt, int mm,
        void* best_edge, void* best_hits, void* est_start, void* bound,
        void* fast, void* stream) {
    if (bad_shape(B, L, k, w) || cap < 1 || cap > MAX_CAP ||
            positions(L, k) < cap || nb < 1 || (nb & (nb - 1)) ||
            nb > (1LL << 32))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const size_t per = (size_t)warp_smem(L, k);
    int warps = (int)(SMEM_MAX / per);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    if (warps > MAP_WARPS) warps = MAP_WARPS;
    const size_t smem = per * warps;
    int rc = fit_smem(map_kernel, smem);
    if (rc) return rc;
    const long long blocks = (B + warps - 1) / warps;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    MapArgs a;
    a.bases = static_cast<const uint8_t*>(bases);
    a.lengths = static_cast<const int*>(lengths);
    a.B = B;
    a.L = L;
    a.k = k;
    a.w = w;
    a.cap = cap;
    a.hkeys = static_cast<const long long*>(hkeys);
    a.vals = static_cast<const long long*>(vals);
    a.mask = (uint32_t)(nb - 1);
    a.salt = (uint32_t)salt;
    a.big = big;
    a.pool = Pool{static_cast<const long long*>(seq_pk), nwords,
                  static_cast<const long long*>(seq_off), pad_nibbles, mt, mm};
    a.thr = static_cast<const long long*>(thr);
    a.verified = verified;
    a.best_edge = static_cast<long long*>(best_edge);
    a.best_hits = static_cast<long long*>(best_hits);
    a.est_start = static_cast<long long*>(est_start);
    a.bound = static_cast<long long*>(bound);
    a.fast = static_cast<uint8_t*>(fast);
    map_kernel<<<(unsigned)blocks, 32 * warps, smem,
                 static_cast<cudaStream_t>(stream)>>>(a, warps);
    return (int)cudaGetLastError();
}

// The bound entry: queries (N, L) uint8 codes and (N,) int32 lengths at
// edges and signed starts (N,) int64, the pool as above.  Writes bound (N,)
// int64 and feas (N,) bool.
extern "C" int mm_gapless_bound_launch(
        const void* bases, const void* lengths, const void* edges,
        const void* starts, long long N, int L, const void* seq_pk,
        long long nwords, const void* seq_off, long long pad_nibbles, int mt,
        int mm, void* bound, void* feas, void* stream) {
    if (N < 0 || L < 0) return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    const long long blocks = (N + MAP_WARPS - 1) / MAP_WARPS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    bound_kernel<<<(unsigned)blocks, 32 * MAP_WARPS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases), static_cast<const int*>(lengths),
        static_cast<const long long*>(edges),
        static_cast<const long long*>(starts), N, L,
        Pool{static_cast<const long long*>(seq_pk), nwords,
             static_cast<const long long*>(seq_off), pad_nibbles, mt, mm},
        static_cast<long long*>(bound), static_cast<uint8_t*>(feas));
    return (int)cudaGetLastError();
}

// The rows entry: segment rows (B, L) uint8 codes and (B,) int32 lengths,
// L >= k.  Writes the key limbs km (B, L - k + 1, 2) int64 and is_mm
// (B, L - k + 1) bool.
extern "C" int mm_minimizer_rows_launch(const void* bases,
                                        const void* lengths, long long B,
                                        int L, int k, int w, void* km,
                                        void* is_mm, void* stream) {
    if (bad_shape(B, L, k, w) || L < k || B > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const size_t smem = (size_t)seq_smem(L, k);
    const int rc = fit_smem(rows_kernel, smem);
    if (rc) return rc;
    rows_kernel<<<(unsigned)B, ROW_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases), static_cast<const int*>(lengths),
        L, k, w, static_cast<long long*>(km), static_cast<uint8_t*>(is_mm));
    return (int)cudaGetLastError();
}
