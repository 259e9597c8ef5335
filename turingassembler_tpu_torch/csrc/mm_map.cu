// The minimizer mapper's device program for Hopper: minimizer marks,
// cuckoo probe, vote and gapless bound of a read in one warp, and the
// index build's marks compacted in the kernel.
//
// Replaces jitted JAX functions (XLA, not Pallas) of
// turingassembler_tpu/mapper/minimizers.py:
//   - _map_batch_verified (:578) and _map_batch (:556): minimizer_mask
//     (:44), compaction to MM_CAP slots, _cuckoo_probe (:209), _vote_core
//     (:470) and, verified, _gapless_bound_dev (:706) of a batch of reads
//     (entry mm_map_batch_launch);
//   - _gapless_bound_dev alone, the bridge's rescore_hits
//     (entry mm_gapless_bound_launch);
//   - _compact_minimizer_rows (:232): minimizer_mask of the index
//     build's segment rows and the ascending compaction of the marked
//     positions (entry mm_minimizer_rows_launch).
// The port's plain versions are the tensor functions of
// turingassembler_tpu_torch/mapper/minimizers.py; every output equals
// theirs bit for bit.
//
// What bounds the map on an H100: instructions.  As a function it moves
// 0.024 ms of bytes at 3.35 TB/s for a 65,536-read batch (codes,
// lengths, a 64-byte bucket record a probe, the pool codes under each
// read, 17 bytes of outputs); what the kernel spends is the marks'
// integer work (a hash a window position, a leftmost minimum a window):
// chip_smoke.py phase 21's stage split (an H100 80GB HBM3 at 700 W)
// puts 0.076 of its 0.134 ms on the device in the marks.  The first,
// simple design took 0.190 ms of device time: a probe was two or three
// dependent trips (int64 key rows, then a value row), each window
// position re-read its 17 codes from shared memory and each window
// rescanned 17 hashes, the vote looped over n x n slots, a warp waited
// on its read's codes before any work, and the host packed the contig
// pool at every call.  This design:
//   - tables.  One 64-byte, 64-byte-aligned record a bucket, four slots
//     of (k0, k1, edge + 1 or 0, pos) as uint32 (ops/mm_map.py:
//     bucket_records, made once an index from the host cuckoo tables).
//     A key in b1 is one dependent read; b2's record is read only on a
//     b1 miss; the first matching slot wins, b1's four before b2's.  The
//     bench index's table is 64 MB (128 MB as int64 rows).  Key-only
//     rows of 32 bytes with 8-byte value rows (32 MB of keys, inside L2)
//     were timed beside it (phase 21's "split tables" variant): a hit
//     then costs a second dependent read, and that kernel was 2% slower.
//   - pool.  The graph's uint8 codes (seq_data), the copy the remainder
//     DP reads, cached on the card per graph (mapper/minimizers.py:
//     _device_pool) with 16 bytes of pad on both sides, so a word
//     load at any alignment stays inside the allocation.  Only on-edge
//     positions count, and there a code (< 16) equals the plain version's
//     nibble.  A nibble-packed uint32 pool was 2% slower (phase 21's timing).
//   - bound.  A lane compares eight codes a step: three aligned pool
//     words and two funnel shifts bring the window to the query's
//     alignment, a per-byte __vcmpeq4 and __popc count the matches,
//     masks cut the span's first and last words.  The bound entry runs
//     a group of lanes a query (bound_group), its first lane making the
//     query's dependent loads and handing the span to the group.  In the map,
//     where the warp's 32 lanes take a read of up to 256 codes in one
//     trip of pool loads, the bound is two dependent trips after the
//     vote (the edge's span, then its codes); the map's 48 registers
//     leave 5 blocks an SM, and every way tried to hide those trips
//     (the span loaded during the vote, the compare put off until the
//     next read is packed) cost registers or time (PERF.md).  The map's
//     stage gained nothing from the word compares: timed in turns it
//     was no faster than the byte loop it replaced (a code a lane a
//     step), since its time is those two trips, not the compares.  The
//     word form serves the bound entry, where it halved the time; do
//     not tune the map's stage on the belief that it helped there.
//   - marks.  A read's codes are packed once into 2-bit words and an
//     invalid-base bitmask, a thread 16 codes, four at a time (a byte
//     compare, a byte permute, a multiply); a window position's two
//     limbs are two funnel shifts, its validity one more.  Each window's
//     leftmost minimum is the minimum of the 64-bit key (hash << 32) |
//     position, taken for 32 windows at once by a sparse-table pass over
//     warp shuffles (log2 w steps, unrolled for the map's w = 17), and
//     the elected positions are OR-reduced into a 32-bit mark mask a
//     chunk.  Invalid windows compete at 0xFFFFFFFF and positions past
//     the row compare as 0xFFFFFFFF, as in minimizer_mask.
//   - vote.  A lane holds up to two of the <= MM_CAP slots;
//     __match_any_sync on their edges gives each slot its edge's count
//     (a loop of ballots over the second set when n > 32); warp
//     reductions give the best count, the edges at it (a tie is
//     unmapped), the hits in all, the 85% / <= 2 gate and the least
//     start of the picked edge.
//   - latency.  Persistent blocks (as many as are resident) walk the
//     batch a warp a read; while a read is marked and probed, cp.async
//     brings the next read's codes into the warp's other buffer (rows of
//     a width that is a multiple of 4) and its length into a register.
//     A warp keeps 0.7 KB of shared memory at 152 bases (1.9 KB with a
//     hash a window position and a mark byte in shared memory).
//   - outputs.  int32 edge, hits, start and bound and a bool fast flag,
//     written straight into the caller's (N,) arrays; the threshold is
//     one scalar or a (B,) int32 array.
// The rows entry is two launches of the same source, a block of 512
// threads a segment row: the marks pass stages and packs the row, keys
// each window position once into shared memory, elects a warp a chunk
// and writes the row's count and mark bitmask; the write pass takes the
// row's offset from the counts before it and writes the (l0, l1, row,
// position) int64 rows of its marks in ascending order (32 bytes a mark,
// about 3.7 MB a 256-row batch, where writing every position's limbs
// and mark for torch.nonzero to compact took 17 bytes a position, 17.9
// MB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t INVALID = 0xFFFFFFFFu;   // hash of a window not valid
constexpr uint32_t SEED = 0x9E3779B9u;      // hash_limbs' default seed
constexpr int CUCKOO_CAP = 4;               // slots a bucket
constexpr int MAX_CAP = 64;                 // slots a read: two a lane
constexpr int MAX_W = 32;                   // windows a sparse-table pass
constexpr int MM_W = 17;                    // the map's window (MM_W)
constexpr int SENT = 0x7FFFFFFF;            // a slot that votes nothing
constexpr int MAP_WARPS = 8;                // warps a block (map, bound)
constexpr int ROW_THREADS = 512;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 232448;         // 227 KB, a block's opt-in limit

__host__ __device__ __forceinline__ int align16(int x) {
    return (x + 15) & ~15;
}

__host__ __device__ __forceinline__ int positions(int L, int k) {
    return L - k + 1 > 0 ? L - k + 1 : 0;
}

// 2-bit words of a packed row of L codes (16 a word) and its invalid-base
// bitmask words (32 a word), each with zero words past the row for the
// funnel shifts of the last positions.
__host__ __device__ __forceinline__ int n_words(int L) { return L / 16 + 3; }
__host__ __device__ __forceinline__ int n_bad(int L) { return L / 32 + 2; }

// A warp's shared bytes in the map entry: two code buffers (the read
// and the next one), the packed words and bitmask, the slot positions;
// a multiple of 16, so each warp's buffers are 16-byte aligned.
__host__ __device__ __forceinline__ int warp_smem(int L) {
    return align16(2 * align16(L) + 4 * n_words(L) + 4 * n_bad(L) +
                   4 * MAX_CAP);
}

// The complete windows of a row of width L and length len: none when the
// row is too narrow for a window at all (minimizer_mask's early return).
__device__ __forceinline__ int n_windows(int L, int len, int k, int w) {
    const int P = positions(L, k);
    const long long w_len = (long long)len - k - w + 2;
    return (L - k - w + 2 <= 0 || w_len <= 0)
        ? 0 : (int)(w_len < P ? w_len : P);
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

// Pack a row of L codes (16-byte aligned, readable up to align16(L)) into
// its 2-bit words and its invalid-base bitmask, by `size` threads of rank
// `rank`, a thread a word of 16 codes.  Word j holds bases 16j..16j+15,
// base 16j+i in bits 31-2i..30-2i (the limb layout of ops/limbs.py); a
// code >= 4 packs as 0 and sets its bit of bad; codes past the row pack
// as 0 and are not bad.  Four codes at a time: a byte compare marks the
// codes >= 4, a byte permute and two shifts gather four 2-bit codes, a
// multiply gathers four bad bits.  Then the zero words past the row.
__device__ __forceinline__ void pack_row(const uint8_t* seq, int L,
                                         uint32_t* words, uint32_t* bad,
                                         int rank, int size) {
    const int nw = (L + 15) / 16;
    for (int j = rank; j < nw; j += size) {
        const uint4 x = *reinterpret_cast<const uint4*>(seq + 16 * j);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        uint32_t word = 0, bits = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const uint32_t big = __vcmpgtu4(xs[t], 0x03030303u);
            const uint32_t r = __byte_perm(xs[t] & ~big & 0x03030303u, 0,
                                           0x0123);
            const uint32_t u = r | (r >> 6);
            word |= ((u & 0xFu) | ((u >> 12) & 0xF0u)) << (24 - 8 * t);
            bits |= (((big & 0x01010101u) * 0x01020408u) >> 24) << (4 * t);
        }
        const int n_in = L - 16 * j;            // codes of the row here
        if (n_in < 16) {
            word &= INVALID << (32 - 2 * n_in);
            bits &= (1u << n_in) - 1u;
        }
        words[j] = word;
        reinterpret_cast<uint16_t*>(bad)[j] = (uint16_t)bits;
    }
    for (int j = nw + rank; j < n_words(L); j += size) words[j] = 0;
    for (int j = nw + rank; j < 2 * n_bad(L); j += size)
        reinterpret_cast<uint16_t*>(bad)[j] = 0;
}

struct Win {
    uint32_t l0, l1;   // the k-mer's limbs (ops/limbs.py: base_shift)
    bool clean;        // no code >= 4 in it
};

// The k-mer at position p of a packed row, 17 <= k <= 32: limb 0 holds
// bases p..p+15, limb 1 bases p+16..p+k-1 in its top bits.
__device__ __forceinline__ Win window_at(const uint32_t* words,
                                         const uint32_t* bad, int p, int k) {
    const int q = p >> 4, s = 2 * (p & 15);
    const uint32_t w0 = words[q], w1 = words[q + 1], w2 = words[q + 2];
    const uint32_t b = __funnelshift_r(bad[p >> 5], bad[(p >> 5) + 1], p & 31);
    Win r;
    r.l0 = __funnelshift_l(w1, w0, s);
    r.l1 = __funnelshift_l(w2, w1, s) & (INVALID << (64 - 2 * k));
    r.clean = (b & (k == 32 ? INVALID : (1u << k) - 1u)) == 0;
    return r;
}

// The window key (hash << 32) | p of position p and whether it is valid;
// a window that is not valid, or past the row's P positions, keys as
// hash 0xFFFFFFFF.
__device__ __forceinline__ unsigned long long key_at(
        const uint32_t* words, const uint32_t* bad, int p, int P, int len,
        int k, bool* valid) {
    uint32_t h = INVALID;
    *valid = false;
    if (p < P) {
        const Win wd = window_at(words, bad, p, k);
        *valid = wd.clean && p + k <= len;
        if (*valid) h = hash_key(wd.l0, wd.l1);
    }
    return ((unsigned long long)h << 32) | (uint32_t)p;
}

// The positions that windows 32c..32c+31 (lane i: window 32c + i, those
// below n_win) elect as their leftmost minimum, w <= MAX_W: bit j of
// `here` is position 32c + j, of `next` position 32c + 32 + j.  lo and hi
// are this lane's keys of positions 32c + lane and 32c + 32 + lane.  A
// sparse table over shuffles: after the loop a holds the minimum of the d
// keys from this lane's position (d the largest power of two <= w), and
// the window's is the least of two such spans.  The hi span is right for
// the lanes the next step reads (below d), the only ones it reads.
__device__ __forceinline__ void elect(unsigned long long lo,
                                      unsigned long long hi, int c,
                                      int n_win, int w, int lane,
                                      uint32_t* here, uint32_t* next) {
    unsigned long long a = lo, b = hi;
    int d = 1;
    for (; 2 * d <= w; d *= 2) {
        const int src = (lane + d) & 31;
        const unsigned long long xa = __shfl_sync(FULL, a, src);
        const unsigned long long xb = __shfl_sync(FULL, b, src);
        const unsigned long long va = lane + d < 32 ? xa : xb;
        a = va < a ? va : a;
        if (lane + d < 32) b = xb < b ? xb : b;
    }
    const int off = w - d;
    const int src = (lane + off) & 31;
    const unsigned long long xa = __shfl_sync(FULL, a, src);
    const unsigned long long xb = __shfl_sync(FULL, b, src);
    const unsigned long long va = lane + off < 32 ? xa : xb;
    const unsigned long long m = va < a ? va : a;
    const int at = 32 * c + lane < n_win ? (int)(uint32_t)m - 32 * c : -1;
    *here = __reduce_or_sync(FULL, at >= 0 && at < 32 ? 1u << at : 0u);
    *next = __reduce_or_sync(FULL, at >= 32 ? 1u << (at - 32) : 0u);
}

__device__ __forceinline__ uint32_t cuckoo_h(uint32_t q0, uint32_t q1,
                                             uint32_t salt, uint32_t mask,
                                             int which) {
    const uint32_t x = which == 0
        ? (q0 ^ (q1 * 0x9E3779B1u)) + salt
        : (q1 ^ (q0 * 0x85EBCA77u)) + (salt ^ 0x5BD1E995u);
    return fmix32(x) & mask;
}

struct Record {
    uint4 s[CUCKOO_CAP];   // (k0, k1, edge + 1 or 0, pos) a slot
};

__device__ __forceinline__ Record load_record(const uint4* table,
                                              uint32_t bucket) {
    const uint4* r = table + (size_t)bucket * CUCKOO_CAP;
    Record rec;
#pragma unroll
    for (int t = 0; t < CUCKOO_CAP; ++t) rec.s[t] = __ldg(r + t);
    return rec;
}

// The first slot of rec holding (q0, q1): its (edge + 1 or 0, pos) in
// *val and true; false when none does.
__device__ __forceinline__ bool match(const Record& rec, uint32_t q0,
                                      uint32_t q1, uint2* val) {
#pragma unroll
    for (int t = CUCKOO_CAP - 1; t >= 0; --t)
        if (rec.s[t].x == q0 && rec.s[t].y == q1)
            *val = make_uint2(rec.s[t].z, rec.s[t].w);
#pragma unroll
    for (int t = 0; t < CUCKOO_CAP; ++t)
        if (rec.s[t].x == q0 && rec.s[t].y == q1) return true;
    return false;
}

struct Pool {
    // the graph's seq_data on the card, readable 16 bytes before its
    // first code and after its last (ops/mm_map.py: POOL_PAD)
    const uint8_t* codes;
    const long long* off;     // (n_edges + 1,)
    int mt, mm;
};

// The on-edge span [lo, hi) of the positions j of a query of width L
// and length len at the signed offset start on an edge of elen codes.
__device__ __forceinline__ void on_edge(int L, int len, long long start,
                                        long long elen, int* lo, int* hi) {
    *lo = (int)(start < 0 ? (-start < L ? -start : L) : 0);
    const long long tail = elen - start;
    *hi = min(len, (int)(tail < L ? (tail > 0 ? tail : 0) : L));
}

// The query's codes j..j+3 as one word (byte i = code j + i), 0 from
// j = L on.  SHARED: q is a shared row, 16-byte aligned and readable to
// align16(L).  Else a global row: a word load when rows are 4-byte
// aligned (`words`), bytes below L otherwise.
template <bool SHARED>
__device__ __forceinline__ uint32_t query_word(const uint8_t* q, int j,
                                               int L, bool words) {
    if (SHARED) return *reinterpret_cast<const uint32_t*>(q + j);
    if (j >= L) return 0;
    if (words) return __ldg(reinterpret_cast<const uint32_t*>(q + j));
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (j + i < L) x |= (uint32_t)__ldg(q + j + i) << (8 * i);
    return x;
}

// 8 x the matches of query word q (codes j..j + 3) against the pool's
// word t, over the positions of [lo, hi) only: __vcmpeq4 marks each
// equal byte 0xFF (codes, not bases: code 4 matches code 4), masks cut
// the bytes outside the span, __popc counts.
__device__ __forceinline__ int word_matches(uint32_t q, uint32_t t, int j,
                                            int lo, int hi) {
    if (j + 4 <= lo || j >= hi) return 0;
    uint32_t m = FULL;
    if (j < lo) m <<= 8 * (lo - j);
    if (j + 4 > hi) m &= FULL >> (8 * (j + 4 - hi));
    return __popc(__vcmpeq4(q, t) & m);
}

// Gapless score of a query over its on-edge span [lo, hi), the pool
// code under position j at codes[at + j], by the G lanes of a group
// (rank r, mask gm): lane r compares the span's 8-code steps (lo >> 3)
// + r, + G, ..., all its loads of a step in one trip.  The pool's 8
// codes at any byte alignment are three aligned word loads and two
// funnel shifts by their byte offset; for a step that holds a code of
// a span that is not empty the loads reach at most 10 bytes before the
// pool's first code and 11 after its last, inside the pool's pad.  An
// empty span loads nothing.
template <bool SHARED>
__device__ __forceinline__ int gapless(const Pool& pool, const uint8_t* q,
                                       int L, bool words, long long at,
                                       int lo, int hi, int r, int G,
                                       unsigned gm) {
    int bits = 0;
    const int end = hi > lo ? hi : 0;
    for (int j = 8 * ((lo >> 3) + r); j < end; j += 8 * G) {
        const uintptr_t p = reinterpret_cast<uintptr_t>(pool.codes + at + j);
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(p & ~(uintptr_t)3);
        const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
        const unsigned sh = 8 * (unsigned)(p & 3);
        bits += word_matches(query_word<SHARED>(q, j, L, words),
                             __funnelshift_r(w0, w1, sh), j, lo, hi) +
                word_matches(query_word<SHARED>(q, j + 4, L, words),
                             __funnelshift_r(w1, w2, sh), j + 4, lo, hi);
    }
    const int nm = __reduce_add_sync(gm, bits) >> 3;
    const int non = hi > lo ? hi - lo : 0;
    return nm * pool.mt + (non - nm) * pool.mm;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}

// Start bringing row b's L codes into buf: cp.async in 4-byte words
// when every row is 4-byte aligned, else plain loads (done on return).
__device__ __forceinline__ void fetch_row(uint8_t* buf, const uint8_t* rows,
                                          long long b, int L, bool words4,
                                          int lane) {
    const uint8_t* src = rows + b * L;
    if (words4) {
        for (int i = 4 * lane; i < L; i += 128) cp_async4(buf + i, src + i);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
        for (int i = lane; i < L; i += 32) buf[i] = src[i];
    }
}

struct MapArgs {
    const uint8_t* bases;     // (B, L)
    const int* lengths;       // (B,)
    long long B;
    int L, k, w, cap;
    const uint4* table;       // (nb * 4,) slots: bucket records
    uint32_t mask, salt;
    int big;
    Pool pool;
    const int* thr;           // (B,), or null: thr_all for every read
    int thr_all;
    int verified;
    int* best_edge;
    int* best_hits;
    int* est_start;
    int* bound;               // verified only
    uint8_t* fast;            // verified only
};

// The cuckoo probe of the minimizer at position p of a packed read: b1's
// record, b2's only on a miss.  A singleton key sets its edge and signed
// start (< 0 over the edge head); any other slot leaves them.
__device__ __forceinline__ void probe(const MapArgs& a, const uint32_t* words,
                                      const uint32_t* bad, int p, int* edge,
                                      int* start) {
    const Win wd = window_at(words, bad, p, a.k);
    uint2 v;
    bool found = match(load_record(a.table, cuckoo_h(wd.l0, wd.l1, a.salt,
                                                     a.mask, 0)),
                       wd.l0, wd.l1, &v);
    if (!found)
        found = match(load_record(a.table, cuckoo_h(wd.l0, wd.l1, a.salt,
                                                     a.mask, 1)),
                      wd.l0, wd.l1, &v);
    if (found && v.x > 0) {            // a singleton: edge + 1
        *edge = (int)(v.x - 1);
        *start = (int)v.y - p;
    }
}

__global__ void __launch_bounds__(32 * MAP_WARPS)
map_kernel(MapArgs a, int warps) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int L = a.L, k = a.k, w = a.w, P = positions(L, k);
    unsigned char* base = smem + (size_t)(threadIdx.x >> 5) * warp_smem(L);
    uint32_t* words = reinterpret_cast<uint32_t*>(base + 2 * align16(L));
    uint32_t* bad = words + n_words(L);
    int* s_pos = reinterpret_cast<int*>(bad + n_bad(L));
    const long long stride = (long long)gridDim.x * warps;
    const bool words4 = (L & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(a.bases) & 3) == 0;

    long long b = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
    if (b >= a.B) return;              // the whole warp: no block barrier
    fetch_row(base, a.bases, b, L, words4, lane);
    int len_next = a.lengths[b];
    for (int it = 0; b < a.B; b += stride, ++it) {
        if (words4) cp_async_wait();
        __syncwarp();
        const uint8_t* seq = base + (it & 1) * align16(L);
        const int len = len_next;
        if (b + stride < a.B) {        // the next read, while this one runs
            fetch_row(base + ((it + 1) & 1) * align16(L), a.bases,
                      b + stride, L, words4, lane);
            len_next = a.lengths[b + stride];
        }

        // pack, then mark and compact to the first cap marked positions
        pack_row(seq, L, words, bad, lane, 32);
        __syncwarp();
        const int n_win = n_windows(L, len, k, w);
        int n = 0;
        if (n_win > 0) {
            const int nchunk = min((P + 31) / 32, (n_win + 31) / 32 + 1);
            bool v_lo, v_hi;
            unsigned long long lo = key_at(words, bad, lane, P, len, k, &v_lo);
            uint32_t carry = 0;
            for (int c = 0; c < nchunk; ++c) {
                const unsigned long long hi =
                    key_at(words, bad, 32 * c + 32 + lane, P, len, k, &v_hi);
                uint32_t here = 0, next = 0;
                if (32 * c < n_win) {
                    if (w == MM_W)         // the map's window, unrolled
                        elect(lo, hi, c, n_win, MM_W, lane, &here, &next);
                    else
                        elect(lo, hi, c, n_win, w, lane, &here, &next);
                }
                const uint32_t mk = (carry | here) & __ballot_sync(FULL, v_lo);
                carry = next;
                const int r = n + __popc(mk & ((1u << lane) - 1u));
                if ((mk >> lane & 1u) && r < a.cap) s_pos[r] = 32 * c + lane;
                n += __popc(mk);
                lo = hi;
                v_lo = v_hi;
            }
            n = n < a.cap ? n : a.cap;
        }
        __syncwarp();

        // probe: a lane a slot; the second set only when n > 32
        int edge[2] = {SENT, SENT}, start[2] = {a.big, a.big};
        if (lane < n) probe(a, words, bad, s_pos[lane], &edge[0], &start[0]);
        if (n > 32 && lane + 32 < n)
            probe(a, words, bad, s_pos[lane + 32], &edge[1], &start[1]);

        // vote: each slot's count of its edge among the read's hits
        int cnt[2];
        cnt[0] = __popc(__match_any_sync(FULL, edge[0]));
        cnt[1] = 0;
        if (n > 32) {
            cnt[1] = __popc(__match_any_sync(FULL, edge[1]));
            for (int j = 0; j < n - 32; ++j) {     // across the two sets
                const int ej = __shfl_sync(FULL, edge[1], j);
                cnt[0] += ej == edge[0];
                const int c0 = __popc(__ballot_sync(FULL, edge[0] == ej));
                if (lane == j) cnt[1] += c0;
            }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (edge[u] == SENT) cnt[u] = 0;
        const int best = __reduce_max_sync(FULL, max(cnt[0], cnt[1]));
        const int tot = __reduce_add_sync(FULL, (edge[0] != SENT) +
                                                (edge[1] != SENT));
        // each edge at the best count holds `best` slots
        const int n_best = best > 0
            ? __reduce_add_sync(FULL, (cnt[0] == best) + (cnt[1] == best)) /
              best
            : 0;
        int pick_edge = -1, pick_start = a.big;
        if (n_best == 1) {
            pick_edge = __reduce_max_sync(FULL, max(
                cnt[0] == best ? edge[0] : -1, cnt[1] == best ? edge[1] : -1));
            pick_start = __reduce_min_sync(FULL, min(
                edge[0] == pick_edge ? start[0] : a.big,
                edge[1] == pick_edge ? start[1] : a.big));
        }
        // confidence gate (RATIO_OF_CONFIDENT=0.85, MIN_NUMBER_SINGLETON=2)
        const bool conf = 100 * best >= 85 * tot || tot <= 2;
        const int be = conf ? pick_edge : -1;
        const int bs = be >= 0 ? pick_start : -1;
        if (lane == 0) {
            a.best_edge[b] = be;
            a.best_hits[b] = best;
            a.est_start[b] = bs;
        }
        if (a.verified) {              // the gapless bound at the vote
            const long long off = a.pool.off[be > 0 ? be : 0];
            int lo, hi;
            on_edge(L, len, bs, a.pool.off[(be > 0 ? be : 0) + 1] - off, &lo,
                    &hi);
            const int bound = gapless<true>(a.pool, seq, L, true, off + bs,
                                            lo, hi, lane, 32, FULL);
            if (lane == 0) {
                a.bound[b] = bound;
                a.fast[b] = hi > lo && be >= 0 &&
                            bound >= (a.thr ? a.thr[b] : a.thr_all);
            }
        }
        __syncwarp();                  // seq is refilled two reads on
    }
}

// Lanes a query in the bound entry: a power of two, at most 8 steps of
// 8 codes a lane (4 lanes at 152 codes: 5 steps, 8 queries a warp).
__host__ __device__ __forceinline__ int bound_group(int L) {
    int g = 1;
    while (g < 32 && 64 * g < L) g *= 2;
    return g;
}

// The bound entry: a group of G lanes a query.  The group's first lane
// loads the query's edge, start and length and then its edge's span in
// the pool, and hands the on-edge span to the group by shuffles, so a
// warp has 32 / G queries' dependent loads in flight.
__global__ void __launch_bounds__(32 * MAP_WARPS)
bound_kernel(const uint8_t* __restrict__ bases, const int* __restrict__ lengths,
             const long long* __restrict__ edges,
             const long long* __restrict__ starts, long long N, int L, int G,
             Pool pool, int* bound, uint8_t* feas) {
    const int lane = threadIdx.x & 31, r = lane & (G - 1);
    const long long b0 = ((long long)blockIdx.x * MAP_WARPS +
                          (threadIdx.x >> 5)) * (32 / G);
    if (b0 >= N) return;               // the whole warp: no block barrier
    const long long b = b0 + lane / G;
    const unsigned gm = G == 32 ? FULL : ((1u << G) - 1u) << (lane & ~(G - 1));
    long long at = 0, edge = -1;
    int lo = 0, hi = 0;
    if (r == 0 && b < N) {
        edge = edges[b];
        const long long start = starts[b];
        const int len = lengths[b];
        const long long off = pool.off[edge > 0 ? edge : 0];
        on_edge(L, len, start, pool.off[(edge > 0 ? edge : 0) + 1] - off,
                &lo, &hi);
        at = off + start;
    }
    lo = __shfl_sync(FULL, lo, 0, G);
    hi = __shfl_sync(FULL, hi, 0, G);
    at = __shfl_sync(FULL, at, 0, G);
    const bool words = (L & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(bases) & 3) == 0;
    const int bd = gapless<false>(pool, bases + (b < N ? b : 0) * L, L,
                                  words, at, lo, hi, r, G, gm);
    if (r == 0 && b < N) {
        bound[b] = bd;
        feas[b] = hi > lo && edge >= 0;
    }
}

// The rows entry's shared memory: the row's codes, its packed words and
// bitmask, its window keys, and (marks pass) the marks and valid
// positions of its chunks.
__host__ __device__ __forceinline__ int row_chunks(int L, int k) {
    return (positions(L, k) + 31) / 32;
}

__host__ __device__ __forceinline__ size_t row_smem(int L, int k,
                                                   bool marks) {
    const size_t packed = align16(L) + 4 * (size_t)(n_words(L) + n_bad(L));
    return marks ? align16((int)packed) + 8 * (size_t)positions(L, k) +
                   4 * (size_t)(2 * row_chunks(L, k) + 1)
                 : packed;
}

// A block stages row b's L codes in shared memory and packs them.
__device__ __forceinline__ void stage_row(const uint8_t* row, int L,
                                          uint8_t* seq, uint32_t* words,
                                          uint32_t* bad) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) seq[i] = row[i];
    __syncthreads();
    pack_row(seq, L, words, bad, threadIdx.x, blockDim.x);
    __syncthreads();
}

// Marks pass: a block a row.  Each window position's key once into
// shared memory, then a warp a chunk of 32 windows elects; writes the
// row's mark bitmask (row_chunks words) and its count of marks.
__global__ void __launch_bounds__(ROW_THREADS, 2)
rows_mark_kernel(const uint8_t* __restrict__ bases,
                 const int* __restrict__ lengths, int L, int k, int w,
                 uint32_t* marks, int* counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    const long long b = blockIdx.x;
    const int P = positions(L, k), nch = row_chunks(L, k);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    uint8_t* seq = smem;
    uint32_t* words = reinterpret_cast<uint32_t*>(smem + align16(L));
    uint32_t* bad = words + n_words(L);
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(
        smem + align16((int)row_smem(L, k, false)));
    uint32_t* mk = reinterpret_cast<uint32_t*>(keys + P);   // nch + 1
    uint32_t* valid = mk + nch + 1;                          // nch
    __shared__ int total;
    for (int j = threadIdx.x; j <= nch; j += blockDim.x) mk[j] = 0;
    if (threadIdx.x == 0) total = 0;
    stage_row(bases + b * L, L, seq, words, bad);
    const int len = lengths[b];
    const int n_win = n_windows(L, len, k, w);
    for (int c = warp; c < nch; c += nwarps) {
        bool v;
        const int p = 32 * c + lane;
        const unsigned long long key = key_at(words, bad, p, P, len, k, &v);
        if (p < P) keys[p] = key;
        const uint32_t vm = __ballot_sync(FULL, v);
        if (lane == 0) valid[c] = vm;
    }
    __syncthreads();
    for (int c = warp; 32 * c < n_win; c += nwarps) {
        const int p = 32 * c + lane;
        const unsigned long long inv = (unsigned long long)INVALID << 32;
        const unsigned long long lo = p < P ? keys[p] : inv | (uint32_t)p;
        const unsigned long long hi =
            p + 32 < P ? keys[p + 32] : inv | (uint32_t)(p + 32);
        uint32_t here, next;
        if (w == MM_W)
            elect(lo, hi, c, n_win, MM_W, lane, &here, &next);
        else
            elect(lo, hi, c, n_win, w, lane, &here, &next);
        if (lane == 0) {
            atomicOr(mk + c, here);
            atomicOr(mk + c + 1, next);
        }
    }
    __syncthreads();
    int cnt = 0;
    for (int j = threadIdx.x; j < nch; j += blockDim.x) {
        const uint32_t m = mk[j] & valid[j];
        marks[b * nch + j] = m;
        cnt += __popc(m);
    }
    cnt = __reduce_add_sync(FULL, cnt);
    if (lane == 0) atomicAdd(&total, cnt);
    __syncthreads();
    if (threadIdx.x == 0) counts[b] = total;
}

// The exclusive block-wide prefix sum of one int a thread (blockDim.x a
// multiple of 32, at most 1024); *sum receives the block's total.
__device__ __forceinline__ int block_scan(int v, int* scratch, int* sum) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int t = lane < nwarps ? scratch[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, t, o);
            if (lane >= o) t += y;
        }
        if (lane < nwarps) scratch[lane] = t;
    }
    __syncthreads();
    const int before = (warp > 0 ? scratch[warp - 1] : 0) + x - v;
    *sum = scratch[nwarps - 1];
    __syncthreads();
    return before;
}

// Write pass: a block a row; the row's offset is the marks of the rows
// before it, each mark's rank within the row comes from the bitmask, and
// a mark's row is (l0, l1, segment row, position) as int64.
__global__ void __launch_bounds__(ROW_THREADS, 2)
rows_write_kernel(const uint8_t* __restrict__ bases, int L, int k,
                  long long B, const uint32_t* __restrict__ marks,
                  const int* __restrict__ counts, longlong2* out,
                  int* n_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scratch[32];
    const long long b = blockIdx.x;
    const int nch = row_chunks(L, k);
    uint8_t* seq = smem;
    uint32_t* words = reinterpret_cast<uint32_t*>(smem + align16(L));
    uint32_t* bad = words + n_words(L);
    int part = 0, sum;
    for (long long r = threadIdx.x; r < b; r += blockDim.x) part += counts[r];
    block_scan(part, scratch, &sum);
    long long at = sum;                       // marks of the rows before
    stage_row(bases + b * L, L, seq, words, bad);
    for (int j0 = 0; j0 < nch; j0 += blockDim.x) {
        const int j = j0 + threadIdx.x;
        uint32_t m = j < nch ? marks[b * nch + j] : 0u;
        int tile;
        const int rank = block_scan(__popc(m), scratch, &tile);
        long long o = at + rank;
        while (m) {
            const int i = __ffs(m) - 1;
            m &= m - 1;
            const int p = 32 * j + i;
            const Win wd = window_at(words, bad, p, k);
            out[2 * o] = make_longlong2(wd.l0, wd.l1);
            out[2 * o + 1] = make_longlong2(b, p);
            ++o;
        }
        at += tile;
    }
    if (b == B - 1 && threadIdx.x == 0) *n_out = (int)at;
}

bool bad_shape(long long B, int L, int k, int w) {
    return B < 0 || L < 0 || k < 17 || k > 32 || w < 1 || w > MAX_W;
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
// bucket records (nb, 16) uint32 (64-byte aligned) with their salt, 17 <=
// k <= 32, 1 <= w <= 32, cap <= 64 slots a read (L - k + 1 >= cap);
// verified: the pool's uint8 codes and seq_off int64, the thresholds (B,)
// int32 or null for thr_all, the scores.  Writes best_edge, best_hits,
// est_start (B,) int32 and, verified, bound (B,) int32 and fast (B,)
// bool.  nb is a power of two.
extern "C" int mm_map_batch_launch(
        const void* bases, const void* lengths, long long B, int L, int k,
        int w, const void* table, long long nb, long long salt, int cap,
        int big, int verified, const void* codes, const void* seq_off,
        const void* thr, int thr_all, int mt, int mm, void* best_edge,
        void* best_hits, void* est_start, void* bound, void* fast,
        void* stream) {
    if (bad_shape(B, L, k, w) || cap < 1 || cap > MAX_CAP ||
            positions(L, k) < cap || nb < 1 || (nb & (nb - 1)) ||
            nb > (1LL << 32))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const size_t per = (size_t)warp_smem(L);
    int warps = (int)(SMEM_MAX / per);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    if (warps > MAP_WARPS) warps = MAP_WARPS;
    const size_t smem = per * warps;
    int rc = fit_smem(map_kernel, smem);
    if (rc) return rc;
    int dev, sms, per_sm;
    if ((rc = (int)cudaGetDevice(&dev)) ||
            (rc = (int)cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, map_kernel, 32 * warps, smem)))
        return rc;
    // persistent blocks: as many as are resident at once, or fewer
    long long blocks = (B + warps - 1) / warps;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (blocks > resident) blocks = resident;
    MapArgs a;
    a.bases = static_cast<const uint8_t*>(bases);
    a.lengths = static_cast<const int*>(lengths);
    a.B = B;
    a.L = L;
    a.k = k;
    a.w = w;
    a.cap = cap;
    a.table = static_cast<const uint4*>(table);
    a.mask = (uint32_t)(nb - 1);
    a.salt = (uint32_t)salt;
    a.big = big;
    a.pool = Pool{static_cast<const uint8_t*>(codes),
                  static_cast<const long long*>(seq_off), mt, mm};
    a.thr = static_cast<const int*>(thr);
    a.thr_all = thr_all;
    a.verified = verified;
    a.best_edge = static_cast<int*>(best_edge);
    a.best_hits = static_cast<int*>(best_hits);
    a.est_start = static_cast<int*>(est_start);
    a.bound = static_cast<int*>(bound);
    a.fast = static_cast<uint8_t*>(fast);
    map_kernel<<<(unsigned)blocks, 32 * warps, smem,
                 static_cast<cudaStream_t>(stream)>>>(a, warps);
    return (int)cudaGetLastError();
}

// The bound entry: queries (N, L) uint8 codes and (N,) int32 lengths at
// edges and signed starts (N,) int64, the pool as above.  Writes bound
// (N,) int32 and feas (N,) bool.
extern "C" int mm_gapless_bound_launch(
        const void* bases, const void* lengths, const void* edges,
        const void* starts, long long N, int L, const void* codes,
        const void* seq_off, int mt, int mm, void* bound, void* feas,
        void* stream) {
    if (N < 0 || L < 0) return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    const int G = bound_group(L);
    const long long per_block = (long long)MAP_WARPS * (32 / G);
    const long long blocks = (N + per_block - 1) / per_block;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    bound_kernel<<<(unsigned)blocks, 32 * MAP_WARPS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases), static_cast<const int*>(lengths),
        static_cast<const long long*>(edges),
        static_cast<const long long*>(starts), N, L, G,
        Pool{static_cast<const uint8_t*>(codes),
             static_cast<const long long*>(seq_off), mt, mm},
        static_cast<int*>(bound), static_cast<uint8_t*>(feas));
    return (int)cudaGetLastError();
}

// The rows entry: segment rows (B, L) uint8 codes and (B,) int32 lengths,
// L >= k.  Scratch: marks (B, ceil((L - k + 1) / 32)) and counts (B,)
// int32.  Writes the rows of the marked positions, ascending by (row,
// position), as (n, 4) uint32 (l0, l1, row, position) into out (room for
// B * (L - k + 1), 16-byte aligned) and n into n_out; B >= 1.
extern "C" int mm_minimizer_rows_launch(const void* bases,
                                        const void* lengths, long long B,
                                        int L, int k, int w, void* marks,
                                        void* counts, void* out, void* n_out,
                                        void* stream) {
    if (bad_shape(B, L, k, w) || L < k || B < 1 || B > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const size_t smem_mark = row_smem(L, k, true);
    const size_t smem_write = row_smem(L, k, false);
    int rc = fit_smem(rows_mark_kernel, smem_mark);
    if (rc || (rc = fit_smem(rows_write_kernel, smem_write))) return rc;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    rows_mark_kernel<<<(unsigned)B, ROW_THREADS, smem_mark, s>>>(
        static_cast<const uint8_t*>(bases), static_cast<const int*>(lengths),
        L, k, w, static_cast<uint32_t*>(marks), static_cast<int*>(counts));
    if ((rc = (int)cudaGetLastError())) return rc;
    rows_write_kernel<<<(unsigned)B, ROW_THREADS, smem_write, s>>>(
        static_cast<const uint8_t*>(bases), L, k, B,
        static_cast<const uint32_t*>(marks), static_cast<const int*>(counts),
        static_cast<longlong2*>(out), static_cast<int*>(n_out));
    return (int)cudaGetLastError();
}
