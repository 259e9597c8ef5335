// The k-mer count's device program for Hopper: canonical (k+1)-mer
// extraction, the sort-and-count of limb rows, the stable lexicographic
// permutation, the merge of two runs, and beneath them a stable LSD radix
// sort of limb rows with a run-length count (a segmented sum of a
// payload).
//
// Replaces jitted JAX device code (XLA, not Pallas):
//   - turingassembler_tpu/kmer/megasort.py:73 _extract_chunk (+
//     ops/kmers.py:64 extract_canonical_kmers): entry ks_extract_launch;
//   - megasort.py:165 _sort_count (lax.sort with num_keys, then the
//     run-length pass): ks_load_launch, then a prefix partition
//     (ks_sort_passes_launch on the partition digits, ks_bounds_launch)
//     and a bucket sort-and-count (ks_bucket_launch, ks_compact_*);
//   - megasort.py:225 _merge_unique_runs: a merge path over the two
//     ascending inputs (ks_merge_count_launch, ks_merge_write_launch),
//     the counts of equal rows summed (any number, where the JAX function
//     sums at most two); inputs out of order take the LSD sort with the
//     counts as payload and the run pass;
//   - the stable lexicographic permutation (JAX lax.sort with num_keys,
//     graph/device_build.py:89; the port's ops/limbs.py:plain_lex_order):
//     the prefix partition with the row index as payload, then the
//     buckets ranked (ks_lex_buckets_launch).
//
// What bounds each kernel on an H100, and what the design does about it
// (bytes at 3.35 TB/s unless said otherwise):
//
// Extraction (extract_kernel, one launch).  Bound: the reads' bytes in
// and the rows out.  A block takes R reads (about 4,096 windows, 16 a
// thread) and loads their contiguous R x L bytes as 16-byte chunks into
// shared memory.  Each read is packed once into 2-bit words (L / 16 + 5
// a read, base 0 in the top bits, a zero word before and after), with
// the reverse complement of every word beside it and the invalid-base
// mask (codes >= 4) as 16-bit halves.  A window's forward limb l is a
// funnel shift of two neighbouring forward words at p + 16 l, its
// reverse-complement limb a funnel shift of two reverse-complement words
// at p + k1 - 16 - 16 l; the smaller wins (ties keep the forward form).
// A warp takes a contiguous run of windows, 32 at a time, and ranks the
// valid ones by ballots, so the block's rows keep (read, window) order
// with no block scan a chunk.  The block's offset in the output comes
// from a decoupled look-back over blocks in ticket order (a 64-bit
// status word a block: its count and a flag, aggregate or inclusive
// prefix), so one launch does what a count pass, a scan and a write pass
// did.  Rows are staged in shared memory and written as one contiguous
// range of out, 16-byte stores between 4-byte head and tail words.
//
// Sort-and-count (sort_count).  As a function it reads the rows once and
// writes the unique rows and counts once (bench flush: 110 M rows, 2 M
// unique, about 55 copies a row).  A full LSD sort moves 32 bytes a row a
// pass, 12 passes at k1 = 46, and never needs the rows fully sorted.
// Here:
//   1. load_hist_kernel: row-major rows to SoA uint32 limbs, with each
//      limb's OR of row ^ row 0, which tells the live digits (one host
//      sync; no histogram, whose atomics contend on the few-valued
//      digits);
//   2. the host plans (ops/kmer_sort.py:sort_plan): the partition digits
//      are the most significant live digits, as many as keep the mean
//      bucket under a quarter of a block's capacity (none when the rows
//      fit one block, two at the bench: 65,536 buckets of 1,680 rows);
//   3. the LSD pass kernels below on those digits only (a stable sort on
//      the top digits groups the rows by their prefix, ascending; the
//      digit totals from the tile counts); bounds_kernel, each bucket's
//      first row by binary search (27 reads a bucket at 110 M rows, where
//      a scan would read a limb of every row);
//      groups_kernel, the buckets' groups (bucket_groups): a bucket, or a
//      run of small ones inside one 256-bucket block of the prefix, at
//      most cap rows, and the groups over cap, listed in group order
//      with their rows' total and each one's offset in a gathered
//      segment (block scans);
//   4. bucket_kernel: persistent blocks, a group at a time, the next
//      group's rows prefetched into L2.  The group's rows in shared
//      memory; equal rows counted once by a hash table of row indices;
//      the distinct rows placed, up to RANK_SORT of them by counting the
//      rows before each (broadcast reads, no barrier), more by stable LSD
//      passes over 16-bit indices (the live digits below the prefix, then
//      the group's low prefix digit); each distinct row, ascending, a run
//      at the group's first row of a scratch.  Block passes over every
//      row (11 at the bench) were bound by conflicted shared-memory
//      gathers and barriers; counting equal rows first leaves about 100
//      distinct rows a group;
//   5. compaction: one block scans the groups' run counts (one host sync
//      for the total, with the groups over cap and their rows), then a
//      warp a group copies its runs to uniq (int64 limbs) and counts.
// The buckets over the block's capacity (poly-A, high-copy repeats, all
// rows equal) take one batched route between steps 4 and 5, the same
// launches and host syncs for one such bucket or ten thousand:
// gather_kernel copies every one's rows, in group order (ascending
// prefix), into one SoA segment and ORs each limb's XOR against its
// first row (a host sync: the segment's live digits); the LSD pass
// kernels sort the segment on every live digit, the partition's
// included, so each group's rows stay where the gather put them, sorted;
// the run pass over the whole segment (a host sync: its runs; no run
// crosses a group, whose prefixes differ); place_runs_kernel puts each
// run at its group's first row plus its rank among the group's runs (a
// binary search of its start in the groups' offsets, one of the runs'
// starts for the group's first run) and the group's run count in gruns;
// then compaction's scan again (its total's sync).  Without a partition
// digit the one group is every row, all equal: the run pass reads the
// rows where they are.  The wrapper counts such buckets.  What bounds it
// now: the two partition passes (28 bytes a row each) and the load; the
// bucket kernel reads each row once; where buckets go over capacity,
// the segment's passes (up to 16 at nl = 4, 36 bytes a row each): 2,000
// such buckets of 23 M rows at nl = 4 take 11-12 ms on an H100, where a
// host loop of the LSD route a bucket took 1.5 s.
//
// Bucket capacity: a row takes its nl uint32 limbs, a uint16 count, a
// uint16 list entry and two uint16 hash slots, (4 nl + 8) bytes, beside
// 17,664 bytes of histograms, in 232,448 bytes: 16,384 rows at nl = 1
// (the uint16 / register limit, 32 rows a thread of 512), 13,408 at
// nl = 2, 10,720 at nl = 3, 8,928 at nl = 4 (bucket_capacity;
// ops/kmer_sort.py:BUCKET_CAPACITY holds the same).
//
// lex_order (the level-0 build's 4 M fingerprints; devhash.finalize,
// sortops.sort_by_limbs).  As a function it reads the rows once and
// writes an int64 permutation.  A sort keeps every row, so the buckets
// must be small where sort_count's hold thousands of rows:
//   1. load_hist_kernel with the row index as payload (the live digits;
//      one host sync);
//   2. the host plans (ops/kmer_sort.py:lex_plan): the partition digits
//      are the most significant live digits, as many as bring the mean
//      bucket to 128 rows or fewer (two at the build: 65,536 buckets of
//      61 rows), none at n <= 128;
//   3. the LSD pass kernels on those digits, carrying the index (stable:
//      a bucket's rows stay in index order), bounds_kernel;
//   4. lex_warp_kernel, a warp a bucket: up to LEX_WARP (256) rows into
//      the warp's shared memory, each placed by counting the rows before
//      it (a smaller key, or an equal key and a smaller position), its
//      index written to the permutation at the bucket's first row plus
//      its place.  With at most seven live digits below the partition
//      (nl <= 2) a row's key is one 64-bit word, those digits and its
//      position (packed_key): one compare a pair, where the limb-wise
//      compare of nl limbs is bound by its instructions (61 rows: 3,721
//      pairs a bucket);
//   5. a larger bucket (skew, few-valued rows) is listed by the warp:
//      lex_block_kernel takes those up to the block's capacity (rows in
//      shared memory: up to RANK_SORT placed by counting, more by the
//      stable in-block LSD passes over 16-bit positions, block_lsd_pass);
//      the host (one sync) sends each over capacity through the LSD route
//      with the index as payload, on its own segment.
// No compaction: a sort keeps n rows, so a bucket's first row is its
// place.  Capacity: a row takes its nl limbs and two uint16 list entries,
// (4 nl + 4) bytes: 16,384 rows at nl = 1, 2, 13,408 at nl = 3, 10,720 at
// nl = 4 (lex_capacity; ops/kmer_sort.py:LEX_CAPACITY).  What bounds it
// now: the two partition passes (12 bytes a row in and out, each) and
// the warp kernel's counting.
//
// merge_runs (the count's flush windows: a running table and a window's
// table, both ascending).  As a function it reads both inputs once and
// writes the runs once; sorting their concatenation again moved 11-12
// LSD passes of data.  A merge path instead:
//   1. merge_split_kernel: a tile of 2,048 merged rows (MTILE) starts at
//      a diagonal of the (a, b) grid; a warp a tile border finds how many
//      of a's rows lie before it (a 32-way search on the limbs, compared
//      as unsigned; equal rows take a's first);
//   2. merge_kernel, count pass: a block a tile loads its two slices into
//      shared memory, a thread merges 8 rows (its own split by a binary
//      search in the tile), marks the rows that differ from the merged row
//      before them (the tile's first against the larger of a's and b's
//      rows before the tile) and sums the counts; the tile's runs and
//      count sum go out, and the order check: a row below the one before
//      it in its own input (within a slice or at its border), or a tile
//      whose slices would be negative, flags the inputs out of order; a
//      high int64 word flags bad limbs;
//   3. one block scans the tiles' runs and sums (scan_ll_kernel); the host
//      reads the runs and the flags (one sync);
//   4. merge_kernel, write pass (inputs in order): the tile merged again,
//      each run's key (int64 limbs) and the counts' exclusive prefix at
//      its place, staged in shared memory and written as contiguous
//      ranges; run_counts_kernel takes a run's count as the difference of
//      neighbouring prefixes, so a run may span any number of tiles (a
//      count pass and a write pass, each re-merging, rather than a
//      decoupled look-back whose status would carry the open run's sum:
//      the order check then ends before anything is written, an input out
//      of order costs one pass, and the run pass's prefix scheme is
//      reused; each input is read twice).
// Inputs out of order (raw rows) take the LSD route below; the wrapper
// records which.
//
// LSD sort (merge_runs' inputs out of order, sort_count's segment of the
// buckets over capacity, a bucket over capacity of lex_order, the
// partition passes).  Keys as nl separate uint32 arrays (SoA) in two
// ping-pong buffers, with an optional 32-bit payload beside them.  The load kernel counts every digit of every pass
// at once (as CUB's onesweep does up front); the host skips a pass whose
// digit takes one value (the load's XOR words).  Digits are the four
// bytes of each limb (ops/kmer_sort.py:digit_plan).  A pass: a tile count
// kernel (256-bucket histogram of a 4,096-key tile, tile-major), a
// two-level scan of the (tile, digit) counts (group sums, one block
// across groups, then each group's tiles), and the scatter: a warp ranks
// its 16 x 32 keys in order with __match_any_sync and per-warp counters,
// the block adds the warps' prefixes, and the tile is reordered by digit
// in shared memory so that each digit's keys go out as one contiguous
// run.  Every step keeps the input order among equal digits, so the sort
// is stable and the permutation is the torch.argsort chain's.  No key
// pads a tile: the tail tile counts its rows.  Eleven-bit digits would
// spread a 4,096-key tile over 2,048 buckets (scattered 4-byte writes).
//
// Runs.  A tile pass marks run starts (a row differs from the one before)
// and sums the payload (1 a row without one), one block scans the tiles'
// counts and sums, and a write pass puts each run's key (int64 limbs, the
// callers' format) and the payload's exclusive prefix at its start; a
// last pass takes the count as the difference of neighbouring prefixes.
//
// Offsets: element indices are 64-bit where they address an array (a
// window of 2^28 rows of 4 limbs is 4 GiB); the wrapper refuses n >=
// 2^31, so per-digit offsets fit 32 bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;                 // 8-bit digits; THREADS == RADIX
constexpr int ITEMS = 16;                  // keys a thread in a tile
constexpr int TILE = THREADS * ITEMS;      // 4,096 keys
constexpr int MAX_NL = 4;                  // k1 <= 64
constexpr int MAX_PASSES = 16;             // 128 bits at 8 a pass
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 232448;        // 227 KB, a block's opt-in limit
constexpr unsigned FULL = 0xFFFFFFFFu;

static_assert(THREADS == RADIX, "a thread a digit in the scans");

struct Plan {
    int n;
    int limb[MAX_PASSES];
    int shift[MAX_PASSES];
    int bits[MAX_PASSES];
};

__device__ __forceinline__ unsigned lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

// Exclusive prefix of v over the block (NW warps, all of whose threads
// call it); *total gets the block's sum.  sh holds NW values.
template <typename T, int NW = WARPS>
__device__ T block_exclusive_scan(T v, T* total, T* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T x = warp_inclusive_scan<T>(v);
    if (lane == 31) sh[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T s = lane < NW ? sh[lane] : T(0);
        s = warp_inclusive_scan<T>(s);
        if (lane < NW) sh[lane] = s;
    }
    __syncthreads();
    const T before = warp ? sh[warp - 1] : T(0);
    *total = sh[NW - 1];
    __syncthreads();                      // sh is reused by the next call
    return before + x - v;
}

// ---------------------------------------------------------------------------
// One block an array: out = the exclusive scan of in (gridDim.x arrays of
// len int64 each, array b at in + b * len and out + b * len; in may be
// out), total[b] = array b's sum.  len_dev, when not null, holds len.
// ---------------------------------------------------------------------------
constexpr int SCAN_PER = 8;

__global__ void __launch_bounds__(THREADS)
scan_ll_kernel(const long long* in, long long* out, long long len,
               const long long* __restrict__ len_dev, long long* total) {
    __shared__ long long sh[WARPS];
    if (len_dev) len = *len_dev;
    const long long* x = in + (size_t)blockIdx.x * len;
    long long* y = out + (size_t)blockIdx.x * len;
    long long carry = 0;
    for (long long c0 = 0; c0 < len; c0 += (long long)THREADS * SCAN_PER) {
        const long long first = c0 + (long long)threadIdx.x * SCAN_PER;
        long long v[SCAN_PER], s = 0;
#pragma unroll
        for (int j = 0; j < SCAN_PER; ++j) {
            v[j] = first + j < len ? x[first + j] : 0;
            s += v[j];
        }
        long long tot;
        long long run = carry + block_exclusive_scan<long long>(s, &tot, sh);
#pragma unroll
        for (int j = 0; j < SCAN_PER; ++j) {
            if (first + j < len) y[first + j] = run;
            run += v[j];
        }
        carry += tot;
    }
    if (threadIdx.x == 0) total[blockIdx.x] = carry;
}

// ---------------------------------------------------------------------------
// Extraction
// ---------------------------------------------------------------------------

constexpr int EX_WINDOWS = 4096;           // windows a block aims at
constexpr size_t EX_SMEM = 100 * 1024;     // a block's share: two an SM
constexpr size_t EX_STATIC = 256;          // the kernel's static shared bytes
constexpr unsigned long long ST_AGG = 1, ST_PREFIX = 2;   // status flags

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

// A read's 32-bit invalid-base words (bit i of word w: base 32 w + i is a
// code >= 4) and its packed words, forward and reverse complement each:
// word j + 1 holds bases 16 j .. 16 j + 15, j = -1 .. 2 MW - 1.
__host__ __device__ __forceinline__ int mask_words(int L) { return L / 32 + 2; }
__host__ __device__ __forceinline__ int packed_words(int L) {
    return 2 * mask_words(L) + 1;
}
// bytes of a block's reads in shared memory: whole 16-byte chunks from the
// aligned address at or below the first byte
__host__ __device__ __forceinline__ long long raw_bytes(long long R, int L) {
    return ((R * L + 31) / 16 + 1) * 16;
}

// Window p of the block's read r: p + k1 within the read's length and no
// invalid base in [p, p + k1).
__device__ __forceinline__ bool window_ok(int r, int p, int k1, int MW,
                                          const int* lens,
                                          const uint32_t* bad) {
    if (p + k1 > lens[r]) return false;
    const uint32_t* bw = bad + r * MW;
    for (int off = 0; off < k1; off += 32) {
        const int q = p + off;
        const uint32_t bits =
            __funnelshift_r(bw[q >> 5], bw[(q >> 5) + 1], q & 31);
        const int nb = min(32, k1 - off);
        if (bits & (nb == 32 ? ~0u : (1u << nb) - 1u)) return false;
    }
    return true;
}

// A block a ticket (taken in launch order, so a block's predecessors have
// all started): reads [t R, t R + R).  status: (gridDim.x,) 64-bit words,
// zeroed; ticket: one zeroed word.  total gets the number of rows.
// Rounds of 32 windows a warp takes, at most, of a block of R reads.
__host__ __device__ __forceinline__ int ex_rounds(int R, int P) {
    return (R * P + WARPS * 32 - 1) / (WARPS * 32);
}

template <int NL>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const uint8_t* __restrict__ bases,     // (B, L)
               const int* __restrict__ lengths,       // (B,)
               long long B, int L, int k1, int R, int SR,
               unsigned long long* status, unsigned* ticket,
               long long* total, uint32_t* __restrict__ out) {   // (n, NL)
    extern __shared__ __align__(16) uint8_t ex_smem[];
    __shared__ int wsum[WARPS];
    __shared__ long long s_off;
    __shared__ unsigned s_ticket;
    const int P = L - k1 + 1, MW = mask_words(L), PW = packed_words(L);
    uint8_t* raw = ex_smem;
    int* lens = reinterpret_cast<int*>(ex_smem + raw_bytes(R, L));
    uint32_t* bad = reinterpret_cast<uint32_t*>(lens + R);   // (R, MW)
    uint32_t* fw = bad + R * MW;                              // (R, PW)
    uint32_t* rcw = fw + R * PW;                              // (R, PW)
    uint32_t* ballots = rcw + R * PW;            // (WARPS, ex_rounds(R, P))
    uint32_t* stage = ballots + WARPS * ex_rounds(R, P);      // (SR, NL)
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long t = s_ticket;
    const long long b0 = t * R;
    const int nr = (int)min((long long)R, B - b0);

    // the block's nr * L bytes, 16-byte chunks where whole, else bytes
    const uint8_t* first = bases + b0 * L;
    const int lead = (int)(reinterpret_cast<uintptr_t>(first) & 15);
    const long long end = lead + (long long)nr * L;      // from the chunk base
    for (long long c = tid; c < (end + 15) / 16; c += THREADS) {
        const long long lo = 16 * c;
        if (lo >= lead && lo + 16 <= end) {
            *reinterpret_cast<uint4*>(raw + lo) =
                __ldg(reinterpret_cast<const uint4*>(first + (lo - lead)));
        } else {
            for (int j = 0; j < 16; ++j)
                if (lo + j >= lead && lo + j < end)
                    raw[lo + j] = first[lo + j - lead];
        }
    }
    for (int r = tid; r < nr; r += THREADS) lens[r] = lengths[b0 + r];
    __syncthreads();

    // pack each read once: base q of read r is rb[r * L + q]
    const uint8_t* rb = raw + lead;
    for (int i = tid; i < nr * PW; i += THREADS) {
        const int r = i / PW, j = i - r * PW - 1;
        uint32_t w = 0, m = 0;
#pragma unroll
        for (int x = 0; x < 16; ++x) {
            const int q = 16 * j + x;
            const uint32_t c = (q >= 0 && q < L) ? rb[r * L + q] : 0u;
            w |= (c < 4 ? c : 0u) << (30 - 2 * x);
            m |= (uint32_t)(c >= 4) << x;
        }
        fw[i] = w;
        rcw[i] = rev2(~w);
        if (j >= 0) reinterpret_cast<uint16_t*>(bad + r * MW)[j] = (uint16_t)m;
    }
    __syncthreads();

    // a warp a contiguous run of the block's windows, 32 at a time (the
    // lane's window w = r P + p advanced by 32 a round); each round's
    // ballot of valid windows kept for the row pass
    const int nw = nr * P;
    const int per_warp = (nw + WARPS * 32 - 1) / (WARPS * 32) * 32;
    const int w0 = warp * per_warp, w1 = min(nw, w0 + per_warp);
    uint32_t* wb = ballots + warp * ex_rounds(R, P);
    const int r_start = (w0 + lane) / P, p_start = w0 + lane - r_start * P;
    int cnt = 0;
    for (int base = w0, k = 0, r = r_start, p = p_start; base < w1;
         base += 32, ++k) {
        const bool ok = base + lane < w1 && window_ok(r, p, k1, MW, lens, bad);
        const unsigned b = __ballot_sync(FULL, ok);
        if (lane == 0) wb[k] = b;
        cnt += __popc(b);
        for (p += 32; p >= P; p -= P) ++r;
    }
    if (lane == 0) wsum[warp] = cnt;
    __syncthreads();
    int wbase = 0, agg = 0;
    for (int k = 0; k < WARPS; ++k) {
        wbase += k < warp ? wsum[k] : 0;
        agg += wsum[k];
    }

    // decoupled look-back: the rows of the blocks with smaller tickets
    if (warp == 0) {
        long long excl = 0;
        if (t == 0) {
            if (lane == 0)
                st_release(&status[0],
                           ((unsigned long long)agg << 2) | ST_PREFIX);
        } else {
            if (lane == 0)
                st_release(&status[t], ((unsigned long long)agg << 2) | ST_AGG);
            for (long long k = t - 1;; k -= 32) {
                const long long idx = k - lane;        // lane 0 the nearest
                unsigned long long s = idx >= 0 ? ld_acquire(&status[idx])
                                                : ST_PREFIX;
                while (__any_sync(FULL, (s & 3) == 0))
                    if ((s & 3) == 0) s = ld_acquire(&status[idx]);
                const unsigned pre = __ballot_sync(FULL, (s & 3) == ST_PREFIX);
                const int stop = pre ? __ffs(pre) - 1 : 31;
                long long v = lane <= stop ? (long long)(s >> 2) : 0;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
                excl += v;
                if (pre) break;
            }
            if (lane == 0)
                st_release(&status[t], ((unsigned long long)(excl + agg) << 2) |
                                           ST_PREFIX);
        }
        if (lane == 0) {
            s_off = excl;
            if (t == gridDim.x - 1) *total = excl + agg;
        }
    }
    __syncthreads();
    const long long off = s_off;

    // the rows, staged SR at a time (one round unless the reads are long)
    const int used = 2 * k1 - 32 * (NL - 1);        // bits of the last limb
    const uint32_t last = used == 32 ? ~0u : ~0u << (32 - used);
    const unsigned lt = lanemask_lt();
    for (int c0 = 0; c0 < agg; c0 += SR) {
        const int c1 = min(agg, c0 + SR);
        int rank = wbase;
        for (int base = w0, k = 0, r = r_start, p = p_start; base < w1;
             base += 32, ++k, p += 32) {
            for (; p >= P; p -= P) ++r;
            const unsigned b = wb[k];
            const int my = rank + __popc(b & lt);
            rank += __popc(b);
            if (!((b >> lane) & 1u) || my < c0 || my >= c1) continue;
            const uint32_t* f = fw + r * PW;
            const uint32_t* rc = rcw + r * PW;
            uint32_t fl[NL], rl[NL];
#pragma unroll
            for (int l = 0; l < NL; ++l) {
                const int qf = p + 16 * l + 16;         // q + 16, q = p + 16 l
                fl[l] = __funnelshift_l(f[(qf >> 4) + 1], f[qf >> 4],
                                        2 * (qf & 15));
                const int qr = p + k1 - 16 * l;         // q + 16, q = p + k1 - 16 - 16 l
                rl[l] = __funnelshift_r(rc[qr >> 4], rc[(qr >> 4) + 1],
                                        2 * (qr & 15));
            }
            fl[NL - 1] &= last;
            rl[NL - 1] &= last;
            bool lt_ = false, eq = true;      // ops/limbs.py:lex_lt(rc, fw)
#pragma unroll
            for (int l = 0; l < NL; ++l) {
                lt_ = lt_ || (eq && rl[l] < fl[l]);
                eq = eq && rl[l] == fl[l];
            }
            uint32_t* dst = stage + (size_t)(my - c0) * NL;
#pragma unroll
            for (int l = 0; l < NL; ++l) dst[l] = lt_ ? rl[l] : fl[l];
        }
        __syncthreads();
        // words [(off + c0) NL, (off + c1) NL) of out: 4-byte words up to a
        // 16-byte boundary, 16-byte stores, 4-byte words after
        const long long g0 = (off + c0) * NL;
        const int words = (c1 - c0) * NL;
        const int head = min(words, (int)((4 - (g0 & 3)) & 3));
        const int quads = (words - head) / 4;
        for (int i = tid; i < head; i += THREADS) out[g0 + i] = stage[i];
        uint4* o4 = reinterpret_cast<uint4*>(out + g0 + head);
        for (int i = tid; i < quads; i += THREADS) {
            const uint32_t* s = stage + head + 4 * i;
            o4[i] = make_uint4(s[0], s[1], s[2], s[3]);
        }
        for (int i = head + 4 * quads + tid; i < words; i += THREADS)
            out[g0 + i] = stage[i];
        __syncthreads();
    }
}

// A block's reads R and staging rows SR for reads of width L, and its
// dynamic shared bytes; false when one read does not fit.
bool ex_plan(int L, int k1, int nl, int* R_out, int* SR_out, size_t* smem) {
    const long long P = L - k1 + 1, MW = mask_words(L), PW = packed_words(L);
    auto bytes = [&](long long R, long long SR) {
        return (size_t)(raw_bytes(R, L) +
                        4 * (R + R * MW + 2 * R * PW +
                             WARPS * (long long)ex_rounds((int)R, (int)P) +
                             SR * nl));
    };
    long long R = EX_WINDOWS / P > 1 ? EX_WINDOWS / P : 1;
    while (R > 1 && bytes(R, R * P) > EX_SMEM) R = R * 7 / 8 < R - 1 ? R * 7 / 8 : R - 1;
    long long SR = R * P;
    const size_t room = SMEM_MAX - EX_STATIC;
    if (bytes(R, SR) > room) {
        if (bytes(R, 0) + 4 * 32 * (size_t)nl > room) return false;
        SR = (long long)((room - bytes(R, 0)) / (4 * (size_t)nl));
    }
    *R_out = (int)R;
    *SR_out = (int)SR;
    *smem = bytes(R, SR);
    return true;
}

template <int NL>
struct Extract {
    static int run(const void* bases, const void* lengths, long long B,
                   int L, int k1, void* scratch, void* total, void* out,
                   cudaStream_t st) {
        int R, SR;
        size_t smem;
        if (!ex_plan(L, k1, NL, &R, &SR, &smem))
            return (int)cudaErrorInvalidValue;
        const long long blocks = (B + R - 1) / R;
        if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        if (smem > SMEM_DEFAULT) {
            const cudaError_t e = cudaFuncSetAttribute(
                extract_kernel<NL>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        // status words, then the ticket
        unsigned long long* status = static_cast<unsigned long long*>(scratch);
        const cudaError_t e = cudaMemsetAsync(
            status, 0, (size_t)(blocks + 1) * sizeof(unsigned long long), st);
        if (e != cudaSuccess) return (int)e;
        extract_kernel<NL><<<(unsigned)blocks, THREADS, smem, st>>>(
            static_cast<const uint8_t*>(bases),
            static_cast<const int*>(lengths), B, L, k1, R, SR, status,
            reinterpret_cast<unsigned*>(status + blocks),
            static_cast<long long*>(total), static_cast<uint32_t*>(out));
        return 0;
    }
};

// ---------------------------------------------------------------------------
// Sort: load + histogram of every pass
// ---------------------------------------------------------------------------

// Limb l of row i of the caller's rows: row-major (stride 0), rows [0, na)
// from a, the rest from b, 8-byte limbs (int64 values in [0, 2^32)) when
// wide, their high words OR-ed into *high; or SoA uint32 (stride > 0):
// limb l of row i at a[l * stride + i].
struct Rows {
    const void* a;
    const void* b;
    long long na;
    int wide;
    long long stride;
};

template <int NL>
__device__ __forceinline__ uint32_t row_limb(const Rows& src, long long i,
                                             int l, uint32_t* high) {
    if (src.stride)
        return static_cast<const uint32_t*>(src.a)[l * src.stride + i];
    const void* p = i < src.na ? src.a : src.b;
    const long long r = i < src.na ? i : i - src.na;
    if (!src.wide) return static_cast<const uint32_t*>(p)[r * NL + l];
    const unsigned long long v =
        static_cast<const unsigned long long*>(p)[r * NL + l];
    *high |= (uint32_t)(v >> 32);
    return (uint32_t)v;
}

// pay_mode: 0 none, 1 the caller's int32 values (rows [0, na) from pa, the
// rest from pb), 2 the row index.  hist: the plan's (plan.n, RADIX) digit
// counts; then a flag, 1 when an int64 limb is outside [0, 2^32) (the
// sort would read only its low word); then NL words, the OR over the
// rows of row ^ row 0, limb by limb: a digit takes two values or more
// where its bits there are not all 0.
template <int NL>
__global__ void __launch_bounds__(THREADS)
load_hist_kernel(Rows src, long long n, const int* __restrict__ pa,
                 const int* __restrict__ pb, int pay_mode, Plan plan,
                 uint32_t* __restrict__ keys,          // (NL, n)
                 uint32_t* __restrict__ pay,           // (n,)
                 uint32_t* __restrict__ hist) {
    __shared__ uint32_t h[MAX_PASSES * RADIX];
    __shared__ uint32_t dx_sh[MAX_NL];
    for (int i = threadIdx.x; i < plan.n * RADIX; i += blockDim.x) h[i] = 0;
    if (threadIdx.x < NL) dx_sh[threadIdx.x] = 0;
    uint32_t high = 0, ref[NL], dx[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        ref[l] = row_limb<NL>(src, 0, l, &high);
        dx[l] = 0;
    }
    __syncthreads();
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        uint32_t key[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) {
            key[l] = row_limb<NL>(src, i, l, &high);
            keys[(size_t)l * n + i] = key[l];
            dx[l] |= key[l] ^ ref[l];
        }
        if (pay_mode == 1)
            pay[i] = (uint32_t)(i < src.na ? pa[i] : pb[i - src.na]);
        else if (pay_mode == 2)
            pay[i] = (uint32_t)i;
        for (int p = 0; p < plan.n; ++p) {
            uint32_t v = 0;
#pragma unroll
            for (int l = 0; l < NL; ++l) v = l == plan.limb[p] ? key[l] : v;
            const uint32_t d = (v >> plan.shift[p]) & ((1u << plan.bits[p]) - 1u);
            atomicAdd(&h[p * RADIX + d], 1u);
        }
    }
#pragma unroll
    for (int l = 0; l < NL; ++l)
        if (dx[l]) atomicOr(&dx_sh[l], dx[l]);
    if (__syncthreads_or(high != 0) && threadIdx.x == 0)
        hist[plan.n * RADIX] = 1u;
    if (threadIdx.x < NL && dx_sh[threadIdx.x])
        atomicOr(&hist[plan.n * RADIX + 1 + threadIdx.x], dx_sh[threadIdx.x]);
    for (int i = threadIdx.x; i < plan.n * RADIX; i += blockDim.x)
        if (h[i]) atomicAdd(&hist[i], h[i]);
}

template <int NL>
struct Load {
    static int run(const Rows& src, long long n, const int* pa,
                   const int* pb, int pay_mode, const Plan& plan,
                   uint32_t* keys, uint32_t* pay, uint32_t* hist,
                   cudaStream_t st) {
        long long blocks = (n + THREADS - 1) / THREADS;
        if (blocks > 132 * 4) blocks = 132 * 4;
        load_hist_kernel<NL><<<(unsigned)blocks, THREADS, 0, st>>>(
            src, n, pa, pb, pay_mode, plan, keys, pay, hist);
        return 0;
    }
};

// ---------------------------------------------------------------------------
// Sort: one pass
// ---------------------------------------------------------------------------

long long n_tiles(long long n) { return (n + TILE - 1) / TILE; }

// tiles a group of the (tile, digit) scan: about sqrt(n_tiles), at least 16
long long tiles_per_group(long long ntiles) {
    long long t = 16;
    while (t * t < ntiles) t += 16;
    return t;
}

long long n_groups(long long ntiles) {
    const long long tpg = tiles_per_group(ntiles);
    return (ntiles + tpg - 1) / tpg;
}

// counts[tile][d]: keys of the tile with digit d; gsum[group][d] += it.
__global__ void __launch_bounds__(THREADS)
tile_count_kernel(const uint32_t* __restrict__ limb, long long n, int shift,
                  uint32_t dmask, long long tpg,
                  uint32_t* __restrict__ counts, uint32_t* __restrict__ gsum) {
    __shared__ uint32_t h[RADIX];
    h[threadIdx.x] = 0;
    __syncthreads();
    const long long i0 = (long long)blockIdx.x * TILE;
    const long long i1 = min(n, i0 + TILE);
    for (long long i = i0 + threadIdx.x; i < i1; i += THREADS)
        atomicAdd(&h[(limb[i] >> shift) & dmask], 1u);
    __syncthreads();
    const uint32_t c = h[threadIdx.x];
    counts[(size_t)blockIdx.x * RADIX + threadIdx.x] = c;
    if (c) atomicAdd(&gsum[(blockIdx.x / tpg) * RADIX + threadIdx.x], c);
}

constexpr int SCAN_BATCH = 16;   // independent loads in flight a thread

// One block, a thread a digit: gsum[g][d] becomes the offset of group g's
// first key of digit d: the digit's start (the exclusive scan of the
// pass's histogram, or without one of the groups' sums) plus the keys of
// that digit in groups before g.
__global__ void __launch_bounds__(THREADS)
group_scan_kernel(const uint32_t* __restrict__ hist, uint32_t* gsum,
                  long long groups) {
    __shared__ uint32_t sh[WARPS];
    const int d = threadIdx.x;
    uint32_t total = 0;
    if (hist)
        total = hist[d];
    else
        for (long long g = 0; g < groups; ++g) total += gsum[g * RADIX + d];
    uint32_t tot;
    uint32_t run = block_exclusive_scan<uint32_t>(total, &tot, sh);
    for (long long g0 = 0; g0 < groups; g0 += SCAN_BATCH) {
        uint32_t c[SCAN_BATCH];
#pragma unroll
        for (int j = 0; j < SCAN_BATCH; ++j)
            c[j] = g0 + j < groups ? gsum[(g0 + j) * RADIX + d] : 0u;
#pragma unroll
        for (int j = 0; j < SCAN_BATCH; ++j) {
            if (g0 + j < groups) gsum[(g0 + j) * RADIX + d] = run;
            run += c[j];
        }
    }
}

// A block a group, a thread a digit: counts[t][d] becomes the offset of
// tile t's first key of digit d.
__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(uint32_t* counts, const uint32_t* __restrict__ gsum,
                 long long ntiles, long long tpg) {
    const int d = threadIdx.x;
    uint32_t run = gsum[(size_t)blockIdx.x * RADIX + d];
    const long long t0 = (long long)blockIdx.x * tpg;
    const long long t1 = min(ntiles, t0 + tpg);
    for (long long b = t0; b < t1; b += SCAN_BATCH) {
        uint32_t c[SCAN_BATCH];
#pragma unroll
        for (int j = 0; j < SCAN_BATCH; ++j)
            c[j] = b + j < t1 ? counts[(b + j) * RADIX + d] : 0u;
#pragma unroll
        for (int j = 0; j < SCAN_BATCH; ++j) {
            if (b + j < t1) counts[(b + j) * RADIX + d] = run;
            run += c[j];
        }
    }
}

// A tile of TILE keys: warp w takes keys w * 32 * ITEMS + j * 32 + lane,
// j = 0 .. ITEMS-1, so (warp, j, lane) is the input order.  Ranks, the
// tile reordered by digit in shared memory, then each array written out
// a digit run at a time.
template <bool PAY>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const uint32_t* __restrict__ kin, uint32_t* __restrict__ kout,
               const uint32_t* __restrict__ pin, uint32_t* __restrict__ pout,
               long long n, int nl, int dl, int shift, uint32_t dmask,
               const uint32_t* __restrict__ offsets) {   // (ntiles, RADIX)
    __shared__ uint32_t whist[WARPS][RADIX];
    __shared__ uint32_t tstart[RADIX];
    __shared__ long long gofs[RADIX];
    __shared__ uint32_t xbuf[TILE];
    __shared__ uint8_t xdig[TILE];
    __shared__ uint32_t scan_sh[WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long tile0 = (long long)blockIdx.x * TILE;
    const int cnt = (int)min((long long)TILE, n - tile0);
    for (int i = tid; i < WARPS * RADIX; i += THREADS) (&whist[0][0])[i] = 0;
    const int wbase = warp * 32 * ITEMS;
    const uint32_t* dlimb = kin + (size_t)dl * n + tile0;
    uint32_t dig[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int idx = wbase + j * 32 + lane;
        // RADIX marks a position past the tail: it takes no rank
        dig[j] = idx < cnt ? (dlimb[idx] >> shift) & dmask : (uint32_t)RADIX;
    }
    __syncthreads();
    uint32_t rank[ITEMS];
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const uint32_t d = dig[j];
        const unsigned peers = __match_any_sync(FULL, d);
        const int leader = __ffs(peers) - 1;
        uint32_t old = 0;
        if (lane == leader && d < RADIX) {
            old = whist[warp][d];
            whist[warp][d] = old + __popc(peers);
        }
        __syncwarp();
        rank[j] = __shfl_sync(FULL, old, leader) + __popc(peers & lt);
    }
    __syncthreads();
    {   // a thread a digit: the warps' exclusive prefixes, the tile's starts
        const int d = tid;
        uint32_t s = 0;
        for (int w = 0; w < WARPS; ++w) {
            const uint32_t c = whist[w][d];
            whist[w][d] = s;
            s += c;
        }
        uint32_t tot;
        const uint32_t st = block_exclusive_scan<uint32_t>(s, &tot, scan_sh);
        tstart[d] = st;
        gofs[d] = (long long)offsets[(size_t)blockIdx.x * RADIX + d] -
                  (long long)st;
    }
    __syncthreads();
    int pos[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const uint32_t d = dig[j];
        pos[j] = d < RADIX ? (int)(tstart[d] + whist[warp][d] + rank[j]) : -1;
        if (pos[j] >= 0) xdig[pos[j]] = (uint8_t)d;
    }
    const int narr = nl + (PAY ? 1 : 0);
    for (int a = 0; a < narr; ++a) {
        const uint32_t* src = (a < nl ? kin + (size_t)a * n : pin) + tile0;
        uint32_t* dst = a < nl ? kout + (size_t)a * n : pout;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
            if (pos[j] >= 0) xbuf[pos[j]] = src[wbase + j * 32 + lane];
        __syncthreads();
        for (int i = tid; i < cnt; i += THREADS)
            dst[gofs[xdig[i]] + i] = xbuf[i];
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// Sort-and-count: bucket bounds, the bucket kernel, compaction
// ---------------------------------------------------------------------------

constexpr int BT = 512;                    // threads of the bucket kernel
constexpr int BWARPS = BT / 32;
constexpr int BJ = 32;                     // rows a thread, at most
constexpr int BUCKET_MAX = BT * BJ;        // 16,384: uint16 row indices
constexpr size_t BUCKET_FIXED = (BWARPS * RADIX + RADIX + 64) * 4;
constexpr uint16_t EMPTY16 = 0xFFFFu;
static_assert(BT == 2 * RADIX, "two threads a digit in the bucket scan");

// Rows a block of the bucket kernel holds (a multiple of 32): a row takes
// its nl limbs, its count, its place in the list and two hash slots.
int bucket_capacity(int nl) {
    long long c = (long long)(SMEM_MAX - BUCKET_FIXED) / (4 * nl + 8);
    c = c / 32 * 32;
    return (int)(c < BUCKET_MAX ? c : BUCKET_MAX);
}

size_t bucket_smem(int nl, int cap) {
    return BUCKET_FIXED + (size_t)cap * (4 * nl + 8);
}

// The prefix of row i: its d partition digits, the most significant first.
struct Prefix {
    int d;
    int limb[2];
    int shift[2];
};

__device__ __forceinline__ long long prefix_of(const uint32_t* keys,
                                               long long n, const Prefix& pf,
                                               long long i) {
    long long v = 0;
    for (int j = 0; j < pf.d; ++j)
        v = (v << 8) | ((keys[(size_t)pf.limb[j] * n + i] >> pf.shift[j]) & 0xFFu);
    return v;
}

// Rows grouped by prefix, ascending: starts[q] = the first row whose
// prefix is >= q, for q = 0 .. 256^d (starts[256^d] = n).  A thread a
// bucket, by binary search.
__global__ void __launch_bounds__(THREADS)
bounds_kernel(const uint32_t* __restrict__ keys, long long n, Prefix pf,
              int* __restrict__ starts) {
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q > (1LL << (8 * pf.d))) return;
    long long lo = 0, hi = n;
    while (lo < hi) {
        const long long mid = (lo + hi) / 2;
        if (prefix_of(keys, n, pf, mid) < q)
            lo = mid + 1;
        else
            hi = mid;
    }
    starts[q] = (int)lo;
}

template <int NL>
__device__ __forceinline__ uint32_t row_hash(const uint32_t* ks, int cap,
                                             int i) {
    uint32_t h = 0x9E3779B9u;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        h = (h ^ ks[(size_t)l * cap + i]) * 0x85EBCA6Bu;
        h ^= h >> 15;
    }
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

template <int NL>
__device__ __forceinline__ bool same_row(const uint32_t* ks, int cap, int a,
                                         int b) {
    bool eq = true;
#pragma unroll
    for (int l = 0; l < NL; ++l)
        eq = eq && ks[(size_t)l * cap + a] == ks[(size_t)l * cap + b];
    return eq;
}

constexpr int RANK_SORT = BT;              // distinct rows ranked by counting

// Row a precedes row b (limb 0 first).
template <int NL>
__device__ __forceinline__ bool row_less(const uint32_t* ks, int cap, int a,
                                         const uint32_t* kb) {
    bool lt = false, eq = true;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        const uint32_t v = ks[(size_t)l * cap + a];
        lt = lt || (eq && v < kb[l]);
        eq = eq && v == kb[l];
    }
    return lt;
}

// One stable LSD pass of a block of BT threads over u <= BUCKET_MAX
// entries of the list lin (16-bit row indices into rows in shared memory,
// whose digit's limb is dl): lout gets them ordered by the digit (dl[i] >>
// shift) & dmask, equal digits in list order.  As scatter_kernel ranks a
// tile: warp w takes entries [w 32 J, (w + 1) 32 J), J = ceil(u / BT) a
// thread, their digits first (independent loads), then their ranks (a
// chain through the warp's counters).  whist (BWARPS, RADIX), tstart
// (RADIX,) and sh (BWARPS,) are shared scratch.  Every thread calls it.
__device__ void block_lsd_pass(const uint32_t* dl, int shift, uint32_t dmask,
                               const uint16_t* lin, uint16_t* lout, int u,
                               uint32_t* whist, uint32_t* tstart,
                               uint32_t* sh) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = lanemask_lt();
    const int J = (u + BT - 1) / BT;           // list entries a thread, <= BJ
    const int wbase = warp * 32 * J;           // warp w: [wbase, wbase + 32 J)
    for (int i = tid; i < BWARPS * RADIX / 4; i += BT)
        reinterpret_cast<uint4*>(whist)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // digit | rank << 9 of each of the thread's entries
    uint32_t dr[BJ];
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
        if (j >= J) break;
        const int pos = wbase + j * 32 + lane;
        dr[j] = pos < u ? (dl[lin[pos]] >> shift) & dmask : (uint32_t)RADIX;
    }
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
        if (j >= J) break;
        const uint32_t d = dr[j];
        const unsigned peers = __match_any_sync(FULL, d);
        const int leader = __ffs(peers) - 1;
        uint32_t old = 0;
        if (lane == leader && d < RADIX) {
            old = whist[warp * RADIX + d];
            whist[warp * RADIX + d] = old + __popc(peers);
        }
        __syncwarp();
        const uint32_t rank = __shfl_sync(FULL, old, leader) +
                              __popc(peers & lt);
        dr[j] = d | (rank << 9);
    }
    __syncthreads();
    {   // digit d's warp prefixes: thread d takes warps 0-7, thread d + 256
        // warps 8-15; then the digits' starts, added in
        const int d = tid & (RADIX - 1), h = tid / RADIX;
        uint32_t c[BWARPS / 2], s = 0;
#pragma unroll
        for (int k = 0; k < BWARPS / 2; ++k)
            c[k] = whist[(h * BWARPS / 2 + k) * RADIX + d];
#pragma unroll
        for (int k = 0; k < BWARPS / 2; ++k) {
            whist[(h * BWARPS / 2 + k) * RADIX + d] = s;
            s += c[k];
        }
        if (!h) tstart[d] = s;              // the first half's sum
        __syncthreads();
        const uint32_t first = h ? tstart[d] : 0u;
        uint32_t tot;
        const uint32_t st = block_exclusive_scan<uint32_t, BWARPS>(
            h ? first + s : 0u, &tot, sh);
        if (h) tstart[d] = st;
        __syncthreads();
        const uint32_t add = tstart[d] + (h ? first : 0u);
#pragma unroll
        for (int k = 0; k < BWARPS / 2; ++k)
            whist[(h * BWARPS / 2 + k) * RADIX + d] += add;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
        if (j >= J) break;
        const uint32_t d = dr[j] & 511u;
        if (d < RADIX)
            lout[whist[warp * RADIX + d] + (dr[j] >> 9)] =
                lin[wbase + j * 32 + lane];
    }
    __syncthreads();
}

// Persistent blocks, a group at a time (g, g + gridDim.x, ...): rows
// [gstart[g], gstart[g + 1]) of keys (NL, n) into shared memory (the next
// group's rows prefetched into L2 meanwhile); equal rows counted once by
// a hash table of row indices (2 m slots, linear probing), the distinct
// rows listed; the list sorted by plan's digits (least significant
// first), a stable LSD pass a digit over 16-bit indices; each distinct
// row, ascending, a run: its key at the group's first row of run_keys
// (NL, n) and its count in run_counts (n,), their number in gruns[g].
// Up to RANK_SORT distinct rows (the count's groups: about 100, each row
// about 50 times) are placed by counting, a thread a row: at that size
// the passes' barriers cost more than their work.
// local_last: the last digit is the group's low prefix digit, ascending
// over its rows, so the pass is skipped when the first and last rows
// share it.  A group over cap rows is left as it is, gruns 0: the
// batched route (gather_kernel ... place_runs_kernel) finishes it.
template <int NL>
__global__ void __launch_bounds__(BT, 1)
bucket_kernel(const uint32_t* __restrict__ keys, long long n,
              const int* __restrict__ gstart,
              const long long* __restrict__ info, int cap, Plan plan,
              int local_last, uint32_t* __restrict__ run_keys,
              int* __restrict__ run_counts, long long* __restrict__ gruns) {
    const long long G = info[0];
    extern __shared__ __align__(16) uint32_t bsmem[];
    __shared__ int s_u;
    uint32_t* ks = bsmem;                                 // (NL, cap)
    uint32_t* whist = ks + (size_t)NL * cap;              // (BWARPS, RADIX)
    uint32_t* tstart = whist + BWARPS * RADIX;            // (RADIX,)
    uint32_t* sh = tstart + RADIX;                        // 64
    uint16_t* cnt = reinterpret_cast<uint16_t*>(sh + 64); // (cap,) by row
    // the list ping-pong: (cap,) and (2 cap,), the second the hash table
    // while equal rows are counted
    uint16_t* lst[2] = {cnt + cap, cnt + 2 * cap};
    uint16_t* table = lst[1];
    const int tid = threadIdx.x, lane = tid & 31;
    const unsigned lt = lanemask_lt();
    for (long long g = blockIdx.x; g < G; g += gridDim.x) {
        const long long r0 = gstart[g];
        const int m = (int)(gstart[g + 1] - r0);
        if (g + gridDim.x < G) {
            const long long q0 = gstart[g + gridDim.x];
            const long long mq = gstart[g + gridDim.x + 1] - q0;
            if (mq <= cap)
                for (int l = 0; l < NL; ++l)
                    for (long long i = 32LL * tid; i < mq; i += 32LL * BT)
                        asm volatile("prefetch.global.L2 [%0];" ::"l"(
                            keys + (size_t)l * n + q0 + i));
        }
        if (m > cap || m == 0) {
            if (tid == 0) gruns[g] = 0;
            continue;
        }
        for (int l = 0; l < NL; ++l) {
#pragma unroll 8
            for (int i = tid; i < m; i += BT)
                ks[(size_t)l * cap + i] = keys[(size_t)l * n + r0 + i];
        }
        for (int i = tid; i < m; i += BT)
            reinterpret_cast<uint32_t*>(table)[i] = 0xFFFFFFFFu;   // 2 m slots
        for (int i = tid; i < (m + 1) / 2; i += BT)
            reinterpret_cast<uint32_t*>(cnt)[i] = 0u;
        if (tid == 0) s_u = 0;
        __syncthreads();
        for (int i0 = 0; i0 < m; i0 += BT) {   // every thread, every round
            const int i = i0 + tid;
            const uint32_t slots = 2u * (uint32_t)m;
            uint32_t slot = i < m ? __umulhi(row_hash<NL>(ks, cap, i), slots)
                                  : 0u;
            int rep = -1;
            for (; i < m;) {
                uint16_t v = reinterpret_cast<volatile uint16_t*>(table)[slot];
                if (v == EMPTY16) {
                    v = atomicCAS(reinterpret_cast<unsigned short*>(table) + slot,
                                  (unsigned short)EMPTY16, (unsigned short)i);
                    if (v == EMPTY16) {
                        rep = i;
                        break;
                    }
                }
                if (same_row<NL>(ks, cap, v, i)) {
                    rep = v;
                    break;
                }
                if (++slot == slots) slot = 0;
            }
            if (rep >= 0)
                atomicAdd(reinterpret_cast<uint32_t*>(cnt) + (rep >> 1),
                          1u << (16 * (rep & 1)));
            // the warp's new distinct rows appended with one atomic
            const unsigned fresh = __ballot_sync(FULL, rep == i);
            int at = 0;
            if (lane == 0 && fresh) at = atomicAdd(&s_u, __popc(fresh));
            at = __shfl_sync(FULL, at, 0);
            if (rep == i) lst[0][at + __popc(fresh & lt)] = (uint16_t)i;
        }
        __syncthreads();
        const int u = s_u;                     // distinct rows
        int in = 0;
        if (u <= RANK_SORT) {
            // few distinct rows: a thread a row, its place the number of
            // rows before it (every thread reads the same row at a time)
            if (tid < u) {
                const int i = lst[0][tid];
                uint32_t ki[NL];
#pragma unroll
                for (int l = 0; l < NL; ++l) ki[l] = ks[(size_t)l * cap + i];
                int before = 0;
#pragma unroll 4
                for (int j = 0; j < u; ++j)
                    before += row_less<NL>(ks, cap, lst[0][j], ki);
                lst[1][before] = (uint16_t)i;
            }
            __syncthreads();
            in = 1;
        }
        for (int p = 0; p < plan.n && u > RANK_SORT; ++p) {
            const uint32_t* dl = ks + (size_t)plan.limb[p] * cap;
            const int shift = plan.shift[p];
            const uint32_t dmask = (1u << plan.bits[p]) - 1u;
            if (local_last && p == plan.n - 1 &&
                ((dl[0] >> shift) & dmask) == ((dl[m - 1] >> shift) & dmask))
                break;                         // one bucket: already in order
            block_lsd_pass(dl, shift, dmask, lst[in], lst[1 - in], u, whist,
                           tstart, sh);
            in = 1 - in;
        }
        const uint16_t* o = lst[in];
        for (int r = tid; r < u; r += BT) {
            const int i = o[r];
#pragma unroll
            for (int l = 0; l < NL; ++l)
                run_keys[(size_t)l * n + r0 + r] = ks[(size_t)l * cap + i];
            run_counts[r0 + r] = cnt[i];
        }
        if (tid == 0) gruns[g] = u;
        __syncthreads();                       // shared memory is reused
    }
}

template <int NL>
struct Bucket {
    static int run(const uint32_t* keys, long long n, const int* gstart,
                   const long long* info, int cap, const Plan& plan,
                   int local_last, uint32_t* run_keys, int* run_counts,
                   long long* gruns, cudaStream_t st) {
        if (cap < 1 || cap > bucket_capacity(NL))
            return (int)cudaErrorInvalidValue;
        const size_t smem = bucket_smem(NL, cap);
        cudaError_t e = cudaFuncSetAttribute(
            bucket_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        int dev, sms, per_sm;
        if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, bucket_kernel<NL>, BT, smem)) != cudaSuccess)
            return (int)e;
        if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        bucket_kernel<NL><<<(unsigned)(sms * per_sm), BT, smem, st>>>(
            keys, n, gstart, info, cap, plan, local_last, run_keys,
            run_counts, gruns);
        return 0;
    }
};

// ---------------------------------------------------------------------------
// lex_order: the buckets of the partitioned rows, every row kept
// ---------------------------------------------------------------------------

constexpr int LEX_WARP = 256;              // rows a warp ranks: a bucket at most
constexpr int LEX_Q = LEX_WARP / 32;       // rows a lane

// Rows a block of lex_block_kernel holds (a multiple of 32): a row takes
// its nl limbs and two 16-bit list entries (its index stays in device
// memory: the permutation reads it once, at the end).
int lex_capacity(int nl) {
    long long c = (long long)(SMEM_MAX - BUCKET_FIXED) / (4 * nl + 4);
    c = c / 32 * 32;
    return (int)(c < BUCKET_MAX ? c : BUCKET_MAX);
}

size_t lex_smem(int nl, int cap) {
    return BUCKET_FIXED + (size_t)cap * (4 * nl + 4);
}

// Bucket b's first row: starts[b], or without a partition one bucket [0, n).
__device__ __forceinline__ long long bucket_first(const int* starts,
                                                  long long b, long long n) {
    return starts ? starts[b] : (b ? n : 0);
}

// A warp's rows wk (NL, LEX_WARP) in shared memory, m of them, lane + 32 q
// the lane's q-th: before[q] = the rows that precede it, those with a
// smaller key and the equal ones of smaller index (every lane reads the
// same row at a time).
template <int NL, int Q>
__device__ __forceinline__ void warp_rank(const uint32_t* wk, int m, int lane,
                                          int* before) {
    uint32_t ki[Q][NL];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int i = min(lane + 32 * q, m - 1);     // past m: unused
#pragma unroll
        for (int l = 0; l < NL; ++l) ki[q][l] = wk[l * LEX_WARP + i];
        before[q] = 0;
    }
    for (int j = 0; j < m; ++j) {
        uint32_t kj[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) kj[l] = wk[l * LEX_WARP + j];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            bool lt = false, eq = true;
#pragma unroll
            for (int l = 0; l < NL; ++l) {
                lt = lt || (eq && kj[l] < ki[q][l]);
                eq = eq && kj[l] == ki[q][l];
            }
            before[q] += lt || (eq && j < lane + 32 * q);
        }
    }
}

// The same with each row's key one 64-bit word wp (its digits below the
// partition, then its position: packed_key), unique: one compare a pair.
template <int Q>
__device__ __forceinline__ void warp_rank_packed(
        const unsigned long long* wp, int m, int lane, int* before) {
    unsigned long long ki[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        ki[q] = wp[min(lane + 32 * q, m - 1)];
        before[q] = 0;
    }
    for (int j = 0; j < m; ++j) {
        const unsigned long long kj = wp[j];
#pragma unroll
        for (int q = 0; q < Q; ++q) before[q] += kj < ki[q];
    }
}

constexpr int LEX_PACKED = 7;      // digits below the partition, at most,
                                   // for packed_key (8 bits a digit, 8 of
                                   // position)

// Row k's digits of plan (least significant first) in 8-bit slots, the
// most significant first, then its position in its bucket (< LEX_WARP):
// a bucket's rows share every other digit, so this orders them as their
// keys do, ties by position (the index order of the stable partition).
template <int NL>
__device__ __forceinline__ unsigned long long packed_key(const uint32_t* k,
                                                         const Plan& plan,
                                                         int pos) {
    unsigned long long v = 0;
    for (int p = plan.n - 1; p >= 0; --p) {
        uint32_t limb = 0;
#pragma unroll
        for (int l = 0; l < NL; ++l) limb = l == plan.limb[p] ? k[l] : limb;
        v = (v << 8) | ((limb >> plan.shift[p]) & ((1u << plan.bits[p]) - 1u));
    }
    return (v << 8) | (unsigned)pos;
}

// A warp a bucket (warp-stride over nb) of keys (NL, n) partitioned by
// their prefix, each bucket's rows in index order (stable passes), pay
// (n,) their indices, plan the live digits below the partition.  A
// bucket of m <= LEX_WARP rows: its rows into the warp's slice of shared
// memory, as packed_key words when plan has at most LEX_PACKED digits
// (warp_rank_packed), else as limbs (warp_rank); each placed by counting:
// out[s + place] = pay[s + i].  A larger bucket is listed as (first row,
// end) in big (<= cap rows: lex_block_kernel's) or over (more: the
// host's LSD route); info[0], info[1] count them, info[2] the non-empty
// buckets ranked here.
template <int NL>
__global__ void __launch_bounds__(THREADS)
lex_warp_kernel(const uint32_t* __restrict__ keys, long long n,
                const uint32_t* __restrict__ pay,
                const int* __restrict__ starts, long long nb, int cap,
                Plan plan, long long* __restrict__ out, long long* info,
                long long* __restrict__ big, long long* __restrict__ over) {
    constexpr int WORDS = (NL > 2 ? NL : 2) * LEX_WARP;
    __shared__ __align__(8) uint32_t wks[WARPS][WORDS];
    __shared__ int s_ranked;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_ranked = 0;
    __syncthreads();
    uint32_t* wk = wks[warp];
    unsigned long long* wp = reinterpret_cast<unsigned long long*>(wk);
    const bool packed = plan.n <= LEX_PACKED;
    int ranked = 0;
    const long long warps = (long long)gridDim.x * WARPS;
    for (long long b = (long long)blockIdx.x * WARPS + warp; b < nb;
         b += warps) {
        const long long s = bucket_first(starts, b, n);
        const int m = (int)(bucket_first(starts, b + 1, n) - s);
        if (m == 0) continue;
        if (m > LEX_WARP) {
            if (lane == 0) {
                const int side = m > cap;
                const unsigned long long j = atomicAdd(
                    reinterpret_cast<unsigned long long*>(info + side), 1ULL);
                long long* list = side ? over : big;
                list[2 * j] = s;
                list[2 * j + 1] = s + m;
            }
            continue;
        }
        ++ranked;
        int before[LEX_Q];
        if (packed) {
            for (int i = lane; i < m; i += 32) {
                uint32_t k[NL];
#pragma unroll
                for (int l = 0; l < NL; ++l) k[l] = keys[(size_t)l * n + s + i];
                wp[i] = packed_key<NL>(k, plan, i);
            }
            __syncwarp();
            switch ((m + 31) >> 5) {
                case 1: warp_rank_packed<1>(wp, m, lane, before); break;
                case 2: warp_rank_packed<2>(wp, m, lane, before); break;
                case 3: warp_rank_packed<3>(wp, m, lane, before); break;
                case 4: warp_rank_packed<4>(wp, m, lane, before); break;
                case 5: warp_rank_packed<5>(wp, m, lane, before); break;
                case 6: warp_rank_packed<6>(wp, m, lane, before); break;
                case 7: warp_rank_packed<7>(wp, m, lane, before); break;
                default: warp_rank_packed<8>(wp, m, lane, before); break;
            }
        } else {
#pragma unroll
        for (int l = 0; l < NL; ++l)
            for (int i = lane; i < m; i += 32)
                wk[l * LEX_WARP + i] = keys[(size_t)l * n + s + i];
        __syncwarp();
        switch ((m + 31) >> 5) {
            case 1: warp_rank<NL, 1>(wk, m, lane, before); break;
            case 2: warp_rank<NL, 2>(wk, m, lane, before); break;
            case 3: warp_rank<NL, 3>(wk, m, lane, before); break;
            case 4: warp_rank<NL, 4>(wk, m, lane, before); break;
            case 5: warp_rank<NL, 5>(wk, m, lane, before); break;
            case 6: warp_rank<NL, 6>(wk, m, lane, before); break;
            case 7: warp_rank<NL, 7>(wk, m, lane, before); break;
            default: warp_rank<NL, 8>(wk, m, lane, before); break;
        }
        }
#pragma unroll
        for (int q = 0; q < LEX_Q; ++q) {
            const int i = lane + 32 * q;
            if (i < m) out[s + before[q]] = (long long)pay[s + i];
        }
        __syncwarp();                          // the slice is reused
    }
    static_assert(LEX_Q == 8, "warp_rank's cases");
    if (lane == 0 && ranked) atomicAdd(&s_ranked, ranked);
    __syncthreads();
    if (threadIdx.x == 0 && s_ranked)
        atomicAdd(reinterpret_cast<unsigned long long*>(info + 2),
                  (unsigned long long)s_ranked);
}

// Row j precedes row i (key ki): a smaller key, or an equal one and j < i.
template <int NL>
__device__ __forceinline__ bool precedes(const uint32_t* ks, int cap, int j,
                                         const uint32_t* ki, int i) {
    bool lt = false, eq = true;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        const uint32_t v = ks[(size_t)l * cap + j];
        lt = lt || (eq && v < ki[l]);
        eq = eq && v == ki[l];
    }
    return lt || (eq && j < i);
}

// The buckets lex_warp_kernel listed in big (info[0] of them, each of
// LEX_WARP < m <= cap rows): persistent blocks, a bucket at a time.  Its
// rows into shared memory, in index order; up to RANK_SORT of them placed
// by counting (a thread a row), more by stable LSD passes over 16-bit
// positions (block_lsd_pass) on plan's digits, the live digits below the
// partition (the bucket's rows share the others); out[s + k] = pay[s + the
// k-th position].
template <int NL>
__global__ void __launch_bounds__(BT, 1)
lex_block_kernel(const uint32_t* __restrict__ keys, long long n,
                 const uint32_t* __restrict__ pay,
                 const long long* __restrict__ info,
                 const long long* __restrict__ big, int cap, Plan plan,
                 long long* __restrict__ out) {
    extern __shared__ __align__(16) uint32_t bsmem[];
    uint32_t* ks = bsmem;                                 // (NL, cap)
    uint32_t* whist = ks + (size_t)NL * cap;              // (BWARPS, RADIX)
    uint32_t* tstart = whist + BWARPS * RADIX;            // (RADIX,)
    uint32_t* sh = tstart + RADIX;                        // 64
    uint16_t* lst[2] = {reinterpret_cast<uint16_t*>(sh + 64),
                        reinterpret_cast<uint16_t*>(sh + 64) + cap};
    const int tid = threadIdx.x;
    const long long nbig = info[0];
    for (long long e = blockIdx.x; e < nbig; e += gridDim.x) {
        const long long s = big[2 * e];
        const int m = (int)(big[2 * e + 1] - s);
        for (int l = 0; l < NL; ++l) {
#pragma unroll 8
            for (int i = tid; i < m; i += BT)
                ks[(size_t)l * cap + i] = keys[(size_t)l * n + s + i];
        }
        for (int i = tid; i < m; i += BT) lst[0][i] = (uint16_t)i;
        __syncthreads();
        int in = 0;
        if (m <= RANK_SORT) {
            if (tid < m) {
                uint32_t ki[NL];
#pragma unroll
                for (int l = 0; l < NL; ++l) ki[l] = ks[(size_t)l * cap + tid];
                int before = 0;
#pragma unroll 4
                for (int j = 0; j < m; ++j)
                    before += precedes<NL>(ks, cap, j, ki, tid);
                lst[1][before] = (uint16_t)tid;
            }
            __syncthreads();
            in = 1;
        } else {
            for (int p = 0; p < plan.n; ++p) {
                block_lsd_pass(ks + (size_t)plan.limb[p] * cap, plan.shift[p],
                               (1u << plan.bits[p]) - 1u, lst[in], lst[1 - in],
                               m, whist, tstart, sh);
                in = 1 - in;
            }
        }
        for (int k = tid; k < m; k += BT)
            out[s + k] = (long long)pay[s + lst[in][k]];
        __syncthreads();                       // shared memory is reused
    }
}

template <int NL>
struct LexBuckets {
    static int run(const uint32_t* keys, long long n, const uint32_t* pay,
                   const int* starts, long long nb, int cap, const Plan& plan,
                   long long* out, long long* info, long long* big,
                   long long* over, cudaStream_t st) {
        if (cap <= LEX_WARP || cap > lex_capacity(NL))
            return (int)cudaErrorInvalidValue;
        cudaError_t e = cudaMemsetAsync(info, 0, 3 * sizeof(long long), st);
        if (e != cudaSuccess) return (int)e;
        long long blocks = (nb + WARPS - 1) / WARPS;
        if (blocks > 132 * 64) blocks = 132 * 64;
        lex_warp_kernel<NL><<<(unsigned)blocks, THREADS, 0, st>>>(
            keys, n, pay, starts, nb, cap, plan, out, info, big, over);
        const size_t smem = lex_smem(NL, cap);
        e = cudaFuncSetAttribute(lex_block_kernel<NL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
        int dev, sms, per_sm;
        if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, lex_block_kernel<NL>, BT, smem)) != cudaSuccess)
            return (int)e;
        if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        lex_block_kernel<NL><<<(unsigned)(sms * per_sm), BT, smem, st>>>(
            keys, n, pay, info, big, cap, plan, out);
        return 0;
    }
};

// ---------------------------------------------------------------------------
// merge_runs: a merge path over two ascending inputs
// ---------------------------------------------------------------------------

constexpr int M_ITEMS = 8;                 // merged rows a thread
constexpr int MTILE = THREADS * M_ITEMS;   // 2,048 merged rows a tile
// flags of a merge: a row below the one before it in its own input (the
// merge path does not apply), an int64 limb outside [0, 2^32)
constexpr unsigned long long MF_DESCENT = 1, MF_WIDE = 2;

// The two inputs: rows (na, NL) at a and (nb, NL) at b, uint32 limbs or
// int64 limbs (wide) whose high words must be 0; their int32 counts.
struct Pair {
    const void* a;
    const void* b;
    const int* ca;
    const int* cb;
    long long na, nb;
    int wide;
};

// Row i of input side (0: a, 1: b) into k, high words OR-ed into *high.
template <int NL>
__device__ __forceinline__ void pair_row(const Pair& P, int side, long long i,
                                         uint32_t* k, uint32_t* high) {
    const void* p = side ? P.b : P.a;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        if (P.wide) {
            const unsigned long long v =
                static_cast<const unsigned long long*>(p)[i * NL + l];
            *high |= (uint32_t)(v >> 32);
            k[l] = (uint32_t)v;
        } else {
            k[l] = static_cast<const uint32_t*>(p)[i * NL + l];
        }
    }
}

// x <= y, limb 0 first, as unsigned.
template <int NL>
__device__ __forceinline__ bool row_le(const uint32_t* x, const uint32_t* y) {
    bool lt = false, eq = true;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        lt = lt || (eq && x[l] < y[l]);
        eq = eq && x[l] == y[l];
    }
    return lt || eq;
}

// Rows i, j of a tile's shared rows mk (NL, MTILE): mk[i] <= mk[j].
template <int NL>
__device__ __forceinline__ bool tile_le(const uint32_t* mk, int i, int j) {
    uint32_t x[NL], y[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        x[l] = mk[l * MTILE + i];
        y[l] = mk[l * MTILE + j];
    }
    return row_le<NL>(x, y);
}

template <int NL>
__device__ __forceinline__ bool tile_eq(const uint32_t* mk, int i,
                                        const uint32_t* y) {
    bool eq = true;
#pragma unroll
    for (int l = 0; l < NL; ++l) eq = eq && mk[l * MTILE + i] == y[l];
    return eq;
}

// splits[t] = the rows of a among the first min(t MTILE, na + nb) merged
// rows, equal rows taking a's first: the first i in [lo, hi) with a[i] >
// b[d - 1 - i] (true below it, false from it on, for inputs in order).  A
// warp a tile border, a 32-way search: each round every lane tests one of
// 32 points of [lo, hi) and the ballot keeps the part where the test
// turns (a binary search's 21 dependent loads at 2 M rows in 5 rounds).
template <int NL>
__global__ void __launch_bounds__(THREADS)
merge_split_kernel(Pair P, long long ntiles, long long* __restrict__ splits) {
    const long long t = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (t > ntiles) return;                   // the whole warp
    const long long d = min((long long)MTILE * t, P.na + P.nb);
    long long lo = max(0LL, d - P.nb), hi = min(d, P.na);
    uint32_t high = 0, x[NL], y[NL];
    while (lo < hi) {
        const long long mid = lo + (hi - lo) * lane / 32;
        pair_row<NL>(P, 0, mid, x, &high);
        pair_row<NL>(P, 1, d - 1 - mid, y, &high);
        const int c = __popc(__ballot_sync(FULL, row_le<NL>(x, y)));
        const long long last = __shfl_sync(FULL, mid, c ? c - 1 : 0);
        const long long first_false = __shfl_sync(FULL, mid, c < 32 ? c : 31);
        if (c == 32) {
            lo = last + 1;
        } else {
            if (c) lo = last + 1;
            hi = first_false;
        }
    }
    if (lane == 0) splits[t] = lo;
}

// A block a tile of MTILE merged rows: a's rows [splits[t], splits[t + 1])
// and b's the rest of the tile's diagonal range, into shared memory; a
// thread merges M_ITEMS consecutive rows (its own split by a binary search
// in the tile) and marks the rows that differ from the merged row before
// them (across the tile's border too: the larger of a's and b's rows
// before the tile).  WRITE false: the tile's runs and count sum into
// tiles (2, ntiles), and the order check: a row below the one before it
// in its own input (within the tile or at its border), or a tile whose
// slices would be negative (the splits of an input out of order), sets
// MF_DESCENT, a high int64 word MF_WIDE.  WRITE true (after the scan of
// tiles, on inputs in order): each run's key at its place in uniq (n_u,
// NL) int64 and the exclusive prefix of the counts before it in S, staged
// in shared memory and written as contiguous ranges.
template <int NL, bool WRITE>
__global__ void __launch_bounds__(THREADS)
merge_kernel(Pair P, long long ntiles, const long long* __restrict__ splits,
             long long* tiles, unsigned long long* flags,
             long long* __restrict__ uniq, long long* __restrict__ S) {
    extern __shared__ __align__(16) uint32_t msm[];
    __shared__ long long scan_sh[WARPS];
    __shared__ uint32_t pv[NL];
    __shared__ int s_prev;
    uint32_t* mk = msm;                                     // (NL, MTILE)
    int* mc = reinterpret_cast<int*>(mk + NL * MTILE);      // (MTILE,)
    long long* hS = reinterpret_cast<long long*>(mc + MTILE);   // WRITE
    uint16_t* hsrc = reinterpret_cast<uint16_t*>(hS + MTILE);   // WRITE
    const int tid = threadIdx.x;
    const long long t = blockIdx.x;
    const long long d0 = t * MTILE, d1 = min(P.na + P.nb, d0 + MTILE);
    const int cnt = (int)(d1 - d0);
    const long long a0 = splits[t], a1 = splits[t + 1];
    const long long b0 = d0 - a0, b1 = d1 - a1;
    if (a1 < a0 || b1 < b0) {                 // an input out of order
        if (tid == 0) atomicOr(flags, MF_DESCENT);
        return;
    }
    const int la = (int)(a1 - a0), lb = (int)(b1 - b0);
    uint32_t high = 0;
#pragma unroll 4
    for (int i = tid; i < cnt; i += THREADS) {
        const int side = i >= la;
        const long long r = side ? b0 + (i - la) : a0 + i;
        uint32_t k[NL];
        pair_row<NL>(P, side, r, k, &high);
#pragma unroll
        for (int l = 0; l < NL; ++l) mk[l * MTILE + i] = k[l];
        mc[i] = side ? P.cb[r] : P.ca[r];
    }
    if (tid == 0) {
        uint32_t x[NL], y[NL];
        int have = 0;
        if (a0 > 0) {
            pair_row<NL>(P, 0, a0 - 1, x, &high);
            have = 1;
        }
        if (b0 > 0) {
            pair_row<NL>(P, 1, b0 - 1, y, &high);
            if (!have || row_le<NL>(x, y))
#pragma unroll
                for (int l = 0; l < NL; ++l) x[l] = y[l];
            have = 1;
        }
#pragma unroll
        for (int l = 0; l < NL; ++l) pv[l] = have ? x[l] : 0u;
        s_prev = have;
    }
    __syncthreads();
    if (!WRITE) {
        bool bad = false;
        for (int i = tid; i < cnt; i += THREADS) {
            const int side = i >= la;
            uint32_t prev[NL], cur[NL];
            if (i > (side ? la : 0)) {
#pragma unroll
                for (int l = 0; l < NL; ++l) prev[l] = mk[l * MTILE + i - 1];
            } else {
                const long long r = side ? b0 : a0;     // the slice's first
                if (r == 0) continue;
                pair_row<NL>(P, side, r - 1, prev, &high);
            }
#pragma unroll
            for (int l = 0; l < NL; ++l) cur[l] = mk[l * MTILE + i];
            bad = bad || !row_le<NL>(prev, cur);
        }
        if (__syncthreads_or(bad) && tid == 0) atomicOr(flags, MF_DESCENT);
        if (__syncthreads_or(high != 0) && tid == 0) atomicOr(flags, MF_WIDE);
    }
    // the thread's rows k0 .. k0 + M_ITEMS - 1 of the tile
    const int k0 = tid * M_ITEMS;
    int src[M_ITEMS];
    unsigned heads = 0;
    int nh = 0;
    long long w = 0;
    if (k0 < cnt) {
        int lo = max(0, k0 - lb), hi = min(k0, la);
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (tile_le<NL>(mk, mid, la + k0 - 1 - mid))
                lo = mid + 1;
            else
                hi = mid;
        }
        int ai = lo, bi = k0 - lo;
        // the merged row before the thread's first: -1 none, -2 pv
        int prev;
        if (k0 == 0)
            prev = s_prev ? -2 : -1;
        else if (ai > 0 && bi > 0)
            prev = tile_le<NL>(mk, ai - 1, la + bi - 1) ? la + bi - 1 : ai - 1;
        else
            prev = ai > 0 ? ai - 1 : la + bi - 1;
#pragma unroll
        for (int j = 0; j < M_ITEMS; ++j) {
            src[j] = 0;
            if (k0 + j >= cnt) continue;
            const bool take_a =
                bi >= lb || (ai < la && tile_le<NL>(mk, ai, la + bi));
            const int p = take_a ? ai++ : la + bi++;
            src[j] = p;
            bool head;
            if (prev == -1) {
                head = true;
            } else if (prev == -2) {
                head = !tile_eq<NL>(mk, p, pv);
            } else {
                uint32_t y[NL];
#pragma unroll
                for (int l = 0; l < NL; ++l) y[l] = mk[l * MTILE + prev];
                head = !tile_eq<NL>(mk, p, y);
            }
            heads |= (unsigned)head << j;
            nh += head;
            w += mc[p];
            prev = p;
        }
    }
    long long tot_h, tot_w;
    const long long eh = block_exclusive_scan<long long>(nh, &tot_h, scan_sh);
    const long long ew = block_exclusive_scan<long long>(w, &tot_w, scan_sh);
    if (!WRITE) {
        if (tid == 0) {
            tiles[t] = tot_h;
            tiles[ntiles + t] = tot_w;
        }
        return;
    }
    long long sw = tiles[ntiles + t] + ew;
    int r = (int)eh;
#pragma unroll
    for (int j = 0; j < M_ITEMS; ++j) {
        if (k0 + j >= cnt) break;
        if ((heads >> j) & 1u) {
            hsrc[r] = (uint16_t)src[j];
            hS[r] = sw;
            ++r;
        }
        sw += mc[src[j]];
    }
    __syncthreads();
    const long long r0 = tiles[t];
    const int nr = (int)tot_h;
    for (int q = tid; q < nr * NL; q += THREADS) {
        const int rr = q / NL, l = q - rr * NL;
        uniq[r0 * NL + q] = (long long)mk[l * MTILE + hsrc[rr]];
    }
    for (int rr = tid; rr < nr; rr += THREADS) S[r0 + rr] = hS[rr];
}

size_t merge_smem(int nl, bool write) {
    return (size_t)MTILE * (4 * nl + 4 + (write ? 8 + 2 : 0));
}

template <int NL, bool WRITE>
int merge_attr() {
    const size_t smem = merge_smem(NL, WRITE);
    if (smem <= SMEM_DEFAULT) return 0;
    return (int)cudaFuncSetAttribute(merge_kernel<NL, WRITE>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
}

// The count step: splits (ntiles + 1,), tiles (2, ntiles) scanned, meta
// (3,) int64: the runs, the counts' total, the flags (zeroed by the
// caller).
template <int NL>
struct MergeCount {
    static int run(const Pair& P, long long ntiles, long long* splits,
                   long long* tiles, long long* meta, cudaStream_t st) {
        const int e = merge_attr<NL, false>();
        if (e) return e;
        merge_split_kernel<NL><<<(unsigned)((ntiles + WARPS) / WARPS),
                                 THREADS, 0, st>>>(P, ntiles, splits);
        merge_kernel<NL, false><<<(unsigned)ntiles, THREADS,
                                  merge_smem(NL, false), st>>>(
            P, ntiles, splits, tiles,
            reinterpret_cast<unsigned long long*>(meta + 2), nullptr, nullptr);
        scan_ll_kernel<<<2, THREADS, 0, st>>>(tiles, tiles, ntiles, nullptr,
                                              meta);
        return 0;
    }
};

// Groups of buckets (ops/kmer_sort.py:bucket_groups on the card): starts
// (nb + 1,) the buckets' first rows (null: one bucket, [0, n)).  With
// T = cap / 2, a bucket over T rows is a group alone; the others group
// while their first rows fall in one T-row window and one 256-bucket
// block.  gstart (G + 1,) gets each group's first row, then n; info
// (int64): [G, the groups over cap rows, (the scan's total), their rows,
// then (g, r0, r1, off) for each group over cap, in group order, off its
// first row in the segment that gathers them (OVER_HEAD, OVER_REC)].
// One block, GT threads, a run of buckets a thread, so block scans give
// each thread's first group, first group over cap and its offset.  A
// group may be empty (the bucket kernel writes 0 runs).
constexpr int GT = 1024;
constexpr int OVER_HEAD = 4, OVER_REC = 4;

__global__ void __launch_bounds__(GT)
groups_kernel(const int* __restrict__ starts, long long nb, long long n,
              int cap, int* __restrict__ gstart, long long* __restrict__ info) {
    __shared__ int sh[GT / 32];
    __shared__ long long shl[GT / 32];
    const long long t = cap / 2 > 1 ? cap / 2 : 1;
    const long long per = (nb + GT - 1) / GT;
    const long long b0 = threadIdx.x * per, b1 = min(nb, b0 + per);
    auto first = [&](long long b) { return bucket_first(starts, b, n); };
    auto cut = [&](long long b) -> bool {
        const long long s0 = first(b), s1 = first(b + 1);
        if (b % RADIX == 0 || s1 - s0 > t) return true;
        const long long sp = first(b - 1);
        return s0 - sp > t || s0 / t != sp / t;
    };
    int mine = 0, mine_over = 0;
    long long mine_rows = 0;
    for (long long b = b0; b < b1; ++b) {
        if (!cut(b)) continue;
        ++mine;
        const long long m = first(b + 1) - first(b);
        if (m > cap) {                   // a bucket alone, over capacity
            ++mine_over;
            mine_rows += m;
        }
    }
    int G, n_over;
    long long rows;
    int k = block_exclusive_scan<int, GT / 32>(mine, &G, sh);
    int j = block_exclusive_scan<int, GT / 32>(mine_over, &n_over, sh);
    long long off =
        block_exclusive_scan<long long, GT / 32>(mine_rows, &rows, shl);
    if (threadIdx.x == 0) {
        info[0] = G;
        info[1] = n_over;
        info[3] = rows;
        gstart[G] = (int)n;
    }
    for (long long b = b0; b < b1; ++b) {
        if (!cut(b)) continue;
        const long long s0 = first(b), s1 = first(b + 1);
        gstart[k] = (int)s0;
        if (s1 - s0 > cap) {
            long long* o = info + OVER_HEAD + (long long)OVER_REC * j++;
            o[0] = k;
            o[1] = s0;
            o[2] = s1;
            o[3] = off;
            off += s1 - s0;
        }
        ++k;
    }
}

// The group over cap whose gathered rows hold segment row i: the last
// one of info's list whose offset is at most i (i >= 0, n_over >= 1).
__device__ __forceinline__ long long over_group(const long long* over,
                                                long long n_over,
                                                long long i) {
    long long lo = 0, hi = n_over - 1;
    while (lo < hi) {
        const long long mid = (lo + hi + 1) / 2;
        if (over[OVER_REC * mid + 3] <= i)
            lo = mid;
        else
            hi = mid - 1;
    }
    return lo;
}

// The batched route, first step: the rows of every group over cap
// (info's list) from keys (NL, n) into seg (NL, m), m = info[3], group
// after group, each at its offset; diff (NL,) gets each limb's OR over
// the segment of the limb XOR the segment's first row's (the live
// digits, as load_hist_kernel's).  A block a tile of TILE segment rows:
// one binary search finds the tile's first group, and a thread's rows,
// ascending, step to the next group where its offset is reached (a
// group holds more than cap rows, so a tile spans one or two).
template <int NL>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const uint32_t* __restrict__ keys, long long n,
              const long long* __restrict__ info,
              uint32_t* __restrict__ seg, uint32_t* __restrict__ diff) {
    __shared__ long long j_sh;
    __shared__ uint32_t dx_sh[MAX_NL];
    const long long* over = info + OVER_HEAD;
    const long long n_over = info[1], m = info[3];
    const long long c0 = (long long)blockIdx.x * TILE;
    const long long c1 = min(m, c0 + TILE);
    if (threadIdx.x == 0) j_sh = over_group(over, n_over, c0);
    if (threadIdx.x < NL) dx_sh[threadIdx.x] = 0;
    __syncthreads();
    uint32_t ref[NL], dx[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        ref[l] = keys[(size_t)l * n + over[1]];
        dx[l] = 0;
    }
    long long j = j_sh;
    for (long long i = c0 + threadIdx.x; i < c1; i += THREADS) {
        while (j + 1 < n_over && over[OVER_REC * (j + 1) + 3] <= i) ++j;
        const long long r =
            over[OVER_REC * j + 1] + (i - over[OVER_REC * j + 3]);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
            const uint32_t v = keys[(size_t)l * n + r];
            seg[(size_t)l * m + i] = v;
            dx[l] |= v ^ ref[l];
        }
    }
#pragma unroll
    for (int l = 0; l < NL; ++l)
        if (dx[l]) atomicOr(&dx_sh[l], dx[l]);
    __syncthreads();
    if (threadIdx.x < NL && dx_sh[threadIdx.x])
        atomicOr(&diff[threadIdx.x], dx_sh[threadIdx.x]);
}

template <int NL>
struct Gather {
    static int run(const uint32_t* keys, long long n, const long long* info,
                   long long m, uint32_t* seg, uint32_t* diff,
                   cudaStream_t st) {
        gather_kernel<NL><<<(unsigned)n_tiles(m), THREADS, 0, st>>>(
            keys, n, info, seg, diff);
        return 0;
    }
};

// The batched route, last step: the runs of the sorted segment (uniq
// (n_u, nl) int64 each run's key, counts (n_u,) int32, S (n_u,) int64
// each run's first row in the segment: the run pass's payload prefix
// without a payload) back to their groups.  A thread a run: its group
// j, the one whose gathered rows hold S[r] (no run crosses a group: the
// groups' prefixes differ, so each group's first row starts a run); its
// rank t among j's runs, r less the first run at or after j's offset
// (a binary search of S); its key to run_keys (nl, n) and its count to
// run_counts (n,) at j's first row r0 plus t, as the bucket kernel
// writes a group's runs; the group's last run writes gruns[g] = t + 1.
__global__ void __launch_bounds__(THREADS)
place_runs_kernel(const long long* __restrict__ uniq,
                  const int* __restrict__ counts,
                  const long long* __restrict__ S, long long n_u, int nl,
                  const long long* __restrict__ info,
                  uint32_t* __restrict__ run_keys, long long n,
                  int* __restrict__ run_counts, long long* __restrict__ gruns) {
    const long long* over = info + OVER_HEAD;
    const long long n_over = info[1], m = info[3];
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < n_u; r += step) {
        const long long s = S[r];
        const long long j = over_group(over, n_over, s);
        const long long* o = over + OVER_REC * j;
        long long a = 0, b = r;
        while (a < b) {
            const long long mid = (a + b) / 2;
            if (S[mid] < o[3])
                a = mid + 1;
            else
                b = mid;
        }
        const long long t = r - a, dst = o[1] + t;
        for (int l = 0; l < nl; ++l)
            run_keys[(size_t)l * n + dst] = (uint32_t)uniq[r * nl + l];
        run_counts[dst] = counts[r];
        const long long end = j + 1 < n_over ? o[OVER_REC + 3] : m;
        if (r + 1 == n_u || S[r + 1] >= end) gruns[o[0]] = t + 1;
    }
}

// A warp a group (warp-stride over info[0] groups): its runs from the
// scratch to uniq (n_u, nl) int64 and counts (n_u,) at its offset (goff;
// info[2] the total).
__global__ void __launch_bounds__(THREADS)
compact_kernel(const uint32_t* __restrict__ run_keys,
               const int* __restrict__ run_counts, long long n, int nl,
               const int* __restrict__ gstart,
               const long long* __restrict__ goff,
               const long long* __restrict__ info,
               long long* __restrict__ uniq, int* __restrict__ counts) {
    const long long G = info[0];
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * WARPS;
    for (long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
         g < G; g += warps) {
        const long long off = goff[g];
        const long long cnt = (g + 1 < G ? goff[g + 1] : info[2]) - off;
        const long long r0 = gstart[g];
        for (long long j = lane; j < cnt; j += 32) {
            for (int l = 0; l < nl; ++l)
                uniq[(off + j) * nl + l] =
                    (long long)run_keys[(size_t)l * n + r0 + j];
            counts[off + j] = run_counts[r0 + j];
        }
    }
}

// ---------------------------------------------------------------------------
// Runs
// ---------------------------------------------------------------------------

// Row i of sorted SoA keys starts a run: i == 0 or it differs from i - 1.
__device__ __forceinline__ bool run_start(const uint32_t* keys, long long n,
                                          int nl, long long i) {
    if (i == 0) return true;
    for (int l = 0; l < nl; ++l)
        if (keys[(size_t)l * n + i] != keys[(size_t)l * n + i - 1])
            return true;
    return false;
}

// tiles: (2, ntiles) int64: a tile's run starts, then its payload sum
// (counts, before the scan; exclusive offsets after it).  WRITE false
// fills them; WRITE true places each run's key and payload prefix.
template <bool WRITE>
__global__ void __launch_bounds__(THREADS)
runs_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ pay,
            long long n, int nl, long long ntiles, long long* tiles,
            long long* __restrict__ uniq,          // (n_u, nl)
            long long* __restrict__ S) {           // (n_u,)
    __shared__ long long wc_sh[WARPS], ws_sh[WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long tile0 = (long long)blockIdx.x * TILE;
    const int cnt = (int)min((long long)TILE, n - tile0);
    const int wbase = warp * 32 * ITEMS;
    bool flag[ITEMS];
    int wv[ITEMS];
    long long wc = 0, ws = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int idx = wbase + j * 32 + lane;
        const bool valid = idx < cnt;
        const long long i = tile0 + idx;
        flag[j] = valid && run_start(keys, n, nl, i);
        wv[j] = valid ? (pay ? pay[i] : 1) : 0;
        wc += __popc(__ballot_sync(FULL, flag[j]));
        long long w = wv[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(FULL, w, o);
        ws += w;
    }
    if (lane == 0) {
        wc_sh[warp] = wc;
        ws_sh[warp] = ws;
    }
    __syncthreads();
    if (!WRITE) {
        if (tid == 0) {
            long long c = 0, s = 0;
            for (int w = 0; w < WARPS; ++w) {
                c += wc_sh[w];
                s += ws_sh[w];
            }
            tiles[blockIdx.x] = c;
            tiles[ntiles + blockIdx.x] = s;
        }
        return;
    }
    long long run_c = tiles[blockIdx.x], run_w = tiles[ntiles + blockIdx.x];
    for (int w = 0; w < warp; ++w) {
        run_c += wc_sh[w];
        run_w += ws_sh[w];
    }
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const unsigned b = __ballot_sync(FULL, flag[j]);
        const long long incl = warp_inclusive_scan<long long>(wv[j]);
        if (flag[j]) {
            const long long r = run_c + __popc(b & lt);
            const long long i = tile0 + wbase + j * 32 + lane;
            S[r] = run_w + incl - wv[j];
            for (int l = 0; l < nl; ++l)
                uniq[r * nl + l] = (long long)keys[(size_t)l * n + i];
        }
        run_c += __popc(b);
        run_w += __shfl_sync(FULL, incl, 31);
    }
}

// counts[r] = S[r + 1] - S[r], S[n_u] being the payload's total.
__global__ void __launch_bounds__(THREADS)
run_counts_kernel(const long long* __restrict__ S,
                  const long long* __restrict__ totals, long long n_u,
                  int* __restrict__ counts) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < n_u; r += step) {
        const long long next = r + 1 < n_u ? S[r + 1] : totals[1];
        counts[r] = (int)(next - S[r]);
    }
}

unsigned grid_of(long long n) {
    long long blocks = (n + THREADS - 1) / THREADS;
    return (unsigned)(blocks > (1LL << 20) ? (1LL << 20) : blocks);
}

// The write step (after the count step and the host's read of meta):
// uniq (n_u, NL) int64, counts (n_u,) int32, S (n_u,) int64 of scratch.
template <int NL>
struct MergeWrite {
    static int run(const Pair& P, long long ntiles, const long long* splits,
                   long long* tiles, const long long* meta, long long n_u,
                   long long* uniq, int* counts, long long* S,
                   cudaStream_t st) {
        const int e = merge_attr<NL, true>();
        if (e) return e;
        merge_kernel<NL, true><<<(unsigned)ntiles, THREADS,
                                 merge_smem(NL, true), st>>>(
            P, ntiles, splits, tiles, nullptr, uniq, S);
        run_counts_kernel<<<grid_of(n_u), THREADS, 0, st>>>(S, meta, n_u,
                                                            counts);
        return 0;
    }
};

// Run Launch<nl>::run(args...) for 1 <= nl <= MAX_NL; the CUDA error of
// the launches (0 when they were accepted).
template <template <int> class Launch, class... Args>
int dispatch(int nl, Args... args) {
    int rc;
    switch (nl) {
        case 1: rc = Launch<1>::run(args...); break;
        case 2: rc = Launch<2>::run(args...); break;
        case 3: rc = Launch<3>::run(args...); break;
        case 4: rc = Launch<4>::run(args...); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return rc ? rc : (int)cudaGetLastError();
}

// plan_host: npass (limb, shift, bits) triples; false when one is out of
// range.
bool read_plan(const int* plan_host, int npass, int nl, Plan* plan) {
    if (npass < 0 || npass > MAX_PASSES) return false;
    plan->n = npass;
    for (int p = 0; p < npass; ++p) {
        plan->limb[p] = plan_host[3 * p];
        plan->shift[p] = plan_host[3 * p + 1];
        plan->bits[p] = plan_host[3 * p + 2];
        if (plan->limb[p] < 0 || plan->limb[p] >= nl || plan->bits[p] < 1 ||
            plan->bits[p] > 8 || plan->shift[p] < 0 ||
            plan->shift[p] + plan->bits[p] > 32)
            return false;
    }
    return true;
}

bool bad_rows(long long n, int nl) {
    return n < 0 || n >= 0x7FFFFFFFLL || nl < 1 || nl > MAX_NL;
}

}  // namespace

// Extraction: bases (B, L) uint8 codes (>= 4 invalid or padding), lengths
// (B,) int32; the canonical k1-mer of every valid window into out (n, nl)
// uint32, nl = ceil(k1 / 16), in (read, window) order.  scratch: B + 1
// int64 (the blocks' status words and the ticket); total (1,) int64 gets
// n.  out holds B * (L - k1 + 1) rows, the most there can be, and is
// 16-byte aligned.
extern "C" int ks_extract_launch(const void* bases, const void* lengths,
                                 long long B, int L, int k1,
                                 void* scratch, void* total, void* out,
                                 void* stream) {
    if (k1 < 1 || k1 > 16 * MAX_NL || B < 0 ||
        (reinterpret_cast<uintptr_t>(out) & 15))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B == 0 || L < k1)
        return (int)cudaMemsetAsync(total, 0, sizeof(long long), st);
    return dispatch<Extract>((k1 + 15) / 16, bases, lengths, B, L, k1,
                             scratch, total, out, st);
}

// Load: the caller's rows (n, nl) into keys (nl, n) uint32: row-major
// (stride 0), int32 (wide 0) or int64 limbs (wide 1), rows [0, na) at ka
// and the rest at kb; or SoA uint32 (stride > 0, limb l of row i at
// ka[l * stride + i]).  The payload (pay_mode 1: pa / pb split as the
// rows; 2: the row index) into pay (n,); hist (npass * 256 + 1 + nl)
// uint32: the digit counts of every pass of the plan (npass (limb, shift,
// bits) triples in host memory; none when npass is 0), then 1 when an
// int64 limb is outside [0, 2^32), else 0, then for each limb the OR over
// the rows of the limb XOR row 0's.
extern "C" int ks_load_launch(const void* ka, const void* kb, long long na,
                              long long n, int nl, int wide,
                              long long stride, const void* pa,
                              const void* pb, int pay_mode,
                              const int* plan_host, int npass, void* keys,
                              void* pay, void* hist, void* stream) {
    Plan plan;
    if (bad_rows(n, nl) || na < 0 || na > n || pay_mode < 0 || pay_mode > 2 ||
        stride < 0 || (stride && (wide || stride < n)) ||
        !read_plan(plan_host, npass, nl, &plan))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = cudaMemsetAsync(
        hist, 0, ((size_t)npass * RADIX + 1 + nl) * sizeof(uint32_t), st);
    if (e != cudaSuccess) return (int)e;
    if (n == 0) return 0;
    Rows src{ka, kb, na, wide, stride};
    return dispatch<Load>(nl, src, n, static_cast<const int*>(pa),
                          static_cast<const int*>(pb), pay_mode, plan,
                          static_cast<uint32_t*>(keys),
                          static_cast<uint32_t*>(pay),
                          static_cast<uint32_t*>(hist), st);
}

// Scratch of the passes, in 32-bit words, for n rows.
extern "C" long long ks_sort_scratch_words(long long n) {
    const long long t = n_tiles(n);
    return (t + n_groups(t)) * RADIX;
}

// The passes of the plan whose run_host flag is set, in plan order (least
// significant digit first), ping-ponging keys0 (nl, n) <-> keys1 and, when
// pay0 is not null, pay0 (n,) <-> pay1.  hist: the load's (npass, 256)
// counts, or null (each pass's digit totals then come from its tile
// counts); scratch: ks_sort_scratch_words(n) words.  After an even number
// of passes the result is in keys0 / pay0, else in keys1 / pay1.
extern "C" int ks_sort_passes_launch(void* keys0, void* keys1, void* pay0,
                                     void* pay1, long long n, int nl,
                                     const int* plan_host,
                                     const int* run_host, int npass,
                                     const void* hist, void* scratch,
                                     void* stream) {
    Plan plan;
    if (bad_rows(n, nl) || !read_plan(plan_host, npass, nl, &plan))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long ntiles = n_tiles(n), tpg = tiles_per_group(ntiles);
    const long long groups = n_groups(ntiles);
    uint32_t* counts = static_cast<uint32_t*>(scratch);
    uint32_t* gsum = counts + ntiles * RADIX;
    uint32_t* k[2] = {static_cast<uint32_t*>(keys0),
                      static_cast<uint32_t*>(keys1)};
    uint32_t* v[2] = {static_cast<uint32_t*>(pay0),
                      static_cast<uint32_t*>(pay1)};
    const uint32_t* h = static_cast<const uint32_t*>(hist);
    int in = 0;
    for (int p = 0; p < npass; ++p) {
        if (!run_host[p]) continue;
        const int dl = plan.limb[p], shift = plan.shift[p];
        const uint32_t dmask = (1u << plan.bits[p]) - 1u;
        cudaError_t e = cudaMemsetAsync(
            gsum, 0, (size_t)groups * RADIX * sizeof(uint32_t), st);
        if (e != cudaSuccess) return (int)e;
        tile_count_kernel<<<(unsigned)ntiles, THREADS, 0, st>>>(
            k[in] + (size_t)dl * n, n, shift, dmask, tpg, counts, gsum);
        group_scan_kernel<<<1, THREADS, 0, st>>>(
            h ? h + (size_t)p * RADIX : nullptr, gsum, groups);
        tile_scan_kernel<<<(unsigned)groups, THREADS, 0, st>>>(
            counts, gsum, ntiles, tpg);
        if (v[0])
            scatter_kernel<true><<<(unsigned)ntiles, THREADS, 0, st>>>(
                k[in], k[1 - in], v[in], v[1 - in], n, nl, dl, shift, dmask,
                counts);
        else
            scatter_kernel<false><<<(unsigned)ntiles, THREADS, 0, st>>>(
                k[in], k[1 - in], nullptr, nullptr, n, nl, dl, shift, dmask,
                counts);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        in = 1 - in;
    }
    return 0;
}

// Rows a block of the bucket kernel holds at nl limbs.
extern "C" int ks_bucket_capacity(int nl) {
    return nl >= 1 && nl <= MAX_NL ? bucket_capacity(nl) : 0;
}

// Bucket bounds of keys (nl, n) grouped by prefix: d (1 or 2) partition
// digits, (limb, shift) pairs in host memory, the most significant first;
// starts (256^d + 1,) int32.
extern "C" int ks_bounds_launch(const void* keys, long long n, int nl,
                                const int* part_host, int d, void* starts,
                                void* stream) {
    if (bad_rows(n, nl) || d < 1 || d > 2) return (int)cudaErrorInvalidValue;
    Prefix pf{d, {0, 0}, {0, 0}};
    for (int j = 0; j < d; ++j) {
        pf.limb[j] = part_host[2 * j];
        pf.shift[j] = part_host[2 * j + 1];
        if (pf.limb[j] < 0 || pf.limb[j] >= nl || pf.shift[j] < 0 ||
            pf.shift[j] > 24)
            return (int)cudaErrorInvalidValue;
    }
    const long long blocks = ((1LL << (8 * d)) + THREADS) / THREADS;
    bounds_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), n, pf, static_cast<int*>(starts));
    return (int)cudaGetLastError();
}

// The groups of the buckets (starts (nb + 1,) int32, or null: one
// bucket of n rows) for a block capacity cap: gstart (nb + 2,) int32,
// info (4 + 4 nb,) int64, as groups_kernel fills them.
extern "C" int ks_groups_launch(const void* starts, long long nb,
                                long long n, int cap, void* gstart,
                                void* info, void* stream) {
    if (nb < 1 || n < 0 || n >= 0x7FFFFFFFLL || cap < 1)
        return (int)cudaErrorInvalidValue;
    groups_kernel<<<1, GT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(starts), nb, n, cap,
        static_cast<int*>(gstart), static_cast<long long*>(info));
    return (int)cudaGetLastError();
}

// The bucket kernel over the groups (gstart (G + 1,) int32 row offsets
// into keys (nl, n), G = info[0]); plan: npass (limb, shift, bits)
// triples, least significant first; cap <= ks_bucket_capacity(nl);
// run_keys (nl, n) uint32, run_counts (n,) int32, gruns (G,) int64 (0 for
// a group over cap rows, which it skips).
extern "C" int ks_bucket_launch(const void* keys, long long n, int nl,
                                const void* gstart, const void* info,
                                int cap, const int* plan_host, int npass,
                                int local_last, void* run_keys,
                                void* run_counts, void* gruns, void* stream) {
    Plan plan;
    if (bad_rows(n, nl) || !read_plan(plan_host, npass, nl, &plan))
        return (int)cudaErrorInvalidValue;
    return dispatch<Bucket>(nl, static_cast<const uint32_t*>(keys), n,
                            static_cast<const int*>(gstart),
                            static_cast<const long long*>(info), cap, plan,
                            local_last, static_cast<uint32_t*>(run_keys),
                            static_cast<int*>(run_counts),
                            static_cast<long long*>(gruns),
                            static_cast<cudaStream_t>(stream));
}

// The batched route for the groups over cap, first step (after the
// bucket kernel; info as ks_groups_launch filled it, with n_over =
// info[1] >= 1 and m = info[3] rows, which the host passes): their rows
// from keys (nl, n) into seg (nl, m) uint32; diff (nl,) uint32 gets
// each limb's OR over the segment of the limb XOR its first row's.
extern "C" int ks_gather_launch(const void* keys, long long n, int nl,
                                const void* info, long long m, void* seg,
                                void* diff, void* stream) {
    if (bad_rows(n, nl) || m < 1 || m > n) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = cudaMemsetAsync(diff, 0, nl * sizeof(uint32_t), st);
    if (e != cudaSuccess) return (int)e;
    return dispatch<Gather>(nl, static_cast<const uint32_t*>(keys), n,
                            static_cast<const long long*>(info), m,
                            static_cast<uint32_t*>(seg),
                            static_cast<uint32_t*>(diff), st);
}

// The batched route, last step (after the run pass over the sorted
// segment, or over keys themselves when there is no partition): uniq
// (n_u, nl) int64, counts (n_u,) int32 and S (n_u,) int64, the run
// pass's outputs and its scratch of run starts, into run_keys (nl, n)
// uint32, run_counts (n,) int32 and gruns (G,) int64 of the bucket
// kernel, for each group info lists.
extern "C" int ks_place_runs_launch(const void* uniq, const void* counts,
                                    const void* S, long long n_u, int nl,
                                    const void* info, void* run_keys,
                                    long long n, void* run_counts,
                                    void* gruns, void* stream) {
    if (bad_rows(n, nl) || n_u < 1 || n_u > n)
        return (int)cudaErrorInvalidValue;
    place_runs_kernel<<<grid_of(n_u), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(uniq), static_cast<const int*>(counts),
        static_cast<const long long*>(S), n_u, nl,
        static_cast<const long long*>(info), static_cast<uint32_t*>(run_keys),
        n, static_cast<int*>(run_counts), static_cast<long long*>(gruns));
    return (int)cudaGetLastError();
}

// Compaction, first step: goff (G,) int64 the exclusive scan of gruns
// (G,) (G = info[0]); info[2] gets the sum (the unique rows).
extern "C" int ks_compact_count_launch(const void* gruns, void* info,
                                       void* goff, void* stream) {
    long long* inf = static_cast<long long*>(info);
    scan_ll_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(gruns), static_cast<long long*>(goff),
        0, inf, inf + 2);
    return (int)cudaGetLastError();
}

// Compaction, second step (after the first): each group's runs to uniq
// (n_u, nl) int64 and counts (n_u,) int32.
extern "C" int ks_compact_write_launch(const void* run_keys,
                                       const void* run_counts, long long n,
                                       int nl, const void* gstart,
                                       const void* goff, const void* info,
                                       void* uniq, void* counts,
                                       void* stream) {
    if (bad_rows(n, nl)) return (int)cudaErrorInvalidValue;
    compact_kernel<<<132 * 8, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(run_keys),
        static_cast<const int*>(run_counts), n, nl,
        static_cast<const int*>(gstart), static_cast<const long long*>(goff),
        static_cast<const long long*>(info), static_cast<long long*>(uniq),
        static_cast<int*>(counts));
    return (int)cudaGetLastError();
}

// Runs, first step: sorted keys (nl, n) uint32 and an optional int32
// payload (null: 1 a row); tiles (2, ceil(n / 4096)) int64 of scratch;
// totals (2,) int64 get the number of runs and the payload's total.
extern "C" int ks_runs_count_launch(const void* keys, const void* pay,
                                    long long n, int nl, void* tiles,
                                    void* totals, void* stream) {
    if (bad_rows(n, nl)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n == 0)
        return (int)cudaMemsetAsync(totals, 0, 2 * sizeof(long long), st);
    const long long ntiles = n_tiles(n);
    runs_kernel<false><<<(unsigned)ntiles, THREADS, 0, st>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int*>(pay), n,
        nl, ntiles, static_cast<long long*>(tiles), nullptr, nullptr);
    long long* t = static_cast<long long*>(tiles);
    scan_ll_kernel<<<2, THREADS, 0, st>>>(t, t, ntiles, nullptr,
                                          static_cast<long long*>(totals));
    return (int)cudaGetLastError();
}

// Runs, second step (after the count step on the same arguments): uniq
// (n_u, nl) int64 each run's key, counts (n_u,) int32 each run's rows (or
// payload sum); S (n_u,) int64 of scratch.
extern "C" int ks_runs_write_launch(const void* keys, const void* pay,
                                    long long n, int nl, void* tiles,
                                    const void* totals, long long n_u,
                                    void* uniq, void* counts, void* S,
                                    void* stream) {
    if (bad_rows(n, nl) || n_u < 0 || n_u > n)
        return (int)cudaErrorInvalidValue;
    if (n == 0 || n_u == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long ntiles = n_tiles(n);
    runs_kernel<true><<<(unsigned)ntiles, THREADS, 0, st>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int*>(pay), n,
        nl, ntiles, static_cast<long long*>(tiles),
        static_cast<long long*>(uniq), static_cast<long long*>(S));
    run_counts_kernel<<<grid_of(n_u), THREADS, 0, st>>>(
        static_cast<const long long*>(S),
        static_cast<const long long*>(totals), n_u,
        static_cast<int*>(counts));
    return (int)cudaGetLastError();
}

// Rows a block of lex_order's bucket kernel holds at nl limbs.
extern "C" int ks_lex_capacity(int nl) {
    return nl >= 1 && nl <= MAX_NL ? lex_capacity(nl) : 0;
}

// lex_order's buckets: keys (nl, n) uint32 grouped by prefix (starts
// (nb + 1,) int32 from ks_bounds_launch, or null: one bucket [0, n)), each
// bucket's rows in index order, pay (n,) uint32 their indices; plan: the
// live digits below the partition, least significant first; cap <=
// ks_lex_capacity(nl).  out (n,) int64 gets the permutation of every
// bucket of at most cap rows; info (3,) int64 the buckets over LEX_WARP
// rows (big), those over cap (over), the buckets ranked by a warp; big and
// over (nb, 2) int64 list (first row, end) of each (over: the caller's).
extern "C" int ks_lex_buckets_launch(const void* keys, long long n, int nl,
                                     const void* pay, const void* starts,
                                     long long nb, int cap,
                                     const int* plan_host, int npass,
                                     void* out, void* info, void* big,
                                     void* over, void* stream) {
    Plan plan;
    if (bad_rows(n, nl) || nb < 1 || !read_plan(plan_host, npass, nl, &plan))
        return (int)cudaErrorInvalidValue;
    return dispatch<LexBuckets>(nl, static_cast<const uint32_t*>(keys), n,
                                static_cast<const uint32_t*>(pay),
                                static_cast<const int*>(starts), nb, cap,
                                plan, static_cast<long long*>(out),
                                static_cast<long long*>(info),
                                static_cast<long long*>(big),
                                static_cast<long long*>(over),
                                static_cast<cudaStream_t>(stream));
}

// Merged rows a tile of the merge path.
extern "C" int ks_merge_tile() { return MTILE; }

// merge_runs' merge path, count step: ka (na, nl), kb (nb, nl) rows (int32
// bit patterns, or int64 limbs when wide), ca / cb their int32 counts;
// splits (ntiles + 1,) and tiles (2, ntiles) int64 of scratch, ntiles =
// ceil((na + nb) / ks_merge_tile()), na + nb >= 1; meta (3,) int64 gets
// the runs, the counts' total and the flags (1: an input row below the
// one before it, the merge path does not apply; 2: an int64 limb outside
// [0, 2^32)).
extern "C" int ks_merge_count_launch(const void* ka, const void* kb,
                                     long long na, long long nb, int nl,
                                     int wide, const void* ca, const void* cb,
                                     void* splits, void* tiles, void* meta,
                                     void* stream) {
    if (na < 0 || nb < 0 || bad_rows(na + nb, nl) || na + nb == 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    long long* m = static_cast<long long*>(meta);
    const cudaError_t e = cudaMemsetAsync(m + 2, 0, sizeof(long long), st);
    if (e != cudaSuccess) return (int)e;
    const Pair P{ka, kb, static_cast<const int*>(ca),
                 static_cast<const int*>(cb), na, nb, wide};
    return dispatch<MergeCount>(nl, P, (na + nb + MTILE - 1) / MTILE,
                                static_cast<long long*>(splits),
                                static_cast<long long*>(tiles), m, st);
}

// merge_runs' merge path, write step (after the count step on the same
// arguments, its flags 0): uniq (n_u, nl) int64, counts (n_u,) int32, S
// (n_u,) int64 of scratch.
extern "C" int ks_merge_write_launch(const void* ka, const void* kb,
                                     long long na, long long nb, int nl,
                                     int wide, const void* ca, const void* cb,
                                     const void* splits, void* tiles,
                                     const void* meta, long long n_u,
                                     void* uniq, void* counts, void* S,
                                     void* stream) {
    if (na < 0 || nb < 0 || bad_rows(na + nb, nl) || na + nb == 0 ||
        n_u < 1 || n_u > na + nb)
        return (int)cudaErrorInvalidValue;
    const Pair P{ka, kb, static_cast<const int*>(ca),
                 static_cast<const int*>(cb), na, nb, wide};
    return dispatch<MergeWrite>(nl, P, (na + nb + MTILE - 1) / MTILE,
                                static_cast<const long long*>(splits),
                                static_cast<long long*>(tiles),
                                static_cast<const long long*>(meta), n_u,
                                static_cast<long long*>(uniq),
                                static_cast<int*>(counts),
                                static_cast<long long*>(S),
                                static_cast<cudaStream_t>(stream));
}
