// The k-mer count's device program for Hopper: canonical (k+1)-mer
// extraction, a stable LSD radix sort of limb rows, and the run-length
// count (with a segmented sum of a payload for the merge of two runs).
//
// Replaces jitted JAX device code (XLA, not Pallas):
//   - turingassembler_tpu/kmer/megasort.py:73 _extract_chunk (+
//     ops/kmers.py:64 extract_canonical_kmers): entry ks_extract_launch;
//   - megasort.py:165 _sort_count (lax.sort with num_keys, then the
//     run-length pass): ks_load_launch + ks_sort_passes_launch +
//     ks_runs_count_launch + ks_runs_write_launch;
//   - megasort.py:225 _merge_unique_runs: the same, with the counts as an
//     int32 payload that the run pass sums (any number of equal rows, where
//     the JAX function sums at most two);
//   - the stable lexicographic permutation (JAX lax.sort with num_keys,
//     the port's ops/limbs.py:plain_lex_order): the same sort with the row
//     index as its payload.
//
// Extraction.  A block stages a group of reads in shared memory as, for
// each position q, the 32-bit packing of bases q..q+15 and a bit mask of
// the codes >= 4 (copied from csrc/devhash.cu:count_reads_kernel).  A
// thread a window takes its forward limbs as packed words at q = p + 16 l,
// its reverse-complement limbs as the complemented, group-reversed words
// at q = p + k1 - 16 - 16 l, and keeps the smaller (ties keep the forward
// form).  Rows come out in (read, window) order with no atomics: a count
// pass writes each block's valid windows, one block scans them, and the
// write pass places each valid window at its block's offset plus its rank
// in a block scan.  Rows are nl uint32 limbs, row-major.
//
// Sort.  Keys as nl separate uint32 arrays (SoA) in two ping-pong buffers,
// with an optional 32-bit payload beside them.  The load kernel reads the
// caller's row-major rows (int32 or int64 limbs, one or two segments),
// writes the SoA copy and counts every digit of every pass at once (as
// CUB's onesweep does up front); the host reads that histogram and skips a
// pass whose digit has one non-empty bucket.  Digits are the four bytes of
// each limb (ops/kmer_sort.py:digit_plan); the skip drops a digit that is
// 0 in every row, so a k1-mer's rows take ceil(2 k1 / 8) passes: 12 at
// k1 = 46.  Eleven-bit digits would take 9, but a 4,096-key tile
// then spreads over 2,048 buckets, about two keys a bucket, so the scatter
// writes 4-byte pieces and the (tile, digit) table grows eightfold.  A
// pass: a tile count kernel (256-bucket histogram of a 4,096-key tile,
// tile-major), a two-level scan of the (tile, digit) counts (group sums,
// one block across groups, then each group's tiles), and the scatter: a
// warp ranks its 16 x 32 keys in order with __match_any_sync and per-warp
// counters, the block adds the warps' prefixes, and the tile is reordered
// by digit in shared memory so that each digit's keys go out as one
// contiguous run.  Every step keeps the input order among equal digits,
// so the sort is stable and the permutation is the torch.argsort chain's.
// No key pads a tile: the tail tile counts its rows.
//
// Runs.  A tile pass marks run starts (a row differs from the one before)
// and sums the payload (1 a row without one), one block scans the tiles'
// counts and sums, and a write pass puts each run's key (int64 limbs, the
// callers' format) and the payload's exclusive prefix at its start; a
// last pass takes the count as the difference of neighbouring prefixes.
//
// What bounds it on an H100: bytes, at 3.35 TB/s.  As a function the
// count reads the rows once and writes the unique rows and counts once;
// this design moves the keys twice a pass (read and scatter) plus a digit
// limb once more, 12 passes at k1 = 46.  Onesweep's decoupled look-back
// (one read of the digit limb less a pass, no tile count kernel) and a
// merge-path merge in place of concat + re-sort are for later.
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

// Exclusive prefix of v over the block (THREADS threads, all of which call
// it); *total gets the block's sum.  sh holds WARPS values.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total, T* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T x = warp_inclusive_scan<T>(v);
    if (lane == 31) sh[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T s = lane < WARPS ? sh[lane] : T(0);
        s = warp_inclusive_scan<T>(s);
        if (lane < WARPS) sh[lane] = s;
    }
    __syncthreads();
    const T before = warp ? sh[warp - 1] : T(0);
    *total = sh[WARPS - 1];
    __syncthreads();                      // sh is reused by the next call
    return before + x - v;
}

// ---------------------------------------------------------------------------
// One block: exclusive scan in place of gridDim.x arrays of len int64 each
// (array b at a + b * len); total[b] gets array b's sum.
// ---------------------------------------------------------------------------
constexpr int SCAN_PER = 8;

__global__ void __launch_bounds__(THREADS)
scan_ll_kernel(long long* a, long long len, long long* total) {
    __shared__ long long sh[WARPS];
    long long* x = a + (size_t)blockIdx.x * len;
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
            if (first + j < len) x[first + j] = run;
            run += v[j];
        }
        carry += tot;
    }
    if (threadIdx.x == 0) total[blockIdx.x] = carry;
}

// ---------------------------------------------------------------------------
// Extraction
// ---------------------------------------------------------------------------

// Reverse the sixteen 2-bit groups of x (ops/limbs.py:_rev2bits_in_u32).
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
    x = __brev(x);
    return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Shared words a read: its invalid-base mask, then its packed positions
// -16 .. L-1 (the write pass only).
__host__ __device__ __forceinline__ int mask_words(int L) { return L / 32 + 2; }
__host__ __device__ __forceinline__ int packed_words(int L) { return L + 16; }

// WRITE false: block_rows[blockIdx.x] = the block's valid windows.  WRITE
// true: block_rows holds their exclusive scan; the rows go to out.
template <int NL, bool WRITE>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const uint8_t* __restrict__ bases,     // (B, L)
               const int* __restrict__ lengths,       // (B,)
               long long B, int L, int k1, int reads_per_block,
               long long* __restrict__ block_rows,
               uint32_t* __restrict__ out) {          // (n, NL)
    extern __shared__ uint32_t smem[];
    __shared__ int scan_sh[WARPS];
    const int P = L - k1 + 1;
    const int MW = mask_words(L), LW = packed_words(L);
    uint32_t* bad = smem;                                  // (R, MW)
    uint32_t* packed = smem + reads_per_block * MW;        // (R, LW)
    const long long b0 = (long long)blockIdx.x * reads_per_block;
    const int nr = (int)min((long long)reads_per_block, B - b0);
    const uint8_t* rows = bases + b0 * L;
    if (WRITE) {
        // packed[r][16 + q]: bases q .. q+15 of read r, base q in the top
        // two bits; codes >= 4 and positions outside [0, L) pack as 0
        for (int i = threadIdx.x; i < nr * LW; i += blockDim.x) {
            const int r = i / LW, q = i - r * LW - 16;
            const uint8_t* row = rows + (long long)r * L;
            uint32_t w = 0;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int pos = q + j;
                const uint32_t c = (pos >= 0 && pos < L) ? row[pos] : 0u;
                w |= (c < 4 ? c : 0u) << (30 - 2 * j);
            }
            packed[i] = w;
        }
    }
    // bad[r][w]: bit j set when base 32 w + j of read r is a code >= 4.  A
    // warp's 32 iterations share r and w (blockDim and MW * 32 are
    // multiples of 32), so every lane takes part in the ballot
    for (int i = threadIdx.x; i < nr * MW * 32; i += blockDim.x) {
        const int r = i / (MW * 32), q = i - r * MW * 32;
        const bool is_bad = q < L && rows[(long long)r * L + q] >= 4;
        const uint32_t bits = __ballot_sync(FULL, is_bad);
        if ((threadIdx.x & 31) == 0) bad[r * MW + q / 32] = bits;
    }
    __syncthreads();
    const int used = 2 * k1 - 32 * (NL - 1);        // bits of the last limb
    const uint32_t last = used == 32 ? ~0u : ~0u << (32 - used);
    long long base = WRITE ? block_rows[blockIdx.x] : 0;
    const int nwin = nr * P;
    for (int c0 = 0; c0 < nwin; c0 += THREADS) {    // every thread, every chunk
        const int i = c0 + threadIdx.x;
        const int r = i / P, p = i - r * P;
        bool ok = i < nwin && p + k1 <= lengths[b0 + min(r, nr - 1)];
        if (ok) {
            const uint32_t* bw = bad + r * MW;
            for (int off = 0; off < k1; off += 32) {
                const int q = p + off;
                const uint32_t bits =
                    __funnelshift_r(bw[q >> 5], bw[(q >> 5) + 1], q & 31);
                const int nb = min(32, k1 - off);
                ok = ok && !(bits & (nb == 32 ? ~0u : (1u << nb) - 1u));
            }
        }
        int n_chunk;
        const int rank = block_exclusive_scan<int>(ok ? 1 : 0, &n_chunk,
                                                   scan_sh);
        if (WRITE && ok) {
            const uint32_t* pr = packed + r * LW + 16;
            uint32_t fw[NL], rc[NL];
#pragma unroll
            for (int l = 0; l < NL; ++l) {
                fw[l] = pr[p + 16 * l];
                rc[l] = rev2(~pr[p + k1 - 16 - 16 * l]);
            }
            fw[NL - 1] &= last;
            rc[NL - 1] &= last;
            bool lt = false, eq = true;       // ops/limbs.py:lex_lt(rc, fw)
#pragma unroll
            for (int l = 0; l < NL; ++l) {
                lt = lt || (eq && rc[l] < fw[l]);
                eq = eq && rc[l] == fw[l];
            }
            uint32_t* dst = out + (size_t)(base + rank) * NL;
#pragma unroll
            for (int l = 0; l < NL; ++l) dst[l] = lt ? rc[l] : fw[l];
        }
        base += n_chunk;
    }
    if (!WRITE && threadIdx.x == 0) block_rows[blockIdx.x] = base;
}

// reads a block: about one window a thread, within the default shared
// memory
int reads_per_block(int L, int k1) {
    const size_t per_read =
        (size_t)(mask_words(L) + packed_words(L)) * sizeof(uint32_t);
    const int P = L - k1 + 1;
    int R = THREADS / P > 1 ? THREADS / P : 1;
    const int fit = (int)(SMEM_DEFAULT / per_read);
    if (R > fit) R = fit > 1 ? fit : 1;
    return R;
}

template <int NL>
struct Extract {
    static int run(const void* bases, const void* lengths, long long B,
                   int L, int k1, void* block_rows, void* total, void* out,
                   cudaStream_t st) {
        const int R = reads_per_block(L, k1);
        // the count pass holds only the masks, within the default
        const size_t smem_c = (size_t)R * mask_words(L) * sizeof(uint32_t);
        const size_t smem_w =
            (size_t)R * (mask_words(L) + packed_words(L)) * sizeof(uint32_t);
        if (smem_w > SMEM_MAX) return (int)cudaErrorInvalidValue;
        if (smem_w > SMEM_DEFAULT) {
            const cudaError_t e = cudaFuncSetAttribute(
                extract_kernel<NL, true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_w);
            if (e != cudaSuccess) return (int)e;
        }
        const long long blocks = (B + R - 1) / R;
        if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        const uint8_t* b = static_cast<const uint8_t*>(bases);
        const int* l = static_cast<const int*>(lengths);
        long long* br = static_cast<long long*>(block_rows);
        uint32_t* o = static_cast<uint32_t*>(out);
        extract_kernel<NL, false><<<(unsigned)blocks, THREADS, smem_c, st>>>(
            b, l, B, L, k1, R, br, o);
        scan_ll_kernel<<<1, THREADS, 0, st>>>(br, blocks,
                                              static_cast<long long*>(total));
        extract_kernel<NL, true><<<(unsigned)blocks, THREADS, smem_w, st>>>(
            b, l, B, L, k1, R, br, o);
        return 0;
    }
};

// ---------------------------------------------------------------------------
// Sort: load + histogram of every pass
// ---------------------------------------------------------------------------

// Limb l of row i of the caller's row-major rows: rows [0, na) from a,
// the rest from b; 8-byte limbs (int64 values in [0, 2^32)) when wide,
// their high words OR-ed into *high.
struct Rows {
    const void* a;
    const void* b;
    long long na;
    int wide;
};

template <int NL>
__device__ __forceinline__ uint32_t row_limb(const Rows& src, long long i,
                                             int l, uint32_t* high) {
    const void* p = i < src.na ? src.a : src.b;
    const long long r = i < src.na ? i : i - src.na;
    if (!src.wide) return static_cast<const uint32_t*>(p)[r * NL + l];
    const unsigned long long v =
        static_cast<const unsigned long long*>(p)[r * NL + l];
    *high |= (uint32_t)(v >> 32);
    return (uint32_t)v;
}

// pay_mode: 0 none, 1 the caller's int32 values (rows [0, na) from pa, the
// rest from pb), 2 the row index.  hist[plan.n * RADIX] becomes 1 when an
// int64 limb is outside [0, 2^32): the sort would read only its low word.
template <int NL>
__global__ void __launch_bounds__(THREADS)
load_hist_kernel(Rows src, long long n, const int* __restrict__ pa,
                 const int* __restrict__ pb, int pay_mode, Plan plan,
                 uint32_t* __restrict__ keys,          // (NL, n)
                 uint32_t* __restrict__ pay,           // (n,)
                 uint32_t* __restrict__ hist) {    // (plan.n, RADIX) + 1
    __shared__ uint32_t h[MAX_PASSES * RADIX];
    for (int i = threadIdx.x; i < plan.n * RADIX; i += blockDim.x) h[i] = 0;
    __syncthreads();
    const long long step = (long long)gridDim.x * blockDim.x;
    uint32_t high = 0;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        uint32_t key[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) {
            key[l] = row_limb<NL>(src, i, l, &high);
            keys[(size_t)l * n + i] = key[l];
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
    if (__syncthreads_or(high != 0) && threadIdx.x == 0)
        hist[plan.n * RADIX] = 1u;
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
// pass's histogram) plus the keys of that digit in groups before g.
__global__ void __launch_bounds__(THREADS)
group_scan_kernel(const uint32_t* __restrict__ hist, uint32_t* gsum,
                  long long groups) {
    __shared__ uint32_t sh[WARPS];
    const int d = threadIdx.x;
    uint32_t tot;
    uint32_t run = block_exclusive_scan<uint32_t>(hist[d], &tot, sh);
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
// uint32, nl = ceil(k1 / 16), in (read, window) order.  block_rows: B + 1
// int64 of scratch; total (1,) int64 gets n.  out holds B * (L - k1 + 1)
// rows, the most there can be.
extern "C" int ks_extract_launch(const void* bases, const void* lengths,
                                 long long B, int L, int k1,
                                 void* block_rows, void* total, void* out,
                                 void* stream) {
    if (k1 < 1 || k1 > 16 * MAX_NL || B < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B == 0 || L < k1)
        return (int)cudaMemsetAsync(total, 0, sizeof(long long), st);
    return dispatch<Extract>((k1 + 15) / 16, bases, lengths, B, L, k1,
                             block_rows, total, out, st);
}

// Load: the caller's rows (n, nl) row-major, int32 (wide 0) or int64
// limbs (wide 1), rows [0, na) at ka and the rest at kb, into keys (nl, n)
// uint32; the payload (pay_mode 1: pa / pb split as the rows; 2: the row
// index) into pay (n,); hist (npass * 256 + 1) uint32: the digit counts
// of every pass of the plan (npass (limb, shift, bits) triples in host
// memory), then 1 when an int64 limb is outside [0, 2^32), else 0.
extern "C" int ks_load_launch(const void* ka, const void* kb, long long na,
                              long long n, int nl, int wide, const void* pa,
                              const void* pb, int pay_mode,
                              const int* plan_host, int npass, void* keys,
                              void* pay, void* hist, void* stream) {
    Plan plan;
    if (bad_rows(n, nl) || na < 0 || na > n || pay_mode < 0 || pay_mode > 2 ||
        !read_plan(plan_host, npass, nl, &plan))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = cudaMemsetAsync(
        hist, 0, ((size_t)npass * RADIX + 1) * sizeof(uint32_t), st);
    if (e != cudaSuccess) return (int)e;
    if (n == 0) return 0;
    Rows src{ka, kb, na, wide};
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
// counts; scratch: ks_sort_scratch_words(n) words.  After an even number
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
        group_scan_kernel<<<1, THREADS, 0, st>>>(h + (size_t)p * RADIX, gsum,
                                                 groups);
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
    scan_ll_kernel<<<2, THREADS, 0, st>>>(static_cast<long long*>(tiles),
                                          ntiles,
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
