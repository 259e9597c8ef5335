// Open-addressing k-mer counter for Hopper: one thread a key, the hashes
// computed in the kernel, one 32-byte slot record a probe.
//
// Replaces two jitted JAX functions (XLA, not Pallas):
//   - turingassembler_tpu/ops/devhash.py:_insert_body, the insert of a
//     batch of keys (entry devhash_insert_launch, "the rows entry");
//   - turingassembler_tpu/kmer/count.py:_count_batch_fused, unpack +
//     canonical (k+1)-mer extraction + insert in one dispatch (entry
//     devhash_count_reads_launch, "the reads entry").
// The TPU has no atomics, so the JAX package claims slots with
// scatter-claim / gather-verify probe rounds.  Hopper has them, so this is
// upstream kmhash's CAS loop (src/kmhash.c) again.  The function is the
// JAX one: every valid lane adds 1 to the count of its key's slot in a
// table of power-of-two capacity C, probing at most MAX_PROBES slots slot,
// slot + stride, ... (mod C); the 64-bit fingerprint (fpA, fpB) is a
// filter and the identity is the full payload; a lane that finds no slot
// is counted in *ovf.
//
// Hashes.  key_hashes is the twin of ops/limbs.py:hash_limbs (murmur3's
// per-limb mix, then fmix32) on native uint32_t, whose wraparound is what
// mul32 emulates in int64, with the three seeds of ops/devhash.py:hashes:
// slot = h1 & mask, stride = (h2 | 1) & mask, fpA = h2 (0xFFFFFFFE and
// 0xFFFFFFFF become 0xFFFFFFFD), fpB = h3.  devhash_hashes_launch writes
// them out so that they can be held against hashes() bit for bit: a table
// cannot show a wrong hash, since identity is the payload.
//
// Keys.  The rows entry reads the (n, nl) int64 limb tensor (values in
// [0, 2^32)) as the port's callers hold it: 8 bytes a limb, where a
// conversion to int32 words first would read those 8, write 4 and have
// the kernel read the 4 again.  The reads entry reads the (B, L) uint8
// codes and (B,) int32 lengths: a block stages a group of reads in shared
// memory as, for each position q, the 32-bit packing of bases q..q+15
// (ops/limbs.py:base_shift) and a bit mask of the codes >= 4.  A thread a
// window then takes its forward limbs as packed words at q = p + 16 l and
// its reverse-complement limbs as the complemented, group-reversed words
// at q = p + k1 - 16 - 16 l, keeps the reverse complement when it is
// lexicographically smaller (ties keep the forward form), and inserts it
// when the window has no code >= 4 and p + k1 <= length
// (ops/kmers.py:extract_canonical_kmers).  No (B, P, nl) tensor exists.
//
// Table.  (C, W) 32-bit words, one record a slot: fp0, fp1, payload[nl],
// count, padding.  W = 8 (32 bytes, one sector) for nl <= 5, 16 for nl
// 6-8; the wrapper checks that the table is 32-byte aligned.  fp0 is the
// slot's lock and publication word: EMPTY (all ones) -> BUSY (claimed,
// being written) -> fpA (published).
//   - fp0, acquire-loaded, EMPTY: atomicCAS(EMPTY -> BUSY).  The winner
//     writes fp1 and the payload, release-stores fpA, then atomicAdds the
//     count.  The loser reads the slot again (it may hold its key now);
//   - BUSY: spin on the acquire load with __nanosleep.  The lane holding
//     BUSY may be in the spinning lane's own warp: independent thread
//     scheduling lets it run to its publish;
//   - fpA: the rest of the record in one 16-byte vector load (two for
//     nl >= 3).  A published record is never written again but for its
//     count, and the acquire orders these plain loads after the writer's
//     release, so they see the final fp1 and payload.  All equal:
//     atomicAdd the count, done;
//   - anything else: the next probe slot.
// Unlike the probe rounds no claim can leave a slot with words of two
// keys, so near full load this kernel may fit a batch that the plain
// version reports as overflow; below that both hold the same (key, count)
// set.
//
// What bounds it on an H100: bytes, at 3.35 TB/s.  As a function the rows
// entry reads each valid lane's key words and each lane's valid byte
// once, and touches one record a distinct key; the reads entry reads the
// codes and lengths once.  The slots are random, so each probe moves a
// 32-byte sector: one a probe, where the structure-of-arrays table of the
// first design moved about six.  What is left is latency: a claim is a
// chain of four dependent trips to L2 (acquire load, CAS, release store,
// count), covered only by the lanes in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr uint32_t BUSY = 0xFFFFFFFEu;
constexpr uint32_t FP_SUBST = 0xFFFFFFFDu;
constexpr uint32_t SEED_SLOT = 0x9E3779B9u;   // hash_limbs' default seed
constexpr uint32_t SEED_A = 0xC2B2AE35u;
constexpr uint32_t SEED_B = 0x27D4EB2Fu;
constexpr int MAX_PROBES = 8;
constexpr int THREADS = 256;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 232448;           // 227 KB, a block's opt-in limit

__host__ __device__ constexpr int record_words(int nl) {
    return nl <= 5 ? 8 : 16;
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

struct Hashes {
    uint32_t slot, stride, a, b;
};

template <int NL>
__device__ __forceinline__ uint32_t hash_mixed(const uint32_t (&x)[NL],
                                               uint32_t h) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        h = rotl32(h ^ x[l], 13);
        h = h * 5u + 0xE6546B64u;
    }
    return fmix32(h);
}

template <int NL>
__device__ __forceinline__ Hashes key_hashes(const uint32_t (&key)[NL],
                                             uint32_t mask) {
    uint32_t x[NL];   // the per-limb mix does not depend on the seed
#pragma unroll
    for (int l = 0; l < NL; ++l)
        x[l] = rotl32(key[l] * 0xCC9E2D51u, 15) * 0x1B873593u;
    const uint32_t h1 = hash_mixed<NL>(x, SEED_SLOT);
    const uint32_t h2 = hash_mixed<NL>(x, SEED_A);
    Hashes h;
    h.slot = h1 & mask;
    h.stride = (h2 | 1u) & mask;
    h.a = h2 >= BUSY ? FP_SUBST : h2;
    h.b = hash_mixed<NL>(x, SEED_B);
    return h;
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// Count one key; false when its MAX_PROBES slots hold other keys.
template <int NL>
__device__ bool insert_key(uint32_t* table, uint32_t mask,
                           const uint32_t (&key)[NL]) {
    constexpr int W = record_words(NL);
    constexpr int NV = (2 + NL + 3) / 4;   // 16-byte words up to the payload's end
    const Hashes h = key_hashes<NL>(key, mask);
    uint32_t s = h.slot;
    for (int probe = 0; probe < MAX_PROBES; ++probe) {
        uint32_t* rec = table + (size_t)s * W;
        while (true) {
            const uint32_t cur = load_acquire(rec);
            if (cur == EMPTY) {
                if (atomicCAS(rec, EMPTY, BUSY) != EMPTY)
                    continue;            // lost the claim: read the slot again
                rec[1] = h.b;
#pragma unroll
                for (int l = 0; l < NL; ++l) rec[2 + l] = key[l];
                store_release(rec, h.a);
                atomicAdd(reinterpret_cast<int*>(rec + 2 + NL), 1);
                return true;
            }
            if (cur == BUSY) {
                __nanosleep(32);
                continue;
            }
            if (cur != h.a) break;
            uint32_t w[4 * NV];
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                const uint4 q = reinterpret_cast<const uint4*>(rec)[v];
                w[4 * v] = q.x;
                w[4 * v + 1] = q.y;
                w[4 * v + 2] = q.z;
                w[4 * v + 3] = q.w;
            }
            bool same = w[1] == h.b;
#pragma unroll
            for (int l = 0; l < NL; ++l) same = same && w[2 + l] == key[l];
            if (!same) break;
            atomicAdd(reinterpret_cast<int*>(rec + 2 + NL), 1);
            return true;
        }
        s = (s + h.stride) & mask;
    }
    return false;
}

template <int NL>
__device__ __forceinline__ void load_key(const long long* keys, long long i,
                                         uint32_t (&key)[NL]) {
#pragma unroll
    for (int l = 0; l < NL; ++l) key[l] = (uint32_t)keys[i * NL + l];
}

template <int NL>
__global__ void __launch_bounds__(THREADS)
insert_rows_kernel(const long long* __restrict__ keys,   // (n, NL)
                   const uint8_t* __restrict__ valid,     // (n,)
                   long long n, uint32_t mask, uint32_t* table, int* ovf) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        if (!valid[i]) continue;
        uint32_t key[NL];
        load_key<NL>(keys, i, key);
        if (!insert_key<NL>(table, mask, key)) atomicAdd(ovf, 1);
    }
}

template <int NL>
__global__ void __launch_bounds__(THREADS)
hashes_kernel(const long long* __restrict__ keys, long long n, uint32_t mask,
              uint32_t* __restrict__ out) {                // (4, n)
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        uint32_t key[NL];
        load_key<NL>(keys, i, key);
        const Hashes h = key_hashes<NL>(key, mask);
        out[i] = h.slot;
        out[n + i] = h.stride;
        out[2 * n + i] = h.a;
        out[3 * n + i] = h.b;
    }
}

// Reverse the sixteen 2-bit groups of x (ops/limbs.py:_rev2bits_in_u32).
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
    x = __brev(x);
    return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Shared words a read: its packed positions -16 .. L-1, then its mask.
__host__ __device__ __forceinline__ int packed_words(int L) { return L + 16; }
__host__ __device__ __forceinline__ int mask_words(int L) { return L / 32 + 2; }

template <int NL>
__global__ void __launch_bounds__(THREADS)
count_reads_kernel(const uint8_t* __restrict__ bases,     // (B, L)
                   const int* __restrict__ lengths,       // (B,)
                   long long B, int L, int k1, int reads_per_block,
                   uint32_t mask, uint32_t* table, int* ovf) {
    extern __shared__ uint32_t smem[];
    const int P = L - k1 + 1;
    const int LW = packed_words(L), MW = mask_words(L);
    uint32_t* packed = smem;                           // (R, LW)
    uint32_t* bad = smem + reads_per_block * LW;       // (R, MW)
    const long long b0 = (long long)blockIdx.x * reads_per_block;
    const int nr = (int)min((long long)reads_per_block, B - b0);
    const uint8_t* rows = bases + b0 * L;
    // packed[r][16 + q]: bases q .. q+15 of read r, base q in the top two
    // bits; codes >= 4 and positions outside [0, L) pack as 0
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
    // bad[r][w]: bit j set when base 32 w + j of read r is a code >= 4.  A
    // warp's 32 iterations share r and w (blockDim and MW * 32 are
    // multiples of 32), so every lane takes part in the ballot
    for (int i = threadIdx.x; i < nr * MW * 32; i += blockDim.x) {
        const int r = i / (MW * 32), q = i - r * MW * 32;
        const bool is_bad = q < L && rows[(long long)r * L + q] >= 4;
        const uint32_t bits = __ballot_sync(0xFFFFFFFFu, is_bad);
        if ((threadIdx.x & 31) == 0) bad[r * MW + q / 32] = bits;
    }
    __syncthreads();
    const int used = 2 * k1 - 32 * (NL - 1);        // bits of the last limb
    const uint32_t last = used == 32 ? ~0u : ~0u << (32 - used);
    for (int i = threadIdx.x; i < nr * P; i += blockDim.x) {
        const int r = i / P, p = i - r * P;
        if (p + k1 > lengths[b0 + r]) continue;
        const uint32_t* bw = bad + r * MW;
        bool ok = true;
        for (int off = 0; off < k1; off += 32) {
            const int q = p + off;
            const uint32_t bits =
                __funnelshift_r(bw[q >> 5], bw[(q >> 5) + 1], q & 31);
            const int nb = min(32, k1 - off);
            ok = ok && !(bits & (nb == 32 ? ~0u : (1u << nb) - 1u));
        }
        if (!ok) continue;
        const uint32_t* pr = packed + r * LW + 16;
        uint32_t fw[NL], rc[NL], key[NL];
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
#pragma unroll
        for (int l = 0; l < NL; ++l) key[l] = lt ? rc[l] : fw[l];
        if (!insert_key<NL>(table, mask, key)) atomicAdd(ovf, 1);
    }
}

unsigned grid_of(long long n) {
    long long blocks = (n + THREADS - 1) / THREADS;
    return (unsigned)(blocks > (1LL << 20) ? (1LL << 20) : blocks);
}

template <int NL>
struct InsertRows {
    static int run(const void* keys, const void* valid, long long n,
                   uint32_t mask, void* table, void* ovf, cudaStream_t st) {
        insert_rows_kernel<NL><<<grid_of(n), THREADS, 0, st>>>(
            static_cast<const long long*>(keys),
            static_cast<const uint8_t*>(valid), n, mask,
            static_cast<uint32_t*>(table), static_cast<int*>(ovf));
        return 0;
    }
};

template <int NL>
struct KeyHashes {
    static int run(const void* keys, long long n, uint32_t mask, void* out,
                   cudaStream_t st) {
        hashes_kernel<NL><<<grid_of(n), THREADS, 0, st>>>(
            static_cast<const long long*>(keys), n, mask,
            static_cast<uint32_t*>(out));
        return 0;
    }
};

template <int NL>
struct CountReads {
    static int run(const void* bases, const void* lengths, long long B,
                   int L, int k1, uint32_t mask, void* table, void* ovf,
                   cudaStream_t st) {
        // about one window a thread: reads_per_block * P <= THREADS
        const size_t per_read =
            (size_t)(packed_words(L) + mask_words(L)) * sizeof(uint32_t);
        const int P = L - k1 + 1;
        int R = THREADS / P > 1 ? THREADS / P : 1;
        const int fit = (int)(SMEM_DEFAULT / per_read);
        if (R > fit) R = fit > 1 ? fit : 1;
        const size_t smem = (size_t)R * per_read;
        if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
        if (smem > SMEM_DEFAULT) {
            const cudaError_t e = cudaFuncSetAttribute(
                count_reads_kernel<NL>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        const long long blocks = (B + R - 1) / R;
        if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        count_reads_kernel<NL><<<(unsigned)blocks, THREADS, smem, st>>>(
            static_cast<const uint8_t*>(bases),
            static_cast<const int*>(lengths), B, L, k1, R, mask,
            static_cast<uint32_t*>(table), static_cast<int*>(ovf));
        return 0;
    }
};

// Run Launch<nl>::run(args...) for 1 <= nl <= 8; the CUDA error of the
// launch (0 when it was accepted).
template <template <int> class Launch, class... Args>
int dispatch(int nl, Args... args) {
    int rc;
    switch (nl) {
        case 1: rc = Launch<1>::run(args...); break;
        case 2: rc = Launch<2>::run(args...); break;
        case 3: rc = Launch<3>::run(args...); break;
        case 4: rc = Launch<4>::run(args...); break;
        case 5: rc = Launch<5>::run(args...); break;
        case 6: rc = Launch<6>::run(args...); break;
        case 7: rc = Launch<7>::run(args...); break;
        case 8: rc = Launch<8>::run(args...); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return rc ? rc : (int)cudaGetLastError();
}

bool bad_capacity(long long capacity) {
    return capacity <= 0 || (capacity & (capacity - 1)) ||
           capacity > (1LL << 32);
}

}  // namespace

// The rows entry: keys (n, nl) int64 limbs, valid (n,) bytes, the table
// (capacity, record_words(nl)) int32 and the overflow counter (1,) int32.
// capacity is a power of two; 1 <= nl <= 8.
extern "C" int devhash_insert_launch(const void* keys, const void* valid,
                                     long long n, int nl, long long capacity,
                                     void* table, void* ovf, void* stream) {
    if (bad_capacity(capacity)) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    return dispatch<InsertRows>(nl, keys, valid, n,
                                (uint32_t)(capacity - 1), table, ovf,
                                static_cast<cudaStream_t>(stream));
}

// The reads entry: bases (n_reads, read_len) uint8 codes (>= 4 invalid or
// padding), lengths (n_reads,) int32, the canonical k1-mers of every
// window; the table as above with nl = ceil(k1 / 16), 1 <= k1 <= 128.
extern "C" int devhash_count_reads_launch(const void* bases,
                                          const void* lengths,
                                          long long n_reads, int read_len,
                                          int k1, long long capacity,
                                          void* table, void* ovf,
                                          void* stream) {
    if (bad_capacity(capacity) || k1 < 1 || k1 > 128)
        return (int)cudaErrorInvalidValue;
    if (n_reads <= 0 || read_len < k1) return 0;
    return dispatch<CountReads>((k1 + 15) / 16, bases, lengths, n_reads,
                                read_len, k1, (uint32_t)(capacity - 1), table,
                                ovf, static_cast<cudaStream_t>(stream));
}

// The check entry: the kernel's own (slot, stride, fpA, fpB) of n keys
// (n, nl) int64 into out (4, n) 32-bit words.
extern "C" int devhash_hashes_launch(const void* keys, long long n, int nl,
                                     long long capacity, void* out,
                                     void* stream) {
    if (bad_capacity(capacity)) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    return dispatch<KeyHashes>(nl, keys, n, (uint32_t)(capacity - 1), out,
                               static_cast<cudaStream_t>(stream));
}
