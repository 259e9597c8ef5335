// Open-addressing k-mer counter insert: one thread a lane, atomicCAS
// claims.
//
// Replaces turingassembler_tpu/ops/devhash.py:_insert_body (jitted XLA,
// not Pallas).  The TPU has no atomics, so the JAX package turns the
// upstream kmhash CAS loop (src/kmhash.c) into scatter-claim /
// gather-verify probe rounds.  Hopper has atomicCAS, so this kernel is
// the CAS loop again.  The function is the same: every valid lane adds 1
// to the count of its k-mer's slot in a table of power-of-two capacity C,
// probing at most MAX_PROBES slots slot, slot + stride, ... (mod C); the
// 64-bit fingerprint (fpA, fpB) is a filter and the identity is the full
// payload; a lane that finds no slot is counted in *ovf.  The wrapper
// (ops/devhash.py) computes slot, stride and the fingerprints with
// ops/limbs.hash_limbs, so the hashes have one definition; its plain
// version is the probe-round formulation of the JAX function.
//
// The table is structure-of-arrays of 32-bit words: fp0, fp1, nl payload
// arrays of C words each, and int32 counts.  fp0 is the slot's lock and
// publication word: EMPTY (all ones) -> BUSY (claimed, being written) ->
// fpA (published).  fpA never takes either value: the wrapper maps
// 0xFFFFFFFE and 0xFFFFFFFF to 0xFFFFFFFD.
//
//   - fp0 == fpA, fp1 == fpB and every payload word equal: atomicAdd the
//     count, done;
//   - fp0 EMPTY: atomicCAS(EMPTY -> BUSY).  The winner writes fp1 and the
//     payload, __threadfence(), publishes fpA with atomicExch, counts.
//     The loser reads the same slot again (it may hold the loser's own
//     key now);
//   - fp0 BUSY: spin on a volatile re-read, with __nanosleep.  The spin
//     must not be hoisted out of the loop, hence the volatile load.  The
//     lane that holds BUSY may be in the spinning lane's own warp:
//     independent thread scheduling (sm_70 and later) lets the diverged
//     writer run to its publish while the other lanes spin;
//   - any other key: the next probe slot.
// A published slot is never written again, so a reader that sees fpA
// (volatile load, then __threadfence() as the acquire side of the
// writer's fence + atomicExch) reads the final fp1 and payload; those
// reads are volatile too, so that no stale L1 line is used.  Unlike the
// probe rounds, no claim can leave a slot with words of two keys, so
// near full load this kernel may fit a batch that the plain version
// reports as overflow; below that both hold the same (key, count) set.
//
// What bounds the insert on an H100: bytes, at 3.35 TB/s.  As a
// function (the JAX one computes its hashes from the key) it reads each
// valid lane's nl key words and each lane's valid byte once; a claimed
// slot costs its fp0 read, its fp0, fp1 and payload words written and its
// count read and written, a hit slot its fp0, fp1 and payload read and
// its count read and written.  This design also reads four hash words a
// lane that the wrapper computed in tensor code, and that hashing costs
// several times this launch; the slots are random, so each touch moves a
// 32-byte sector in practice.  The next redesign computes the three
// hash_limbs in this kernel; a warp on a group of slots comes after.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr uint32_t BUSY = 0xFFFFFFFEu;
constexpr int MAX_PROBES = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
    return *reinterpret_cast<const volatile uint32_t*>(p);
}

template <int NL>
__global__ void __launch_bounds__(THREADS)
insert_kernel(const uint32_t* __restrict__ keys,    // (n, NL)
              const uint32_t* __restrict__ hashes,  // (4, n): slot, stride, fpA, fpB
              const uint8_t* __restrict__ valid,    // (n,)
              long long n, uint32_t mask,
              uint32_t* fp0, uint32_t* fp1,
              uint32_t* payload,                    // (NL, C)
              int* counts, int* ovf) {
    const long long cap = (long long)mask + 1;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        if (!valid[i]) continue;
        uint32_t key[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) key[l] = keys[i * NL + l];
        uint32_t s = hashes[i];
        const uint32_t stride = hashes[n + i];
        const uint32_t a = hashes[2 * n + i];
        const uint32_t b = hashes[3 * n + i];
        bool done = false;
        for (int probe = 0; probe < MAX_PROBES && !done; ++probe) {
            while (true) {
                const uint32_t cur = load_volatile(fp0 + s);
                if (cur == EMPTY) {
                    if (atomicCAS(fp0 + s, EMPTY, BUSY) == EMPTY) {
                        fp1[s] = b;
#pragma unroll
                        for (int l = 0; l < NL; ++l)
                            payload[l * cap + s] = key[l];
                        __threadfence();
                        atomicExch(fp0 + s, a);
                        atomicAdd(counts + s, 1);
                        done = true;
                        break;
                    }
                    continue;            // lost the claim: read the slot again
                }
                if (cur == BUSY) {
                    __nanosleep(32);
                    continue;
                }
                __threadfence();
                bool same = cur == a && load_volatile(fp1 + s) == b;
#pragma unroll
                for (int l = 0; l < NL; ++l)
                    same = same && load_volatile(payload + l * cap + s) == key[l];
                if (same) {
                    atomicAdd(counts + s, 1);
                    done = true;
                }
                break;
            }
            s = (s + stride) & mask;
        }
        if (!done) atomicAdd(ovf, 1);
    }
}

template <int NL>
void launch(const uint32_t* keys, const uint32_t* hashes, const uint8_t* valid,
            long long n, uint32_t mask, uint32_t* fp0, uint32_t* fp1,
            uint32_t* payload, int* counts, int* ovf, cudaStream_t stream) {
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    insert_kernel<NL><<<(unsigned)blocks, THREADS, 0, stream>>>(
        keys, hashes, valid, n, mask, fp0, fp1, payload, counts, ovf);
}

}  // namespace

// keys (n, nl) uint32 words, hashes (4, n), valid (n,) bytes; the table's
// fp0, fp1 (C,), payload (nl, C), counts (C,) int32 and the overflow
// counter (1,) int32.  capacity is a power of two; 1 <= nl <= 8.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int devhash_insert_launch(const void* keys, const void* hashes,
                                     const void* valid, long long n, int nl,
                                     long long capacity, void* fp0, void* fp1,
                                     void* payload, void* counts, void* ovf,
                                     void* stream) {
    if (n <= 0) return 0;
    if (capacity <= 0 || (capacity & (capacity - 1)) || capacity > (1LL << 32))
        return (int)cudaErrorInvalidValue;
    const uint32_t mask = (uint32_t)(capacity - 1);
    auto k = static_cast<const uint32_t*>(keys);
    auto h = static_cast<const uint32_t*>(hashes);
    auto v = static_cast<const uint8_t*>(valid);
    auto f0 = static_cast<uint32_t*>(fp0);
    auto f1 = static_cast<uint32_t*>(fp1);
    auto p = static_cast<uint32_t*>(payload);
    auto c = static_cast<int*>(counts);
    auto o = static_cast<int*>(ovf);
    auto st = static_cast<cudaStream_t>(stream);
    switch (nl) {
        case 1: launch<1>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        case 2: launch<2>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        case 3: launch<3>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        case 4: launch<4>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        case 5: launch<5>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        case 6: launch<6>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        case 7: launch<7>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        case 8: launch<8>(k, h, v, n, mask, f0, f1, p, c, o, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
