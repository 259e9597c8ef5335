// Host graph-build kernels: the port's twin of the JAX package's
// native/graph_kernels.cpp (its libtagraph.so), built by
// _build.build_host and bound in graph/build.py (_pointer_double_to_head,
// _first_seen_ids).
//
// The unitig chain walk is the one part of level-0 construction that is
// inherently sequential per chain (the reference walks it with per-thread
// cursors, src/kmer_build.c:421-542).  The numpy pointer-doubling
// formulation costs O(n log n) gathers; this is the O(n) serial walk the
// reference uses, at ~100 ns/step of dependent random access.
//
// ta_list_rank: given functional `prev` pointers (-1 = chain head),
// compute for every element the index of its chain head and its distance
// from that head.  Pure cycles (no head) are broken at their minimum
// element, matching the numpy version in graph/build.py.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

void ta_list_rank(const int32_t *prev, int64_t n, int32_t *head_of,
                  int32_t *dist) {
    std::vector<int32_t> nxt(n, -1);
    for (int64_t i = 0; i < n; i++) {
        int32_t p = prev[i];
        if (p >= 0) nxt[p] = (int32_t)i;
    }
    for (int64_t i = 0; i < n; i++) head_of[i] = -1;
    // chains: walk forward from each head
    for (int64_t i = 0; i < n; i++) {
        if (prev[i] >= 0) continue;
        int32_t d = 0;
        for (int32_t j = (int32_t)i; j >= 0; j = nxt[j]) {
            head_of[j] = (int32_t)i;
            dist[j] = d++;
        }
    }
    // pure cycles: break at the minimum element
    for (int64_t i = 0; i < n; i++) {
        if (head_of[i] != -1) continue;
        int32_t m = (int32_t)i;
        for (int32_t j = nxt[(int32_t)i]; j != (int32_t)i; j = nxt[j])
            if (j < m) m = j;
        int32_t d = 0;
        int32_t j = m;
        do {
            head_of[j] = m;
            dist[j] = d++;
            j = nxt[j];
        } while (j != m);
    }
}

// Dense-id assignment for 64-bit fingerprints: ids are first-seen
// order (node identity only ever feeds adjacency bookkeeping, so no
// sorted order is required — replaces np.unique(return_inverse)).
// cap must be a power of two >= 2n.  Returns the number of unique keys.
int64_t ta_unique_ids(const uint64_t *keys, int64_t n, int64_t cap,
                      int32_t *ids_out) {
    std::vector<uint64_t> tkey((size_t)cap);
    std::vector<int32_t> tid((size_t)cap);
    const uint64_t EMPTY = 0xFFFFFFFFFFFFFFFFull;
    for (int64_t i = 0; i < cap; i++) tkey[(size_t)i] = EMPTY;
    const uint64_t mask = (uint64_t)cap - 1;
    int32_t next_id = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t k = keys[i];
        if (k == EMPTY) k = EMPTY - 1;  // sentinel guard (fp-collision class)
        // splitmix64 finalizer
        uint64_t h = k;
        h ^= h >> 30;
        h *= 0xBF58476D1CE4E5B9ull;
        h ^= h >> 27;
        h *= 0x94D049BB133111EBull;
        h ^= h >> 31;
        uint64_t s = h & mask;
        while (true) {
            if (tkey[s] == k) {
                ids_out[i] = tid[s];
                break;
            }
            if (tkey[s] == EMPTY) {
                tkey[s] = k;
                tid[s] = next_id;
                ids_out[i] = next_id++;
                break;
            }
            s = (s + 1) & mask;
        }
    }
    return next_id;
}

}  // extern "C"
