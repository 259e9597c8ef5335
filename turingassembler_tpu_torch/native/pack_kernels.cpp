// Host 2-bit read packing: the port's twin of the JAX package's
// native/pack_kernels.cpp (its libtapack.so), built by _build.build_host
// and bound in kmer/count.py (host_pack_reads).  The JAX package ships
// its reads packed to 2.25 bits a base over its TPU host link; no path
// of the port does (its reads cross PCIe as uint8 codes), and
// chip_smoke.py times the pack against the plain copy.
//
// Layout (row-major, matching host_pack_reads bit-exactly):
//   packed (B, ceil(L/4)) uint8 — base i of row r in bits (2*(i%4))..+1
//       of packed[r][i/4]; invalid bases (code >= 4) stored as 3
//       (numpy's np.minimum(bases, 3)).
//   nmask  (B, ceil(L/8)) uint8 — validity bit (code < 4) for base i in
//       bit (i%8) of nmask[r][i/8].

#include <cstdint>
#include <cstring>

extern "C" {

void ta_pack_reads(const uint8_t *bases, int64_t B, int64_t L,
                   uint8_t *packed, uint8_t *nmask) {
    const int64_t P = (L + 3) / 4;
    const int64_t M = (L + 7) / 8;
    for (int64_t r = 0; r < B; r++) {
        const uint8_t *src = bases + r * L;
        uint8_t *pd = packed + r * P;
        uint8_t *md = nmask + r * M;
        int64_t i = 0;
        // full groups of 8 bases -> 2 packed bytes + 1 mask byte
        for (; i + 8 <= L; i += 8) {
            uint8_t c0 = src[i], c1 = src[i + 1], c2 = src[i + 2],
                    c3 = src[i + 3], c4 = src[i + 4], c5 = src[i + 5],
                    c6 = src[i + 6], c7 = src[i + 7];
            uint8_t m = (uint8_t)((c0 < 4) | ((c1 < 4) << 1) |
                                  ((c2 < 4) << 2) | ((c3 < 4) << 3) |
                                  ((c4 < 4) << 4) | ((c5 < 4) << 5) |
                                  ((c6 < 4) << 6) | ((c7 < 4) << 7));
            if (c0 > 3) c0 = 3;
            if (c1 > 3) c1 = 3;
            if (c2 > 3) c2 = 3;
            if (c3 > 3) c3 = 3;
            if (c4 > 3) c4 = 3;
            if (c5 > 3) c5 = 3;
            if (c6 > 3) c6 = 3;
            if (c7 > 3) c7 = 3;
            pd[i / 4] = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
            pd[i / 4 + 1] = (uint8_t)(c4 | (c5 << 2) | (c6 << 4) | (c7 << 6));
            md[i / 8] = m;
        }
        // ragged tail
        if (i < L) {
            memset(pd + i / 4, 0, (size_t)(P - i / 4));
            memset(md + i / 8, 0, (size_t)(M - i / 8));
            for (; i < L; i++) {
                uint8_t c = src[i];
                md[i / 8] |= (uint8_t)((c < 4) << (i % 8));
                if (c > 3) c = 3;
                pd[i / 4] |= (uint8_t)(c << (2 * (i % 4)));
            }
        }
    }
}

}  // extern "C"
