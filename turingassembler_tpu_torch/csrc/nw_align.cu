// Full-width Gotoh affine-gap alignment score, one (query, target) pair
// per warp.  CUDA counterpart of the Pallas kernel
// turingassembler_tpu/ops/pallas_align.py (_nw_kernel via
// banded_affine_score); see ops/nw_align.py for the wrapper.
//
// Recurrence, rows i = 1..qlen over the query, columns c = 0..tlen over
// the target (t[c-1] is column c's base), go >= 0:
//   E[i][c] = max(E[i-1][c] - ge, H[i-1][c] - go - ge)
//   F[i][c] = max(F[i][c-1] - ge, H[i][c-1] - go - ge)
//   H[i][c] = max(H[i-1][c-1] + s(q[i-1], t[c-1]), E[i][c], F[i][c])
//   H[i][0] = -(go + ge*i)
// Row 0: H[0][c] = 0 ("fit") or -(go + ge*c), H[0][0] = 0 ("global").
// "global" returns H[qlen][tlen]; "fit" returns max_{c <= tlen}
// H[qlen][c].  Codes >= 4 always mismatch.  F is the sequential form of
// the plain version's max_{u<c}(b[i][u] + ge*u) - go - ge*c: for
// go >= 0 a gap opened from a cell that a horizontal gap just reached
// never beats extending that gap, so both give the same H.
//
// What bounds it: 32-bit integer instruction slots (its bytes are two uint8
// rows in and one int32 out per pair).  So the design spends as few
// instructions a cell as it can and never waits on a block barrier:
//
// - A warp owns a pair.  Lane l owns a strip of S neighbouring columns
//   (S is a template parameter, so the strip unrolls into registers):
//   H of the previous row and E of this row for its columns, and its S
//   target bases.
// - The lanes run an anti-diagonal wavefront: at step s lane l is on
//   row s - l + 1.  From lane l - 1 it needs that lane's last-column H
//   and the F that leaves that column, both produced one step earlier:
//   two __shfl_up_sync a step.  The diagonal H is the left H it got the
//   step before.  No shared-memory hand-off and no __syncthreads().
// - Inside the strip F is closed sequentially, and a cell is the DPX
//   instructions viaddmax (max(a + b, c)) for the diagonal term, E and
//   F, one max and one add.
// - The query row is staged once into shared memory (8-byte loads where
//   the row stride allows); a lane reads one query base a step.
// - Column 0 is never a cell: it is the left boundary of lane 0.
//   Targets wider than 32*S columns are walked in column tiles, left to
//   right; lane 31 leaves, per row, its H and outgoing F in shared
//   memory for lane 0 of the next tile.  The next tile reads row i
//   before it writes row i, so one buffer of Lq + 1 pairs of ints a
//   warp is enough.
// - A warp stops at its pair's own qlen and tlen: the work is
//   qlen * (tlen + 1) cells a pair, plus the wavefront's fill and drain
//   (31 steps a tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;

template <int S>
__global__ void __launch_bounds__(32 * MAX_WARPS)
nw_wavefront_kernel(const uint8_t* __restrict__ q,
                    const uint8_t* __restrict__ t,
                    const int* __restrict__ qlen,
                    const int* __restrict__ tlen, int* __restrict__ out,
                    int B, int Lq, int Lt, int match, int mismatch, int go,
                    int ge, int fit, int carry_rows) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= B) return;  // warps are independent: no block barrier below

  // this warp's shared memory: [carry: carry_rows x int2][query bytes]
  const int qbytes = (Lq + 7) & ~7;
  unsigned char* mine =
      smem + (size_t)warp * (8 * (size_t)carry_rows + qbytes);
  int2* carry = reinterpret_cast<int2*>(mine);
  uint8_t* qs = mine + 8 * (size_t)carry_rows;

  const uint8_t* qp = q + (size_t)pair * Lq;
  const uint8_t* tp = t + (size_t)pair * Lt;
  const int nrows = min(qlen[pair], Lq);
  const int ncols = min(tlen[pair], Lt);
  const int goge = go + ge;

  if (((reinterpret_cast<uintptr_t>(q) | (uintptr_t)Lq) & 7) == 0) {
    for (int j = lane; 8 * j < nrows; j += 32)
      reinterpret_cast<uint2*>(qs)[j] = reinterpret_cast<const uint2*>(qp)[j];
  } else {
    for (int j = lane; j < nrows; j += 32) qs[j] = qp[j];
  }
  __syncwarp();

  // column 0 of the last row
  int best = (fit || ncols <= 0) ? (nrows > 0 ? -(go + ge * nrows) : 0) : NEG;

  constexpr int TILE = 32 * S;
  const int ntiles = (ncols + TILE - 1) / TILE;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int c0 = 1 + tile * TILE + lane * S;  // this lane's first column
    const bool live = c0 <= ncols;
    const bool more = tile + 1 < ntiles;
    int h[S], e[S], tc[S];  // H[i-1][c], E[i][c], target base, c = c0 + k
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int c = c0 + k;
      const int base = c <= ncols ? (int)tp[c - 1] : 255;
      tc[k] = base < 4 ? base : 0xFE;  // never equal to a query code
      h[k] = fit ? 0 : -(go + ge * c);
      e[k] = h[k] - goge;
    }
    int hdiag = (fit || c0 == 1) ? 0 : -(go + ge * (c0 - 1));  // H[0][c0-1]
    int h_send = 0, f_send = 0;
    const int lanes = min(32, (ncols - tile * TILE + S - 1) / S);
    const int nsteps = nrows > 0 ? nrows + lanes - 1 : 0;

    for (int s = 0; s < nsteps; ++s) {
      int hl = __shfl_up_sync(FULL, h_send, 1);  // H[i][c0-1]
      int f = __shfl_up_sync(FULL, f_send, 1);   // F[i][c0]
      const int i = s - lane + 1;
      if (live && i >= 1 && i <= nrows) {
        if (lane == 0) {
          if (tile == 0) {
            hl = -(go + ge * i);
            f = hl - goge;
          } else {
            const int2 cv = carry[i];
            hl = cv.x;
            f = cv.y;
          }
        }
        int qi = qs[i - 1];
        qi = qi < 4 ? qi : 0xFF;
        int hd = hdiag;
        hdiag = hl;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const int sub = tc[k] == qi ? match : mismatch;
          const int b = __viaddmax_s32(hd, sub, e[k]);
          const int hn = max(b, f);
          const int og = hn - goge;
          e[k] = __viaddmax_s32(e[k], -ge, og);  // E[i+1][c]
          f = __viaddmax_s32(f, -ge, og);        // F[i][c+1]
          hd = h[k];
          h[k] = hn;
        }
        h_send = h[S - 1];
        f_send = f;
        if (lane == 31 && more) carry[i] = make_int2(h_send, f_send);
      }
    }

    // every live lane has stopped on row nrows: h[] is H[nrows][c]
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int c = c0 + k;
      if (fit ? c <= ncols : c == ncols) best = max(best, h[k]);
    }
    __syncwarp();  // lane 31's carry writes before lane 0's reads
  }

  best = __reduce_max_sync(FULL, best);
  if (lane == 0) out[pair] = best;
}

template <int S>
int launch(const uint8_t* q, const uint8_t* t, const int* qlen,
           const int* tlen, int* out, int B, int Lq, int Lt, int match,
           int mismatch, int go, int ge, int fit, int warps,
           cudaStream_t stream) {
  const int carry_rows = Lt > 32 * S ? Lq + 1 : 0;
  const size_t qbytes = ((size_t)Lq + 7) & ~(size_t)7;
  const size_t smem = (size_t)warps * (8 * (size_t)carry_rows + qbytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_wavefront_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + warps - 1) / warps;
  nw_wavefront_kernel<S><<<blocks, 32 * warps, smem, stream>>>(
      q, t, qlen, tlen, out, B, Lq, Lt, match, mismatch, go, ge, fit,
      carry_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// strip: columns a lane (2, 4, 6, 8, 12 or 16); warps: pairs a block,
// 1..8; go >= 0; B >= 1.  Shared memory a block: warps * (8 * (Lq + 1)
// if Lt > 32 * strip, plus Lq rounded up to 8) bytes.
extern "C" int nw_align_launch(const void* q, const void* t,
                               const void* qlen, const void* tlen, void* out,
                               int B, int Lq, int Lt, int match, int mismatch,
                               int go, int ge, int fit, int strip, int warps,
                               void* stream) {
  if (warps < 1 || warps > MAX_WARPS || go < 0 || B < 1)
    return (int)cudaErrorInvalidValue;
#define NW_CASE(S)                                                          \
  case S:                                                                   \
    return launch<S>((const uint8_t*)q, (const uint8_t*)t,                  \
                     (const int*)qlen, (const int*)tlen, (int*)out, B, Lq,  \
                     Lt, match, mismatch, go, ge, fit, warps,               \
                     (cudaStream_t)stream)
  switch (strip) {
    NW_CASE(2);
    NW_CASE(4);
    NW_CASE(6);
    NW_CASE(8);
    NW_CASE(12);
    NW_CASE(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NW_CASE
}
