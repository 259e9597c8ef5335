// Full-width Gotoh affine-gap alignment score, one (query, target) pair
// per thread block.  CUDA counterpart of the Pallas kernel
// turingassembler_tpu/ops/pallas_align.py (_nw_kernel via
// banded_affine_score); see ops/nw_align.py for the wrapper.
//
// Recurrence, rows i = 1..qlen over the query, columns c = 0..Lt over
// the target (t[c-1] is column c's base):
//   E[i][c] = max(E[i-1][c] - ge, H[i-1][c] - go - ge)
//   b[i][c] = max(H[i-1][c-1] + s(q[i-1], t[c-1]), E[i][c]);
//             b[i][0] = -(go + ge*i)
//   F[i][c] = max_{u<c}(b[i][u] + ge*u) - go - ge*c
//   H[i][c] = max(b[i][c], F[i][c])
// Row 0: H[0][c] = 0 ("fit") or -(go + ge*c), H[0][0] = 0 ("global").
// Columns past Lt are NEG.  "global" returns H[qlen][tlen]; "fit"
// returns max_{c <= tlen} H[qlen][c].  Codes >= 4 always mismatch.
//
// Layout: one thread per target column.  A thread keeps its column's
// H and E of the previous row in registers; the diagonal H[i-1][c-1]
// comes from the left neighbour by warp shuffle (shared memory across
// warps).  The in-row F chain is a block-wide inclusive max-scan of
// b + ge*c: warp shuffles, then each warp folds in the totals of the
// warps to its left.  Two __syncthreads per row.
//
// Targets wider than the block are walked in column tiles, left to
// right; the last column of a tile leaves, per row, its H and the
// running prefix max in shared memory (ping-pong buffers of Lq+1 ints)
// for the next tile's first column.  Rows past qlen and columns past
// tlen never reach the result, so a block stops there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 32;

__global__ void nw_align_kernel(const uint8_t* __restrict__ q,
                                const uint8_t* __restrict__ t,
                                const int* __restrict__ qlen,
                                const int* __restrict__ tlen,
                                int* __restrict__ out,
                                int Lq, int Lt, int match, int mismatch,
                                int go, int ge, int fit) {
  extern __shared__ int carry[];  // [2 buffers][H | prefix max][Lq + 1]
  __shared__ int wtot[MAX_WARPS];
  __shared__ int hlast[MAX_WARPS];
  __shared__ int red[MAX_WARPS];

  const int pair = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int T = blockDim.x;
  const uint8_t* qp = q + (size_t)pair * Lq;
  const uint8_t* tp = t + (size_t)pair * Lt;
  const int ql = qlen[pair];
  const int nrows = min(ql, Lq);
  const int tl = tlen[pair];
  const int ncols = min(tl, Lt) + 1;
  const int ntiles = (ncols + T - 1) / T;
  const int goge = go + ge;
  const int stride = 2 * (Lq + 1);

  int best = NEG;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int c = tile * T + x;
    const bool live = c <= Lt;
    const int tc = (c >= 1 && live) ? (int)tp[c - 1] : 255;
    const bool tc_ok = tc < 4;
    const int gec = ge * c;
    const bool at_col = fit ? (c <= tl) : (c == tl);
    const int* in_h = carry + (tile & 1) * stride;
    const int* in_cm = in_h + (Lq + 1);
    int* out_h = carry + ((tile + 1) & 1) * stride;
    int* out_cm = out_h + (Lq + 1);

    int h = !live ? NEG : (fit || c == 0) ? 0 : -(go + gec);  // row 0
    int e = NEG;
    if (ql == 0 && at_col) best = max(best, h);
    if (lane == 31) hlast[warp] = h;
    if (x == T - 1) out_h[0] = h;
    __syncthreads();

    for (int i = 1; i <= nrows; ++i) {
      const int qi = qp[i - 1];
      int hd = __shfl_up_sync(FULL, h, 1);
      if (lane == 0) {
        hd = warp > 0 ? hlast[warp - 1] : (tile > 0 ? in_h[i - 1] : NEG);
      }
      const int sub = (tc == qi && tc_ok && qi < 4) ? match : mismatch;
      e = max(e - ge, h - goge);
      int b = max(hd + sub, e);
      if (c == 0) b = -(go + ge * i);
      if (!live) b = NEG;

      // inclusive max-scan of b + ge*c along the row
      int v = b + gec;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v = max(v, u);
      }
      if (lane == 31) wtot[warp] = v;
      __syncthreads();
      int pre = tile > 0 ? in_cm[i] : NEG;  // max over columns left of the warp
      for (int w = 0; w < warp; ++w) pre = max(pre, wtot[w]);
      const int incl = max(v, pre);
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = pre;

      h = max(b, excl - go - gec);
      if (!live) h = NEG;
      if (i == ql && at_col) best = max(best, h);
      if (lane == 31) hlast[warp] = h;
      if (x == T - 1) {
        out_h[i] = h;
        out_cm[i] = incl;
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_down_sync(FULL, best, off));
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (x == 0) {
    int m = NEG;
    for (int w = 0; w < T / 32; ++w) m = max(m, red[w]);
    out[pair] = m;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// threads: a multiple of 32, at most 1024.  B >= 1.
extern "C" int nw_align_launch(const void* q, const void* t,
                               const void* qlen, const void* tlen, void* out,
                               int B, int Lq, int Lt, int match, int mismatch,
                               int go, int ge, int fit, int threads,
                               void* stream) {
  const size_t smem = sizeof(int) * 4 * ((size_t)Lq + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nw_align_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlen,
      (const int*)tlen, (int*)out, Lq, Lt, match, mismatch, go, ge, fit);
  return (int)cudaGetLastError();
}
