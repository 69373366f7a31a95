// GreedyTL's Gram statistic and candidate scoring: the Hopper port of the
// two TPU kernels in src/repro/kernels/greedy_scores/greedy_scores.py,
// `gram` (`_gram_kernel`) and `scores_argmax` (`_scores_kernel`), batched
// over the (location, class) problems that the reference vmaps.
//
// gram: G[b] = Z[b]^T Z[b], Z (B, m, n) fp32 row-major -> G (B, n, n) fp32.
//   What bounds it: operations.  Each output needs m fused multiply-adds
//   and G is symmetric, so the least work is B * m * n * (n + 1) flops on
//   the fp32 CUDA cores, against B * (m * n + n * n) * 4 bytes moved; at
//   the HAPT shapes (B = 252, m = 365, n = 583) that is about 56
//   flops/byte, above the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s =
//   20 flops/byte).
//   Design (simple first): one CTA per 64 x 64 output tile of one batch
//   row, 256 threads as 16 x 16, each thread accumulating a 4 x 4 block
//   (rows ty + 16 r, columns tx + 16 c, so shared-memory reads are free of
//   bank conflicts).  Z is staged 16 rows at a time into shared memory,
//   zero-filled past the ragged edges of m and n, so no padding to block
//   multiples is needed (the TPU version pads in ops.py).  Only tiles on
//   or above the diagonal compute; an off-diagonal tile also writes its
//   mirror, transposed through shared memory so that both stores are
//   coalesced.  Both halves hold the same sums in the same order, so G is
//   bit-symmetric.  Accumulation is in fp32 in row order (fmaf).
//
// scores_argmax: score_j = corr_j^2 / (diag_j + lam), -1e30 on selected
//   columns, and the row's argmax (the lowest index on a tie, NaN counted
//   as the largest value, as torch.argmax and jnp.argmax do).  corr, diag
//   (B, n) fp32, selected (B, n) bool -> scores (B, n) fp32, idx (B,) int32.
//   What bounds it: bytes (13 bytes in, 4 out per element, 3 flops).
//   Design: one CTA per row; each thread scores a strided share of the
//   columns and keeps its best (value, index), then a warp-shuffle and a
//   shared-memory reduction pick the row's argmax in the same launch (the
//   TPU version reduces per-block pairs on the host side of the op).
//   The division is IEEE-rounded (nvcc's default -prec-div=true), so the
//   scores equal the plain version's bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kRows = 16;  // rows of Z staged per step
constexpr int kGramThreads = 256;
constexpr int kScoreThreads = 256;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const float* __restrict__ Z, float* __restrict__ G, int m,
            int n) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (tj < ti) return;  // the lower triangle is the mirror of (tj, ti)
  const float* Zb = Z + static_cast<size_t>(blockIdx.z) * m * n;
  float* Gb = G + static_cast<size_t>(blockIdx.z) * n * n;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  __shared__ float As[kRows][kTile];
  __shared__ float Bs[kRows][kTile];
  __shared__ float Cs[kTile][kTile + 1];

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kRows) {
    for (int e = threadIdx.x; e < kRows * kTile; e += kGramThreads) {
      const int kk = e / kTile, cc = e % kTile;
      const int row = k0 + kk;
      const float* zr = Zb + static_cast<size_t>(row) * n;
      As[kk][cc] = (row < m && i0 + cc < n) ? zr[i0 + cc] : 0.f;
      Bs[kk][cc] = (row < m && j0 + cc < n) ? zr[j0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
      if (i < n && j < n) Gb[static_cast<size_t>(i) * n + j] = acc[r][c];
    }
  if (ti == tj) return;

  // the mirror tile G[j0.., i0..], transposed through shared memory
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Cs[ty + 16 * r][tx + 16 * c] = acc[r][c];
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile; e += kGramThreads) {
    const int rr = e / kTile, cc = e % kTile;
    if (j0 + rr < n && i0 + cc < n)
      Gb[static_cast<size_t>(j0 + rr) * n + i0 + cc] = Cs[cc][rr];
  }
}

// Is (v, i) a better argmax candidate than (bv, bi)?
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kScoreThreads)
scores_argmax_kernel(const float* __restrict__ corr,
                     const float* __restrict__ diag,
                     const uint8_t* __restrict__ selected,
                     float* __restrict__ scores, int* __restrict__ best_idx,
                     int n, float lam) {
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  float best = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kScoreThreads) {
    const float c = corr[off + j];
    const float s = selected[off + j] ? kNegInf : (c * c) / (diag[off + j] + lam);
    scores[off + j] = s;
    if (better(s, j, best, bi)) {
      best = s;
      bi = j;
    }
  }
  warp_argmax(best, bi);

  __shared__ float wv[kScoreThreads / 32];
  __shared__ int wi[kScoreThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wv[warp] = best;
    wi[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kScoreThreads / 32 ? wv[lane] : -CUDART_INF_F;
    bi = lane < kScoreThreads / 32 ? wi[lane] : INT_MAX;
    warp_argmax(best, bi);
    if (lane == 0) best_idx[blockIdx.x] = bi;
  }
}

}  // namespace

// G (B, n, n) = Z^T Z per batch row, Z (B, m, n); fp32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int greedy_gram_launch(const float* Z, float* G, int B, int m,
                                  int n, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  gram_kernel<<<grid, kGramThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Z, G, m, n);
  return cudaGetLastError();
}

// scores (B, n) and idx (B,) from corr, diag (B, n) fp32 and selected
// (B, n) bool; contiguous.  Returns the cudaError_t of the launch.
extern "C" int greedy_scores_argmax_launch(const float* corr,
                                           const float* diag,
                                           const uint8_t* selected,
                                           float* scores, int* idx, int B,
                                           int n, float lam, void* stream) {
  scores_argmax_kernel<<<B, kScoreThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      corr, diag, selected, scores, idx, n, lam);
  return cudaGetLastError();
}

extern "C" const char* greedy_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
