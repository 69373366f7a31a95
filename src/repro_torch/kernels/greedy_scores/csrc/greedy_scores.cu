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
//   20 flops/byte).  So the FMA pipes must be kept issuing: few other
//   instructions per FMA, and little work outside the upper triangle.
//   Design:
//   - one CTA per 128 x 128 output tile on or above the diagonal, launched
//     as a triangular grid (a 1-D tile index mapped to (ti, tj), ti <= tj,
//     per problem), so no CTA is launched only to return.  The column
//     blocks start with the ragged one (n - (tiles - 1) * 128 wide), so the
//     only tiles with dead rows are those of the first block row, where a
//     warp whose second row chunk lies wholly past the valid rows skips it
//     (the skip is the same for the whole warp, so it saves issue slots).
//   - 256 threads as 16 x 16, each accumulating an 8 x 8 register tile
//     (rows 4 ty .. 4 ty + 3 and 64 + 4 ty .., columns likewise with tx),
//     fed by four 16-byte shared-memory loads per 64 FMAs (the 64 x 64
//     tiles before took eight 4-byte loads per 16), the next row's
//     operands loaded while the current row's products run; a warp's
//     loads are broadcasts (A) or 16 distinct consecutive 16-byte words
//     (B), free of bank conflicts.  At most 128 registers, so two CTAs
//     share an SM.
//   - Z is staged 16 rows a step, kStages - 1 steps ahead of the FMAs,
//     with 4-byte cp.async (a row of n = 583 floats is not 16-byte
//     aligned, and Z is not copied to a padded buffer), zero-filled past
//     the ragged edges of m and n by the copies' source size; each thread
//     copies one column of every other row, its addresses advanced by a
//     pointer step.  A diagonal tile stages its rows once, as both A and
//     B, and skips its lower-left 64 x 64 quadrant, which lies below the
//     diagonal.
//   - the tile goes out through shared memory (stride 129), so that G's
//     rows and, off the diagonal, the transposed mirror are both stored
//     coalesced, in one loop in which each thread stores one column of
//     every other row of both; a diagonal tile's skipped quadrant is
//     stored as the mirror image of its upper-right one.
//   - each output is one fmaf chain over the rows of Z in row order (no
//     split over m, no reassociation), as in the 64 x 64 kernel this
//     replaced, so G keeps its values bit for bit; both halves hold the
//     same sums in the same order (fmaf(a, b, c) = fmaf(b, a, c)), so G is
//     bit-symmetric.
//   tools/gram_tiles.py times other register tiles, depths and steps.
//
// scores_argmax: score_j = corr_j^2 / (diag_j + lam), -1e30 on selected
//   columns, and the row's argmax (the lowest index on a tie, NaN counted
//   as the largest value, as torch.argmax and jnp.argmax do).  corr, diag
//   (B, n) fp32, selected (B, n) bool -> scores (B, n) fp32, idx (B,) int32.
//   What bounds it: by its bytes (13 in, 4 out per element, 3 flops) it
//   would take 0.57 us at the HAPT shape (B = 252, n = 583), but there its
//   1.9 MB sit in L2 or close to it, so the time is latency: the launch and
//   the grid's drain, one round trip to memory, the scores and stores, and
//   the reduction.  Design:
//   - a team of kTeam lanes per problem (32, 64, 128 or 256) and kCols
//     columns a lane per pass (4 or 8), picked by ops.py's scores_plan
//     from B, n and the SM count: as wide as gives each lane two columns
//     and the problems' share of the card allows, problems packed into
//     CTAs only while every SM still gets one.  Lane l owns columns l,
//     l + kTeam, ... and issues a pass's loads of corr, diag and the mask
//     before its first score, so a row costs one round trip a pass.  Few
//     columns a pass keep the unrolled code short: the kernel runs for a
//     couple of microseconds, and a longer body (24 columns a lane) cost
//     more in instruction fetch than its loads in flight saved;
//   - each (score, column) is one 64-bit key whose unsigned order is the
//     argmax's rule, so a lane's best is an integer max with no branch,
//     and a warp's is two redux.sync (score part, then column part); a team
//     of several warps passes its warps' keys through shared memory behind
//     a named barrier of its own warps: no CTA-wide barrier.
//   The division is IEEE-rounded (nvcc's default -prec-div=true), so the
//   scores equal the plain version's bit for bit.  tools/scores_tiles.py
//   sweeps every plan against the kernel this one replaced (one 256-thread
//   CTA per problem), times programmatic dependent launch (measured, and
//   left out: it saved nothing where the kernel before is another one) and
//   other variants, and copies cut short step by step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kTM = 8, kTN = 8;   // a thread's register tile (rows x cols)
constexpr int kRows = 16;         // rows of Z staged per step
constexpr int kStages = 4;        // steps in flight: kStages - 1 ahead
constexpr int kMinBlocks = 2;     // CTAs per SM the registers must allow
constexpr int kGridM = kTile / kTM, kGridN = kTile / kTN;  // thread grid
constexpr int kGramThreads = kGridM * kGridN;
constexpr int kRowStep = kGramThreads / kTile;  // rows one staging pass copies
static_assert(kGramThreads % kTile == 0 && kRows % kRowStep == 0,
              "a staging pass copies whole rows");
constexpr int kRowStride = 4 * kGridM;  // between a thread's 4-row chunks
constexpr int kColStride = 4 * kGridN;  // between its 4-column chunks
constexpr int kCStride = kTile + 1;     // the output tile in shared memory
constexpr int kStageFloats = 2 * kRows * kTile;  // A and B
constexpr size_t kGramSmem =
    (kStages * kStageFloats > kTile * kCStride ? kStages * kStageFloats
                                               : kTile * kCStride) *
    sizeof(float);
constexpr int kScoreCta = 256;  // threads per scores CTA at most
constexpr float kNegInf = -1e30f;

// 4 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read, but must still be an address of the array)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A store of G (tools/gram_tiles.py times a streaming store, __stcs, in its
// place: slower).
__device__ __forceinline__ void store_g(float* p, float v) { *p = v; }

// Does a diagonal tile skip the products of row chunk qr and column chunk
// qc?  Yes where every row of the one lies below every column of the other:
// the store mirrors those entries from above the diagonal.
__host__ __device__ constexpr bool below_diagonal(int qr, int qc) {
  return qr * kRowStride >= (qc + 1) * kColStride;
}

// Row kk of the staged A and B columns this thread multiplies.
__device__ __forceinline__ void load_frag(const float* As, const float* Bs,
                                          int kk, int tx, int ty,
                                          float (&a)[kTM], float (&b)[kTN]) {
#pragma unroll
  for (int q = 0; q < kTM / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(
        As + kk * kTile + q * kRowStride + 4 * ty);
    a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < kTN / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(
        Bs + kk * kTile + q * kColStride + 4 * tx);
    b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
  }
}

// acc += a b^T over one row's operands (entries below the diagonal of a
// diagonal tile, and row chunks past the first without kHiLive, skipped).
template <bool kDiag, bool kHiLive>
__device__ __forceinline__ void gram_fma(const float (&a)[kTM],
                                         const float (&b)[kTN],
                                         float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      if (!(kDiag && below_diagonal(r / 4, c / 4)) && (kHiLive || r < 4))
        acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
}

// One staged step of kRows rows into the kTM x kTN register tile, in row
// order, the next row's operands loaded while this row's products run.
// Without kHiLive the warp's row chunks past the first lie wholly past the
// tile's valid rows and are skipped.
template <bool kDiag, bool kHiLive>
__device__ __forceinline__ void gram_step(const float* As, const float* Bs,
                                          int tx, int ty,
                                          float (&acc)[kTM][kTN]) {
  static_assert(kRows % 2 == 0, "rows go in pairs");
  float a0[kTM], b0[kTN], a1[kTM], b1[kTN];
  load_frag(As, Bs, 0, tx, ty, a0, b0);
#pragma unroll
  for (int kk = 0; kk < kRows; kk += 2) {
    load_frag(As, Bs, kk + 1, tx, ty, a1, b1);
    gram_fma<kDiag, kHiLive>(a0, b0, acc);
    if (kk + 2 < kRows) load_frag(As, Bs, kk + 2, tx, ty, a0, b0);
    gram_fma<kDiag, kHiLive>(a1, b1, acc);
  }
}

__global__ void __launch_bounds__(kGramThreads, kMinBlocks)
gram_kernel(const float* __restrict__ Z, float* __restrict__ G, int m, int n,
            int tiles) {
  // (ti, tj), ti <= tj, from the tile's index in the upper triangle
  int t = blockIdx.x, ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const bool diag = ti == tj;
  const float* Zb = Z + static_cast<size_t>(blockIdx.y) * m * n;
  float* Gb = G + static_cast<size_t>(blockIdx.y) * n * n;
  // column blocks: the ragged one (n - (tiles - 1) * kTile wide) first
  const int rag = n - (tiles - 1) * kTile;
  const int i0 = ti == 0 ? 0 : rag + (ti - 1) * kTile, wi = ti == 0 ? rag : kTile;
  const int j0 = tj == 0 ? 0 : rag + (tj - 1) * kTile, wj = tj == 0 ? rag : kTile;
  const int tid = threadIdx.x, tx = tid % kGridN, ty = tid / kGridN;
  // does any row of this warp's second row chunk lie in the tile?
  const bool hi_live = kRowStride + 4 * ((tid & ~31) / kGridN) < wi;

  // kStages steps of (A, B) staging, then (reused) the output tile
  extern __shared__ __align__(16) float smem[];
  float* const Cs = smem;

  // stage rows k0 .. k0 + kRows - 1 of columns i0.. (A) and j0.. (B):
  // this thread copies column sc of rows sr, sr + kRowStep, ...
  const int sc = tid % kTile, sr = tid / kTile;
  const bool va = sc < wi, vb = sc < wj;
  const float* za = Zb + static_cast<size_t>(sr) * n + (va ? i0 + sc : 0);
  const float* zb = Zb + static_cast<size_t>(sr) * n + (vb ? j0 + sc : 0);
  const size_t step = static_cast<size_t>(kRowStep) * n;
  auto stage = [&](int st, int k0) {
    float* As = smem + st * kStageFloats + sr * kTile + sc;
    float* Bs = As + kRows * kTile;
    const float* pa = za + static_cast<size_t>(k0) * n;
    const float* pb = zb + static_cast<size_t>(k0) * n;
    const bool full = k0 + kRows <= m;  // no row past m in this step
#pragma unroll
    for (int i = 0; i < kRows / kRowStep; ++i) {
      const bool vr = full || k0 + sr + i * kRowStep < m;
      cp_async4(As + i * kRowStep * kTile, vr ? pa : Zb, vr && va);
      if (!diag) cp_async4(Bs + i * kRowStep * kTile, vr ? pb : Zb, vr && vb);
      pa += step;
      pb += step;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;

  const int steps = (m + kRows - 1) / kRows;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) stage(st, st * kRows);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // this step's rows have landed
    __syncthreads();  // ... for every thread; and step s - 1 is consumed
    const int ahead = s + kStages - 1;
    if (ahead < steps) stage(ahead % kStages, ahead * kRows);
    cp_async_commit();
    const float* As = smem + (s % kStages) * kStageFloats;
    const float* Bs = As + kRows * kTile;
    if (diag) {
      if (hi_live) gram_step<true, true>(As, As, tx, ty, acc);
      else gram_step<true, false>(As, As, tx, ty, acc);
    } else {
      if (hi_live) gram_step<false, true>(As, Bs, tx, ty, acc);
      else gram_step<false, false>(As, Bs, tx, ty, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every step consumed before the tile reuses the stages

  // the tile through shared memory: G's rows, then the mirror's
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      Cs[(4 * ty + (r & 3) + kRowStride * (r >> 2)) * kCStride + 4 * tx +
         (c & 3) + kColStride * (c >> 2)] = acc[r][c];
  __syncthreads();
  // each thread stores column ec of every kRowStep-th row, of G's tile and
  // (off the diagonal) of its mirror, both coalesced
  const int ec = tid % kTile;
  float* gu = Gb + static_cast<size_t>(i0 + sr) * n + j0 + ec;
  float* gm = Gb + static_cast<size_t>(j0 + sr) * n + i0 + ec;
  for (int rr = sr; rr < kTile; rr += kRowStep, gu += step, gm += step) {
    if (rr < wi && ec < wj) {
      // a diagonal tile's skipped entries are their mirror images
      const bool mirror =
          diag && below_diagonal(rr / kRowStride, ec / kColStride);
      store_g(gu, mirror ? Cs[ec * kCStride + rr] : Cs[rr * kCStride + ec]);
    }
    if (!diag && rr < wj && ec < wi) store_g(gm, Cs[ec * kCStride + rr]);
  }
}

// A score and its column as one key whose unsigned order is the argmax's:
// the score's bits mapped to an order-preserving integer (-0 taken as +0,
// every NaN as the largest value) above the column's complement (so a tie
// goes to the lowest column).  Key 0 lies below every column's key.
__device__ __forceinline__ unsigned long long argmax_key(float s, int j) {
  unsigned u = __float_as_uint(__fadd_rn(s, 0.f));  // -0 + 0 = +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  if (s != s) u = 0xffffffffu;
  return (static_cast<unsigned long long>(u) << 32) |
         (0xffffffffu - static_cast<unsigned>(j));
}

__device__ __forceinline__ int key_column(unsigned long long key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

// The largest key among a warp's lanes, in every lane: the largest score
// part, then the largest column part among the lanes that hold it (two
// redux.sync; lanes with nothing to give pass key 0).
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, hi == top ? static_cast<unsigned>(k) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

// The warps of one team, and no other, meet here (named barrier 1 + team;
// 0 is __syncthreads').
__device__ __forceinline__ void team_barrier(int team, int lanes) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(lanes) : "memory");
}

template <int kTeam, int kCols>
__global__ void __launch_bounds__(kScoreCta)
scores_argmax_kernel(const float* __restrict__ corr,
                     const float* __restrict__ diag,
                     const uint8_t* __restrict__ selected,
                     float* __restrict__ scores, int* __restrict__ best_idx,
                     int B, int n, float lam) {
  static_assert(kTeam % 32 == 0 && kTeam <= kScoreCta, "whole warps");
  const int team = threadIdx.x / kTeam, lane = threadIdx.x % kTeam;
  const int b = blockIdx.x * (blockDim.x / kTeam) + team;
  if (b >= B) return;  // a whole team leaves: its barrier is its own
  const size_t off = static_cast<size_t>(b) * n;
  const float* cr = corr + off;
  const float* dr = diag + off;
  const uint8_t* sr = selected + off;
  float* out = scores + off;
  unsigned long long best = 0;  // this lane's best key
  for (int j0 = lane; j0 < n; j0 += kTeam * kCols) {
    // 1. the pass's loads, all issued before the first score
    float c[kCols], d[kCols], q[kCols];
    uint8_t m[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int j = j0 + k * kTeam;
      c[k] = j < n ? cr[j] : 1.f;
      d[k] = j < n ? dr[j] : 1.f;
      m[k] = j < n ? sr[j] : 1;
    }
    // 2. the pass's scores
#pragma unroll
    for (int k = 0; k < kCols; ++k) q[k] = (c[k] * c[k]) / (d[k] + lam);
    // 3. stored, and the lane's best
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int j = j0 + k * kTeam;
      if (j < n) {
        const float s = m[k] ? kNegInf : q[k];
        out[j] = s;
        const unsigned long long key = argmax_key(s, j);
        best = key > best ? key : best;
      }
    }
  }
  // 4. the team's argmax
  best = warp_max(best);
  if constexpr (kTeam > 32) {
    constexpr int kWarps = kTeam / 32;
    __shared__ unsigned long long wk[kScoreCta / 32];
    const int w = threadIdx.x / 32;
    if (lane % 32 == 0) wk[w] = best;
    team_barrier(team, kTeam);
    if (lane < 32) best = warp_max(lane < kWarps ? wk[w + lane] : 0);
  }
  if (lane == 0) best_idx[b] = key_column(best);
}

template <int kTeam>
cudaError_t launch_scores(dim3 grid, dim3 block, cudaStream_t stream,
                          int cols, const float* corr, const float* diag,
                          const uint8_t* selected, float* scores, int* idx,
                          int B, int n, float lam) {
  if (cols == 4)
    scores_argmax_kernel<kTeam, 4><<<grid, block, 0, stream>>>(
        corr, diag, selected, scores, idx, B, n, lam);
  else if (cols == 8)
    scores_argmax_kernel<kTeam, 8><<<grid, block, 0, stream>>>(
        corr, diag, selected, scores, idx, B, n, lam);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// G (B, n, n) = Z^T Z per batch row, Z (B, m, n); fp32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int greedy_gram_launch(const float* Z, float* G, int B, int m,
                                  int n, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGramSmem));
  if (attr != cudaSuccess) return attr;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, B);
  gram_kernel<<<grid, kGramThreads, kGramSmem,
                static_cast<cudaStream_t>(stream)>>>(Z, G, m, n, tiles);
  return cudaGetLastError();
}

// scores (B, n) and idx (B,) from corr, diag (B, n) fp32 and selected
// (B, n) bool; contiguous.  The plan (ops.py scores_plan): team, lanes per
// problem (32, 64, 128 or 256); cols, columns a lane loads per pass (4 or
// 8); per_cta, problems per CTA (team * per_cta <= 256).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int greedy_scores_argmax_launch(const float* corr,
                                           const float* diag,
                                           const uint8_t* selected,
                                           float* scores, int* idx, int B,
                                           int n, float lam, int team,
                                           int cols, int per_cta,
                                           void* stream) {
  if (B < 1 || n < 1 || per_cta < 1 || team * per_cta > kScoreCta)
    return cudaErrorInvalidValue;
  const dim3 grid((B + per_cta - 1) / per_cta), block(team * per_cta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (team) {
    case 32:
      return launch_scores<32>(grid, block, st, cols, corr, diag, selected,
                               scores, idx, B, n, lam);
    case 64:
      return launch_scores<64>(grid, block, st, cols, corr, diag, selected,
                               scores, idx, B, n, lam);
    case 128:
      return launch_scores<128>(grid, block, st, cols, corr, diag, selected,
                                scores, idx, B, n, lam);
    case 256:
      return launch_scores<256>(grid, block, st, cols, corr, diag, selected,
                                scores, idx, B, n, lam);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* greedy_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
