// Chunked gated-linear-attention scan: the Hopper port of the TPU kernel
// `ssm_scan_bhsd` (`_kernel`) in src/repro/kernels/ssm_scan/ssm_scan.py,
// behind ops.ssm_scan (the no-cache forward of the Mamba2 and RWKV6
// mixers).
//
// What it computes, per (b, h), from a zero (Dk, Dv) fp32 state s:
//   s_t = diag(exp(ld_t)) s_{t-1} + k_t^T v_t
//   y_t = q_t . s_t                                  (Mamba2 mode)
//   y_t = q_t . s_{t-1} + (q_t . (u o k_t)) v_t      (bonus / RWKV6 mode)
// and the final state s_S.  q, k, v are widened to fp32 on load, every sum
// is fp32, y is stored in v's dtype, the final state in fp32.
//
// What bounds it: on paper, operations.  The recurrence needs about
// 4 * Dk * Dv fp32 flops per token and head (the state update and the
// read); at Dk = Dv = 64 in bf16 that is 16384 flops against 640 bytes of
// q, k, v, ld and y, about 26 flops per byte, just above the fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20).  The TPU kernel walks the sequence in
// order with the state in VMEM; on this card one CTA per (b, h) walking
// 128 sub-chunks in order left the SMs waiting on barriers (the port's
// first kernel: 2.0 ms against a 0.08 ms bound at zamba2's shape).  In
// this one what bounds it in practice is shared memory: each operand a
// thread reads (16 bytes a lane, a broadcast counted in full) feeds 2-4
// FMAs, and the SM returns about 128 bytes a clock to its lanes; the
// counts of tools/scan_chunk_tiles.py's copies fit that within ~30%.
//
// Design: the sequence is cut into chunks of kChunk rows that run in
// parallel, with their states passed between them (three launches on the
// caller's stream; the wrapper counts one call):
// 1. chunk states (grid: chunk x Dv slice, H, B).  For each chunk c,
//    dS_c = sum_j (k_j o exp(total_c - cum_j))^T v_j, a (Dk x C)(C x Dv)
//    product, and g_c = exp(total_c), cum the chunk's inclusive cumsum of
//    ld.  total_c - cum_j is summed directly as the suffix sum of the rows
//    after j (from the chunk's end backwards, a tile of kTile rows at a
//    time, each tile cut into row segments whose sums come first), so it
//    is exact to the rounding of its own magnitude and never a difference
//    of two large sums.  Both go to the wrapper's scratch.
// 2. the pass over chunks (a thread per state entry): S_0 = 0,
//    S_{c+1} = g_c o S_c + dS_c.  S_c overwrites dS_c in the scratch (the
//    state at chunk c's start); the last S is the final state, written to
//    the (B, H, Dk, Dv) output.
// 3. outputs (grid as in 1), from the state at the chunk's start, every
//    exponent <= 0: as in the TPU kernel, 16-row sub-chunks with their own
//    fp32 cumsums of ld (cum - ld on the query side in bonus mode, rounded
//    as the plain version rounds it) and the state passed from one to the
//    next inside the chunk, in tiles of kChRows rows:
//      y_i = sum_{j<=i in i's sub-chunk} A_ij v_j + (q_i o exp(cq_i)) . S
//    with A_ij = sum_d q_id k_jd exp(cq_id - cum_jd) (j < i and the u-term
//    on the diagonal in bonus mode).  The states at every sub-chunk start
//    of a tile are made first (each thread its own state entries, kept in
//    registers), so that y for all the tile's rows is then one
//    register-tiled pass.  With one decay per row (ld's Dk stride 0:
//    Mamba2's broadcast view) A_ij = (q_i . k_j) exp(cq_i - cum_j), one
//    exp per pair.  (A full-chunk pairwise form for that case,
//    (Q K^T) o exp(cum_i - cum_j) over 64 rows, was tried first: right, but
//    its sums run in another order than the per-channel path's, and
//    Mamba2's stride-0 views must give what their contiguous copies give
//    within 1e-5, so both take one schedule.)  The factorised form
//    q o exp(cum) . k o exp(-cum) would overflow fp32 past |cum| ~ 88 and
//    is not used.
// Kernels 1 and 3 stage their next tile's rows into shared memory with
// cp.async while the current tile is computed (two buffers; a 2-byte
// q/k/v is widened to fp32 when its tile starts, an fp32 one is loaded
// then, and ld, fp32, is used where it lands).
// Route: fp32 FMA on the CUDA cores, register-tiled (a thread holds a
// block of each product: (Dk / 16) x 4 of a state, 4 x 4 of y with the
// depth of q . S split between two halves of the CTA, and reads its
// operands as float4 from shared memory, rows padded by 4 floats so that
// no two of a quarter warp's rows share banks).  Simple first: the
// tolerances (fp32: 1e-4 against the plain version) hold with no split of
// the fp32 factors into bf16 terms; the tensor cores (mma.sync on split
// operands) would cut the shared-memory traffic per FMA and are the next
// step.  No device-global mutable state: the scratch belongs to the call,
// so a launch can be captured in a CUDA graph and replayed, and launches
// on several streams do not meet.
// Scratch bytes per call: B * H * ceil(S / kChunk) * Dk * Dv * 4 (dS, then
// S_c), written by 1, read and written by 2, read by 3: at zamba2's shape
// (B=2, S=2048, H=80, Dk=Dv=64) 83.9 MB at kChunk = 64, 41.9 MB at 128,
// 21.0 MB at 256 (shipped; the fastest of tools/scan_chunk_tiles.py's
// sweep, which also times copies that launch fewer of the three kernels
// or skip one step of one).
// Inputs are read through their strides, as given: Mamba2 passes q and k
// as stride-0 views over heads and ld as a stride-0 view over Dk, with no
// copy.  Rows past S are zero-filled and add nothing to y or the state,
// so any S is taken.  Dk is a template parameter (32, 64, 128 are built);
// Dv is any size, kCols columns per CTA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;   // rows per chunk: the unit whose state is passed
constexpr int kTile = 32;     // rows per tile of the chunk-state kernel
constexpr int kChRows = 32;   // rows per tile of the output kernel
constexpr int kSub = 16;      // rows per sub-chunk (the TPU kernel's SUB)
constexpr int kCols = 64;     // Dv columns per CTA
constexpr int kThreads = 256; // a 16 x 16 grid of threads (ti, tj)
constexpr int kTI = kThreads / 16;
constexpr int kPad = 4;       // floats of padding per shared row
constexpr int kPassThreads = 256;
// the kernels a call launches, as bits (1: chunk states, 2: the pass, 4:
// outputs); tools/scan_chunk_tiles.py times copies with fewer
constexpr unsigned kPhases = 7;

static_assert(kChunk % kTile == 0 && kChunk % kChRows == 0, "tiles");

struct Args {
  const void* q;       // (B, S, H, Dk), strided
  const void* k;       // (B, S, H, Dk), strided
  const void* v;       // (B, S, H, Dv), strided
  const float* ld;     // (B, S, H, Dk), strided, fp32
  const float* u;      // (H, Dk) fp32, contiguous (bonus mode only)
  void* y;             // (B, S, H, Dv), contiguous, v's dtype
  float* states;       // (B, H, n_chunks, Dk, Dv): dS_c, then S_c
  float* decay;        // (B, H, n_chunks, Dk): exp(total_c)
  float* final_state;  // (B, H, Dk, Dv)
  long long sq[4], sk[4], sv[4], sl[4];  // element strides (b, s, h, d)
  int B, S, H, Dv, bonus, n_chunks;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// four consecutive values, as fp32 (8 bytes of bf16, 16 of fp32)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(x.x, x.y, y.x, y.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 y = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&x);
  u.y = *reinterpret_cast<const unsigned*>(&y);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// N consecutive floats from shared memory (N = 2, 4 or 8: Dk / 16)
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  static_assert(N == 2 || N % 4 == 0, "Dk / 16 rows");
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = ld4(p + i);
      r[i] = x.x; r[i + 1] = x.y; r[i + 2] = x.z; r[i + 3] = x.w;
    }
  }
}
// acc[r][0..3] += a[r] * b
template <int N>
__device__ __forceinline__ void outer(float (&acc)[N][4], const float (&a)[N],
                                      const float4& b) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    acc[r][0] = fmaf(a[r], b.x, acc[r][0]);
    acc[r][1] = fmaf(a[r], b.y, acc[r][1]);
    acc[r][2] = fmaf(a[r], b.z, acc[r][2]);
    acc[r][3] = fmaf(a[r], b.w, acc[r][3]);
  }
}

// the four columns col .. col + 3 of a row (those at or past nc dropped),
// in one store when the row's start is aligned and all four are in
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int col, int nc,
                                          bool aligned, const float (&x)[4]) {
  if (aligned && col + 4 <= nc) {
    st4(row + col, make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      if (col + cc < nc) put(row + col + cc, x[cc]);
  }
}
// A ROWS x N tile of a strided operand at one (b, h) into dst[i * pitch +
// col], every load of the tile issued before any store (the values wait in
// registers): item e = threadIdx.x + p * kThreads is row e / (N / 4),
// columns 4 * (e % (N / 4)) .. + 3.  Rows at or past S and columns at or
// past nc are 0.  Four columns come in one load (8 bytes of bf16, 16 of
// fp32) when the columns are contiguous and aligned, in one when their
// stride is 0 (ld broadcast over Dk), else one by one.  g points at (b,
// row 0, h, column 0).
template <int ROWS, int N, typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* g,
                                          long long s_row, long long s_col,
                                          int r0, int S, int nc) {
  constexpr int kItems = ROWS * N / 4;
  constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  const bool vec = s_col == 1 && (nc & 3) == 0 && (s_row & 3) == 0
                   && reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
  float4 v[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int i = e / (N / 4), col = 4 * (e % (N / 4)), t = r0 + i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((kItems % kThreads == 0 || e < kItems) && t < S && col < nc) {
      const T* row = g + t * s_row;
      if (vec) {
        x = ld4(row + col);
      } else if (s_col == 0) {
        const float w = to_f(row[0]);
        x = make_float4(w, col + 1 < nc ? w : 0.f, col + 2 < nc ? w : 0.f,
                        col + 3 < nc ? w : 0.f);
      } else {
        x.x = to_f(row[col * s_col]);
        if (col + 1 < nc) x.y = to_f(row[(col + 1) * s_col]);
        if (col + 2 < nc) x.z = to_f(row[(col + 2) * s_col]);
        if (col + 3 < nc) x.w = to_f(row[(col + 3) * s_col]);
      }
    }
    v[p] = x;
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    if (kItems % kThreads == 0 || e < kItems)
      st4(dst + (e / (N / 4)) * pitch + 4 * (e % (N / 4)), v[p]);
  }
}

// cp.async staging: the next tile's rows are copied into shared memory
// while the current tile is computed.  A row-contiguous operand goes 16
// bytes a copy (the last copy of a row zero-filled past nc; rows past S
// copied as zeros, their source not read); ld broadcast over Dk goes one
// 4-byte value per row.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// whether an operand's rows can be staged 16 bytes a copy
template <typename T>
__device__ __forceinline__ bool stageable(const T* g, long long s_row,
                                          long long s_col) {
  return s_col == 1 && (s_row * static_cast<long long>(sizeof(T))) % 16 == 0
         && reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

// rows [r0, r0 + ROWS) of a stageable operand (columns [0, N), those at or
// past nc zero-filled) into dst[i * pitch + col]
template <int ROWS, int N, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* g,
                                           long long s_row, int r0, int S,
                                           int nc) {
  constexpr int CH = 16 / static_cast<int>(sizeof(T)), PER_ROW = N / CH;
  constexpr int ITEMS = ROWS * PER_ROW;
#pragma unroll
  for (int e0 = 0; e0 < ITEMS; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    if (ITEMS % kThreads == 0 || e < ITEMS) {
      const int i = e / PER_ROW, col = CH * (e % PER_ROW), t = r0 + i;
      const int n = t < S && col < nc
                        ? min(CH, nc - col) * static_cast<int>(sizeof(T)) : 0;
      cp_async16(dst + i * pitch + col, n ? g + t * s_row + col : g, n);
    }
  }
}

// one value per row of ld broadcast over Dk into dst[i * pitch]
__device__ __forceinline__ void stage_rows_bcast(float* dst, int pitch,
                                                 const float* g,
                                                 long long s_row, int r0,
                                                 int rows, int S) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int t = r0 + i;
    cp_async4(dst + i * pitch, t < S ? g + t * s_row : g, t < S ? 4 : 0);
  }
}

// a staged ROWS x N tile of T (pitch N) widened to fp32 (pitch `pitch`)
template <int ROWS, int N, typename T>
__device__ __forceinline__ void widen_rows(float* dst, int pitch,
                                           const T* src) {
  constexpr int ITEMS = ROWS * N / 4;
#pragma unroll
  for (int e0 = 0; e0 < ITEMS; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    if (ITEMS % kThreads == 0 || e < ITEMS) {
      const int i = e / (N / 4), col = 4 * (e % (N / 4));
      st4(dst + i * pitch + col, ld4(src + i * N + col));
    }
  }
}

__device__ __forceinline__ long long bh_index(const Args& a, int b, int h) {
  return static_cast<long long>(b) * a.H + h;
}

// ---------------------------------------------------------------- 1. dS_c

// q, k, v of 2-byte types go through raw staging buffers (widened to fp32
// when a tile starts); fp32 ones are loaded when their tile starts (their
// staging buffers would not fit beside the work arrays at Dk = 128)
template <typename T>
constexpr bool kRawStaged = sizeof(T) == 2;

template <typename T, int DK>
constexpr int state_smem_bytes() {
  constexpr int raw = kRawStaged<T> ? kTile * (DK + kCols) : 0;
  return 4 * (kTile * (DK + kPad) + kTile * (kCols + kPad) + DK + kThreads
              + 2 * kTile * (DK + kPad))
         + 2 * raw * static_cast<int>(sizeof(T));
}

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(Args a) {
  constexpr int P = DK + kPad, PV = kCols + kPad, RD = DK / kTI;
  constexpr int RAW = kRawStaged<T> ? kTile * (DK + kCols) : 0;
  extern __shared__ float4 smem4[];
  float* K = reinterpret_cast<float*>(smem4);  // [kTile][P] k, then k o w
  float* V = K + kTile * P;                    // [kTile][PV]
  float* SUF = V + kTile * PV;  // [DK] ld summed over the chunk's later rows
  float* SEG = SUF + DK;        // [kThreads] ld summed over a row segment
  float* LDB = SEG + kThreads;  // [2][kTile][P] ld, staged
  T* RAWB = reinterpret_cast<T*>(LDB + 2 * kTile * P);  // [2][RAW] k, v

  const int n_sl = (a.Dv + kCols - 1) / kCols;
  const int c = blockIdx.x / n_sl, c0 = (blockIdx.x % n_sl) * kCols;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16, nc = min(kCols, a.Dv - c0);
  const int row0 = c * kChunk, S = a.S;
  const int n_tiles = (min(kChunk, S - row0) + kTile - 1) / kTile;
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2]
                + c0 * a.sv[3];
  const float* lg = a.ld + b * a.sl[0] + h * a.sl[2];
  const bool scalar = a.sl[3] == 0;  // one decay per row, in column 0
  const int dl = scalar ? 0 : 1;
  const bool k_async = kRawStaged<T> && stageable(kg, a.sk[1], a.sk[3]);
  const bool v_async = kRawStaged<T> && stageable(vg, a.sv[1], a.sv[3]);
  const bool l_async = scalar || stageable(lg, a.sl[1], a.sl[3]);
  // the suffix sums: thread (d, seg) walks kTile / kSegs rows of channel d
  constexpr int kSegs = kThreads / DK, kSegRows = kTile / kSegs;
  const int d = tid % DK, seg = tid / DK;

  auto stage = [&](int t) {  // tile t's copies, into buffer t & 1
    const int r0 = row0 + t * kTile;
    T* raw = RAWB + (t & 1) * RAW;
    if (k_async) stage_rows<kTile, DK>(raw, DK, kg, a.sk[1], r0, S, DK);
    if (v_async)
      stage_rows<kTile, kCols>(raw + kTile * DK, kCols, vg, a.sv[1], r0, S,
                               nc);
    float* l = LDB + (t & 1) * kTile * P;
    if (l_async) {
      if (scalar)
        stage_rows_bcast(l, P, lg, a.sl[1], r0, kTile, S);
      else
        stage_rows<kTile, DK>(l, P, lg, a.sl[1], r0, S, DK);
    }
    cp_async_commit();
  };

  float acc[RD][4];
#pragma unroll
  for (int r = 0; r < RD; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  if (tid < DK) SUF[tid] = 0.f;
  stage(n_tiles - 1);
  for (int t = n_tiles - 1; t >= 0; --t) {  // from the chunk's end back
    const int r0 = row0 + t * kTile;
    const T* raw = RAWB + (t & 1) * RAW;
    float* L = LDB + (t & 1) * kTile * P;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; the previous tile is done with K, V
    if (t > 0) stage(t - 1);  // lands while this tile is computed
    if (k_async) widen_rows<kTile, DK>(K, P, raw);
    else load_rows<kTile, DK>(K, P, kg, a.sk[1], a.sk[3], r0, S, DK);
    if (v_async) widen_rows<kTile, kCols>(V, PV, raw + kTile * DK);
    else load_rows<kTile, kCols>(V, PV, vg, a.sv[1], a.sv[3], r0, S, nc);
    if (!l_async) load_rows<kTile, DK>(L, P, lg, a.sl[1], a.sl[3], r0, S, DK);
    __syncthreads();
    // w_j = exp(sum of ld over the chunk's rows after j) <= 1: each
    // segment's sum first, then each thread walks its rows from the end
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kSegRows; ++i) s += L[(seg * kSegRows + i) * P + d * dl];
    SEG[seg * DK + d] = s;
    __syncthreads();
    s = SUF[d];
    for (int g = kSegs - 1; g > seg; --g) s += SEG[g * DK + d];
    float l[kSegRows], w[kSegRows];
#pragma unroll
    for (int i = 0; i < kSegRows; ++i) l[i] = L[(seg * kSegRows + i) * P + d * dl];
#pragma unroll
    for (int i = kSegRows - 1; i >= 0; --i) {
      w[i] = __expf(s);
      s += l[i];
    }
#pragma unroll
    for (int i = 0; i < kSegRows; ++i) K[(seg * kSegRows + i) * P + d] *= w[i];
    __syncthreads();  // every thread has read SUF
    if (seg == 0) SUF[d] = s;  // the sum over this tile's rows and after
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kk[RD];
      lds<RD>(kk, K + j * P + ti * RD);
      outer<RD>(acc, kk, ld4(V + j * PV + 4 * tj));
    }
  }
  const long long chunk = bh_index(a, b, h) * a.n_chunks + c;
  float* out = a.states + chunk * DK * a.Dv + c0;
  const bool aligned = (a.Dv & 3) == 0;
#pragma unroll
  for (int r = 0; r < RD; ++r)
    store_cols(out + (ti * RD + r) * a.Dv, 4 * tj, nc, aligned, acc[r]);
  if (c0 == 0 && tid < DK) a.decay[chunk * DK + tid] = expf(SUF[tid]);
}

// ------------------------------------------------------- 2. pass over chunks

__global__ void __launch_bounds__(kPassThreads)
pass_kernel(float* states, const float* decay, float* final_state,
            long long n_entries, int DK, int Dv, int n_chunks) {
  constexpr int kBatch = 8;  // chunks whose loads are in flight at once
  const long long e = blockIdx.x * static_cast<long long>(kPassThreads)
                      + threadIdx.x;
  if (e >= n_entries) return;
  const long long per_bh = static_cast<long long>(DK) * Dv;
  const long long bh = e / per_bh;
  const int de = static_cast<int>(e % per_bh), d = de / Dv;
  float* p = states + bh * n_chunks * per_bh + de;
  const float* g = decay + bh * n_chunks * DK + d;
  float s = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float dl[kBatch], gg[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u < n_chunks) {
        dl[u] = p[(c0 + u) * per_bh];
        gg[u] = g[(c0 + u) * DK];
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u < n_chunks) {
        p[(c0 + u) * per_bh] = s;  // the state at chunk c0 + u's start
        s = fmaf(gg[u], s, dl[u]);
      }
  }
  final_state[e] = s;
}

// ------------------------------------------------------------- 3. outputs

template <typename T, int DK>
constexpr int output_smem_bytes() {
  constexpr int G = kChRows / kSub, P = (DK > kCols ? DK : kCols) + kPad;
  constexpr int raw = kRawStaged<T> ? kChRows * (2 * DK + kCols) : 0;
  return 4 * (2 * kChRows * P + kChRows * (kCols + kPad)
              + G * DK * (kCols + kPad) + kChRows * (kSub + kPad) + G * DK
              + DK + 2 * kChRows * P)
         + 2 * raw * static_cast<int>(sizeof(T));
}

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads, 2) output_kernel(Args a) {
  constexpr int R = kChRows, G = R / kSub;
  // rows of q, k and ld at least kCols wide: y's second half hands its
  // partial sums over through K's buffer
  constexpr int P = (DK > kCols ? DK : kCols) + kPad;
  constexpr int PV = kCols + kPad, PA = kSub + kPad;
  constexpr int RD = DK / kTI, YR = R / (kTI / 2);
  constexpr int RAW = kRawStaged<T> ? R * (2 * DK + kCols) : 0;
  static_assert(kThreads == kSub * kSub, "a thread per (i, j) of A");
  static_assert(kSub % (2 * YR) == 0, "a warp's y rows lie in one sub-chunk");
  static_assert(G >= 2 && R * P <= (G - 1) * DK * PV, "CQ fits in ST[1..]");
  extern __shared__ float4 smem4[];
  float* Q = reinterpret_cast<float*>(smem4);  // [R][P] q, then q o exp(cum_q)
  float* K = Q + R * P;          // [R][P] k, then k o exp(total - cum)
  float* V = K + R * P;          // [R][PV]
  float* ST = V + R * PV;        // [G][DK][PV] state at each sub-chunk start
  float* A = ST + G * DK * PV;   // [R][PA] pairwise weights in sub-chunks
  float* E = A + R * PA;         // [G][DK] exp(total) per sub-chunk
  float* U = E + G * DK;         // [DK]
  // [2][R][P] ld staged, then (in place) its cumsum per sub-chunk; with one
  // decay per row only column 0 is used
  float* LDB = U + DK;
  T* RAWB = reinterpret_cast<T*>(LDB + 2 * R * P);  // [2][RAW] q, k, v

  const int n_sl = (a.Dv + kCols - 1) / kCols;
  const int c = blockIdx.x / n_sl, c0 = (blockIdx.x % n_sl) * kCols;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int nc = min(kCols, a.Dv - c0), S = a.S;
  const bool bonus = a.bonus != 0;
  const bool scalar = a.sl[3] == 0;  // one decay per row, for every channel
  const int dl = scalar ? 0 : 1;     // the column of ld that channel d reads
  const int row0 = c * kChunk;
  const int n_tiles = (min(kChunk, S - row0) + R - 1) / R;
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2]
                + c0 * a.sv[3];
  const float* lg = a.ld + b * a.sl[0] + h * a.sl[2];
  T* yg = static_cast<T*>(a.y)
          + (static_cast<long long>(b) * S * a.H + h) * a.Dv + c0;
  const long long y_row = static_cast<long long>(a.H) * a.Dv;
  const bool y_aligned = (a.Dv & 3) == 0;  // y is contiguous, 16-byte aligned
  const long long chunk = bh_index(a, b, h) * a.n_chunks + c;
  const bool q_async = kRawStaged<T> && stageable(qg, a.sq[1], a.sq[3]);
  const bool k_async = kRawStaged<T> && stageable(kg, a.sk[1], a.sk[3]);
  const bool v_async = kRawStaged<T> && stageable(vg, a.sv[1], a.sv[3]);
  const bool l_async = scalar || stageable(lg, a.sl[1], a.sl[3]);

  auto stage = [&](int t) {  // tile t's copies, into buffer t & 1
    const int r0 = row0 + t * R;
    T* raw = RAWB + (t & 1) * RAW;
    if (q_async) stage_rows<R, DK>(raw, DK, qg, a.sq[1], r0, S, DK);
    if (k_async) stage_rows<R, DK>(raw + R * DK, DK, kg, a.sk[1], r0, S, DK);
    if (v_async)
      stage_rows<R, kCols>(raw + 2 * R * DK, kCols, vg, a.sv[1], r0, S, nc);
    float* l = LDB + (t & 1) * R * P;
    if (l_async) {
      if (scalar)
        stage_rows_bcast(l, P, lg, a.sl[1], r0, R, S);
      else
        stage_rows<R, DK>(l, P, lg, a.sl[1], r0, S, DK);
    }
    cp_async_commit();
  };

  stage(0);
  // the state at the chunk's start
  load_rows<DK, kCols>(ST, PV, a.states + chunk * DK * a.Dv + c0, a.Dv, 1, 0,
                       DK, nc);
  if (tid < DK) U[tid] = bonus ? a.u[h * DK + tid] : 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = row0 + t * R;
    const bool carry = t + 1 < n_tiles;
    const T* raw = RAWB + (t & 1) * RAW;
    float* CUM = LDB + (t & 1) * R * P;
    float sr[RD][4];  // this thread's entries of the state, then the carry
    // [R][P] the query-side cumsum: cum - ld in bonus mode (rounded as the
    // plain version rounds it), kept in ST[1..]'s space until the states
    // are made; the cumsum itself in Mamba2 mode
    float* CQ = bonus ? ST + DK * PV : CUM;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; the previous tile is done with all
    if (carry) stage(t + 1);  // lands while this tile is computed
    if (q_async) widen_rows<R, DK>(Q, P, raw);
    else load_rows<R, DK>(Q, P, qg, a.sq[1], a.sq[3], r0, S, DK);
    if (k_async) widen_rows<R, DK>(K, P, raw + R * DK);
    else load_rows<R, DK>(K, P, kg, a.sk[1], a.sk[3], r0, S, DK);
    if (v_async) widen_rows<R, kCols>(V, PV, raw + 2 * R * DK);
    else load_rows<R, kCols>(V, PV, vg, a.sv[1], a.sv[3], r0, S, nc);
    if (!l_async) load_rows<R, DK>(CUM, P, lg, a.sl[1], a.sl[3], r0, S, DK);
    __syncthreads();

    // each sub-chunk's own inclusive cumsum of ld, per channel (one decay
    // per row: column 0 only, its exp for every channel)
    for (int e = tid; e < DK * G; e += kThreads) {
      const int d = e % DK, s = e / DK;
      if (scalar && d > 0) continue;
      float l[kSub], run = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) l[i] = CUM[(s * kSub + i) * P + d];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int o = (s * kSub + i) * P + d;
        run += l[i];
        CUM[o] = run;
        if (bonus) CQ[o] = run - l[i];
      }
      const float ex = __expf(run);
      if (scalar)
        for (int dd = 0; dd < DK; dd += 4)
          st4(E + s * DK + dd, make_float4(ex, ex, ex, ex));
      else
        E[s * DK + d] = ex;
    }
    __syncthreads();

    // A[i][j], j <= i, of each sub-chunk: sum_d q_id k_jd exp(cq_id -
    // cum_jd), with u_d in place of the exp on the bonus mode's diagonal
    // (and j < i otherwise there); with one decay per row (q_i . k_j)
    // exp(cq_i - cum_j), one exp per pair.  Thread (i, j) = (tid / 16,
    // tid % 16) takes the entry of every sub-chunk, side by side; above
    // the diagonal it computes one too, with its exponents capped at 0 (no
    // inf), and stores 0 (all eight warps busy measured faster than the
    // lower triangle's entries alone on fewer threads).
    {
      const int i = tid / kSub, j = tid % kSub;
      const bool ub = bonus && j == i;
      const float cap = j <= i ? __int_as_float(0x7f800000) : 0.f;
#pragma unroll
      for (int s = 0; s < G; ++s) {
        const int ri = s * kSub + i, rj = s * kSub + j;
        const float* qi = Q + ri * P;
        const float* kj = K + rj * P;
        float acc = 0.f;
        if (scalar) {
#pragma unroll 4
          for (int d0 = 0; d0 < DK; d0 += 4) {
            const float4 q4 = ld4(qi + d0), k4 = ld4(kj + d0);
            const float4 m = ub ? ld4(U + d0) : make_float4(1.f, 1.f, 1.f, 1.f);
            acc += q4.x * k4.x * m.x + q4.y * k4.y * m.y + q4.z * k4.z * m.z
                   + q4.w * k4.w * m.w;
          }
          if (!ub) acc *= __expf(fminf(CQ[ri * P] - CUM[rj * P], cap));
        } else {
          const float* ci = CQ + ri * P;
          const float* cj = CUM + rj * P;
#pragma unroll 4
          for (int d0 = 0; d0 < DK; d0 += 4) {
            const float4 q4 = ld4(qi + d0), k4 = ld4(kj + d0);
            const float4 x4 = ld4(ci + d0), c4 = ld4(cj + d0);
            float4 m = make_float4(__expf(fminf(x4.x - c4.x, cap)),
                                   __expf(fminf(x4.y - c4.y, cap)),
                                   __expf(fminf(x4.z - c4.z, cap)),
                                   __expf(fminf(x4.w - c4.w, cap)));
            if (ub) m = ld4(U + d0);
            acc += q4.x * k4.x * m.x + q4.y * k4.y * m.y + q4.z * k4.z * m.z
                   + q4.w * k4.w * m.w;
          }
        }
        A[ri * PA + j] = j <= i ? acc : 0.f;
      }
    }
    __syncthreads();

    for (int e = tid; e < R * DK; e += kThreads) {  // in place: the factors
      const int i = e / DK, d = e % DK, il = i % kSub;
      const float cum = CUM[i * P + d * dl];
      const float tot = CUM[(i - il + kSub - 1) * P + d * dl];
      Q[i * P + d] *= __expf(CQ[i * P + d * dl]);
      K[i * P + d] *= __expf(tot - cum);
    }
    __syncthreads();

    // the states at sub-chunks 1 .. G-1 (and the carry into the next
    // tile): each thread its own entries, rows RD*ti .., columns 4*tj ..
#pragma unroll
    for (int r = 0; r < RD; ++r) {
      const float4 s4 = ld4(ST + (RD * ti + r) * PV + 4 * tj);
      sr[r][0] = s4.x; sr[r][1] = s4.y; sr[r][2] = s4.z; sr[r][3] = s4.w;
    }
    for (int s = 1; s <= G; ++s) {
      if (s == G && !carry) break;
      const float* Ks = K + (s - 1) * kSub * P;
      const float* Vs = V + (s - 1) * kSub * PV;
      float e[RD];
      lds<RD>(e, E + (s - 1) * DK + RD * ti);
#pragma unroll
      for (int r = 0; r < RD; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) sr[r][cc] *= e[r];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float kk[RD];
        lds<RD>(kk, Ks + j * P + RD * ti);
        outer<RD>(sr, kk, ld4(Vs + j * PV + 4 * tj));
      }
      if (s < G)
#pragma unroll
        for (int r = 0; r < RD; ++r)
          st4(ST + (s * DK + RD * ti + r) * PV + 4 * tj,
              make_float4(sr[r][0], sr[r][1], sr[r][2], sr[r][3]));
    }
    __syncthreads();

    // y: thread (half, yi, tj) holds the YR x 4 block of rows
    // YR*yi .. and columns 4*tj ..; half 0 sums A @ V and the first half of
    // (q o exp(cum_q)) @ S over d, half 1 the second half, which it hands
    // over through K's buffer (the states are made: K is read)
    {
      const int half = tid / (kThreads / 2), t2 = tid % (kThreads / 2);
      const int yi = t2 / 16, row = YR * yi, ysub = row / kSub;
      const int last_local = (2 * YR * (t2 / 32 + 1) - 1) % kSub;
      float acc[YR][4];
#pragma unroll
      for (int r = 0; r < YR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      if (half == 0) {
        const float* Vs = V + ysub * kSub * PV;
        for (int j0 = 0; j0 <= last_local; j0 += 4) {
          float4 ar[YR];
#pragma unroll
          for (int r = 0; r < YR; ++r) ar[r] = ld4(A + (row + r) * PA + j0);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 vv = ld4(Vs + (j0 + u) * PV + 4 * tj);
            float x[YR];
#pragma unroll
            for (int r = 0; r < YR; ++r) x[r] = at(ar[r], u);
            outer<YR>(acc, x, vv);
          }
        }
      }
      const float* Ss = ST + ysub * DK * PV;
      const int d_lo = half * (DK / 2);
#pragma unroll 2
      for (int d0 = d_lo; d0 < d_lo + DK / 2; d0 += 4) {
        float4 qr[YR];
#pragma unroll
        for (int r = 0; r < YR; ++r) qr[r] = ld4(Q + (row + r) * P + d0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 ss = ld4(Ss + (d0 + u) * PV + 4 * tj);
          float x[YR];
#pragma unroll
          for (int r = 0; r < YR; ++r) x[r] = at(qr[r], u);
          outer<YR>(acc, x, ss);
        }
      }
      float* PART = K;
      if (half == 1)
#pragma unroll
        for (int r = 0; r < YR; ++r)
          st4(PART + (row + r) * P + 4 * tj,
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      __syncthreads();
      if (half == 0)
#pragma unroll
        for (int r = 0; r < YR; ++r) {
          const float4 o = ld4(PART + (row + r) * P + 4 * tj);
          acc[r][0] += o.x; acc[r][1] += o.y; acc[r][2] += o.z; acc[r][3] += o.w;
          const int tr = r0 + row + r;
          if (tr < S) store_cols(yg + tr * y_row, 4 * tj, nc, y_aligned, acc[r]);
        }
    }
    if (carry) {
      __syncthreads();  // every thread has read ST[0] for its y
#pragma unroll
      for (int r = 0; r < RD; ++r)
        st4(ST + (RD * ti + r) * PV + 4 * tj,
            make_float4(sr[r][0], sr[r][1], sr[r][2], sr[r][3]));
    }
  }
}

// ------------------------------------------------------------------ host

template <typename K>
cudaError_t allow_smem(K kern, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T, int DK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool set_state = false, set_output = false;
  const int b_state = state_smem_bytes<T, DK>();
  const int b_output = output_smem_bytes<T, DK>();
  cudaError_t e;
  if ((e = allow_smem(chunk_state_kernel<T, DK>, b_state, set_state))) return e;
  if ((e = allow_smem(output_kernel<T, DK>, b_output, set_output))) return e;
  const dim3 grid(a.n_chunks * ((a.Dv + kCols - 1) / kCols), a.H, a.B);
  if (kPhases & 1) {
    chunk_state_kernel<T, DK><<<grid, kThreads, b_state, stream>>>(a);
    if ((e = cudaGetLastError())) return e;
  }
  if (kPhases & 2) {
    const long long n = static_cast<long long>(a.B) * a.H * DK * a.Dv;
    pass_kernel<<<static_cast<unsigned>((n + kPassThreads - 1) / kPassThreads),
                  kPassThreads, 0, stream>>>(a.states, a.decay, a.final_state,
                                             n, DK, a.Dv, a.n_chunks);
    if ((e = cudaGetLastError())) return e;
  }
  if (kPhases & 4)
    output_kernel<T, DK><<<grid, kThreads, b_output, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dk(const Args& a, int dk, cudaStream_t stream) {
  switch (dk) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Rows per chunk (the wrapper sizes the scratch with it) and the device
// kernels one call launches.
extern "C" int ssm_scan_chunk_rows(void) { return kChunk; }
extern "C" int ssm_scan_device_kernels(void) {
  return (kPhases & 1) + ((kPhases >> 1) & 1) + ((kPhases >> 2) & 1);
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and y; ld and u are
// float32).  strides: 16 element strides, (b, s, h, d) of q, k, v, ld in
// that order.  states: B * H * ceil(S / chunk rows) * dk * Dv floats of
// scratch, decay: B * H * ceil(S / chunk rows) * dk; final_state: (B, H,
// dk, Dv) fp32, written.  Returns a cudaError_t code (0 on success); each
// launch is checked with cudaGetLastError().
extern "C" int ssm_scan_launch(int dtype, int dk, const void* q, const void* k,
                               const void* v, const float* ld, const float* u,
                               void* y, float* states, float* decay,
                               float* final_state, const long long* strides,
                               int B, int S, int H, int Dv, int bonus,
                               void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dv < 1 || (bonus && !u) || !states
      || !decay || !final_state)
    return cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.ld = ld; a.u = u; a.y = y;
  a.states = states; a.decay = decay; a.final_state = final_state;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
    a.sl[i] = strides[12 + i];
  }
  a.B = B; a.S = S; a.H = H; a.Dv = Dv; a.bonus = bonus;
  a.n_chunks = (S + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dk<float>(a, dk, st);
  if (dtype == 1) return launch_dk<__nv_bfloat16>(a, dk, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
