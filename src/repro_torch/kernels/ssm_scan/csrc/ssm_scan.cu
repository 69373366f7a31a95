// Chunked gated-linear-attention scan: the Hopper port of the TPU kernel
// `ssm_scan_bhsd` (`_kernel`) in src/repro/kernels/ssm_scan/ssm_scan.py,
// behind ops.ssm_scan (the no-cache forward of the Mamba2 and RWKV6
// mixers).
//
// What it computes, per (b, h), from a zero (Dk, Dv) fp32 state s:
//   s_t = diag(exp(ld_t)) s_{t-1} + k_t^T v_t
//   y_t = q_t . s_t                                  (Mamba2 mode)
//   y_t = q_t . s_{t-1} + (q_t . (u o k_t)) v_t      (bonus / RWKV6 mode)
// in the TPU kernel's sub-chunked form: the sequence is cut into 16-row
// sub-chunks, each with its own inclusive cumulative sum cum of ld
// (cum_q = cum - ld in bonus mode).  Inside a sub-chunk
//   y_i = sum_{j <= i} (sum_d q_id k_jd exp(cum_q_id - cum_jd)) v_j
//         + (q_i o exp(cum_q_i)) . s                 (j < i in bonus mode,
//                                                     plus the u-bonus)
// and at its end s <- diag(exp(total)) s + sum_j (k_j o exp(total - cum_j))^T
// v_j.  Every exponent is <= 0, so nothing overflows for any decay, and a
// strong decay underflows to 0 (the right limit).  As in the TPU kernel,
// there is no clamp at -30 here (only ops.py's closed-form final state
// clamps).  q, k, v are widened to fp32 on load; y is stored in v's dtype.
//
// What bounds it: on paper, operations.  The recurrence needs about
// 4 * Dk * Dv fp32 flops per token and head (the state update and the
// read), against (3 Dk + 2 Dv) * element bytes moved per token and head;
// at Dk = Dv = 64 in bf16 that is 16384 flops over 640 bytes, about 26
// flops per byte, just above the fp32 ridge (67 TFLOP/s over 3.35 TB/s =
// 20).  In practice it is latency: each CTA walks S / 16 sub-chunks in
// order, with six block-wide barriers per sub-chunk.
//
// Design (simple first):
// - the TPU grid runs the chunk axis in order and keeps s in VMEM.  Blocks
//   here run in no order, so the chunk axis is a loop inside the CTA, and
//   s lives in shared memory for the whole sequence.  (The TPU kernel's
//   64-row chunks only group its sub-chunks; the state passes from one
//   16-row sub-chunk to the next either way, so the loop walks sub-chunks
//   and S need not be a multiple of 64 or 16: rows past S are zero-filled,
//   which adds nothing to y or s.)
// - the Dv columns of s never mix, so a CTA owns (a slice of 32 columns of
//   Dv, h, b) and no reduction across CTAs is needed; this doubles the
//   CTAs (B * H * Dv / 32) over one per (b, h).  The pairwise matrix A of a
//   sub-chunk is recomputed by each column slice.
// - inputs are read through their strides, as given: Mamba2 passes q and k
//   as stride-0 views over heads and ld as a stride-0 view over Dk, with
//   no copy.  When ld's Dk stride is 0 the decay is one scalar per row, so
//   exp(cum_q_i - cum_j) is the same for every d and A takes one exp per
//   (i, j) instead of Dk (the same values, summed in another order).
// - 256 threads: one per entry of the 16 x 16 A; for y, (row, column)
//   pairs; for s, (d, column) pairs.  Rows of the [16][Dk] tiles are padded
//   to Dk + 1 floats, so the 16 rows read at one d hit 16 banks.
// - Dk is a template parameter (32, 64, 128 are built); Dv is any size.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSub = 16;       // rows per sub-chunk (the TPU kernel's SUB)
constexpr int kCols = 32;      // Dv columns per CTA
constexpr int kThreads = 256;  // = kSub * kSub

struct Args {
  const void* q;     // (B, S, H, Dk), strided
  const void* k;     // (B, S, H, Dk), strided
  const void* v;     // (B, S, H, Dv), strided
  const float* ld;   // (B, S, H, Dk), strided, fp32
  const float* u;    // (H, Dk) fp32, contiguous (bonus mode only)
  void* y;           // (B, S, H, Dv), contiguous, v's dtype
  long long sq[4], sk[4], sv[4], sl[4];  // element strides (b, s, h, d)
  int B, S, H, Dv, bonus;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DK>
constexpr int smem_floats() {
  return 6 * kSub * (DK + 1)          // Q, K, CUM, CQ, QE, KC
         + kSub * kCols               // V
         + kSub * (kSub + 1)          // A
         + DK * kCols                 // state
         + 2 * DK;                    // exp(total), u
}

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(Args a) {
  constexpr int P = DK + 1;
  constexpr int AP = kSub + 1;
  extern __shared__ float sm[];
  float* Q = sm;                   // [kSub][P] q
  float* K = Q + kSub * P;         // [kSub][P] k
  float* CUM = K + kSub * P;       // [kSub][P] ld, then its inclusive cumsum
  float* CQ = CUM + kSub * P;      // [kSub][P] query-side cumsum
  float* QE = CQ + kSub * P;       // [kSub][P] q * exp(cum_q)
  float* KC = QE + kSub * P;       // [kSub][P] k * exp(total - cum)
  float* V = KC + kSub * P;        // [kSub][kCols] v (this CTA's columns)
  float* A = V + kSub * kCols;     // [kSub][AP] pairwise weights
  float* ST = A + kSub * AP;       // [DK][kCols] state
  float* ET = ST + DK * kCols;     // [DK] exp(total)
  float* U = ET + DK;              // [DK] bonus

  const int c0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int nc = min(kCols, a.Dv - c0);
  const int S = a.S, tid = threadIdx.x;
  const bool bonus = a.bonus != 0;
  const bool scalar_decay = a.sl[3] == 0;

  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* lg = a.ld + b * a.sl[0] + h * a.sl[2];
  T* yg = static_cast<T*>(a.y)
          + ((static_cast<long long>(b) * S) * a.H + h) * a.Dv + c0;
  const long long y_row = static_cast<long long>(a.H) * a.Dv;

  for (int e = tid; e < DK * kCols; e += kThreads) ST[e] = 0.f;
  if (tid < DK) U[tid] = bonus ? a.u[h * DK + tid] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kSub) {
    __syncthreads();  // the previous sub-chunk is done with every buffer
    for (int e = tid; e < kSub * DK; e += kThreads) {
      const int i = e / DK, d = e % DK, t = t0 + i;
      const bool in = t < S;
      Q[i * P + d] = in ? to_f(qg[t * a.sq[1] + d * a.sq[3]]) : 0.f;
      K[i * P + d] = in ? to_f(kg[t * a.sk[1] + d * a.sk[3]]) : 0.f;
      CUM[i * P + d] = in ? lg[t * a.sl[1] + d * a.sl[3]] : 0.f;
    }
    for (int e = tid; e < kSub * kCols; e += kThreads) {
      const int i = e / kCols, c = e % kCols, t = t0 + i;
      V[i * kCols + c] =
          (t < S && c < nc) ? to_f(vg[t * a.sv[1] + (c0 + c) * a.sv[3]]) : 0.f;
    }
    __syncthreads();

    if (tid < DK) {  // the sub-chunk's own inclusive cumsum, per channel
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float l = CUM[i * P + tid];
        run += l;
        CUM[i * P + tid] = run;
        CQ[i * P + tid] = bonus ? run - l : run;
      }
      ET[tid] = expf(run);
    }
    __syncthreads();

    for (int e = tid; e < kSub * DK; e += kThreads) {
      const int i = e / DK, d = e % DK;
      QE[i * P + d] = Q[i * P + d] * expf(CQ[i * P + d]);
      KC[i * P + d] = K[i * P + d] * expf(CUM[(kSub - 1) * P + d] - CUM[i * P + d]);
    }
    {  // A[i][j]: the pairwise decayed q_i . k_j; bonus: u-term on the diagonal
      const int i = tid / kSub, j = tid % kSub;
      float acc = 0.f;
      if (j < i || (j == i && !bonus)) {
        if (scalar_decay) {
          for (int d = 0; d < DK; ++d) acc = fmaf(Q[i * P + d], K[j * P + d], acc);
          acc *= expf(CQ[i * P] - CUM[j * P]);
        } else {
          for (int d = 0; d < DK; ++d)
            acc += Q[i * P + d] * K[j * P + d] * expf(CQ[i * P + d] - CUM[j * P + d]);
        }
      } else if (j == i) {
        for (int d = 0; d < DK; ++d) acc += Q[i * P + d] * U[d] * K[i * P + d];
      }
      A[i * AP + j] = acc;
    }
    __syncthreads();

    for (int e = tid; e < kSub * kCols; e += kThreads) {
      const int i = e / kCols, c = e % kCols, t = t0 + i;
      float intra = 0.f, inter = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) intra = fmaf(A[i * AP + j], V[j * kCols + c], intra);
#pragma unroll 8
      for (int d = 0; d < DK; ++d) inter = fmaf(QE[i * P + d], ST[d * kCols + c], inter);
      if (t < S && c < nc) put(yg + t * y_row + c, intra + inter);
    }
    __syncthreads();  // y has read the old state

    for (int e = tid; e < DK * kCols; e += kThreads) {
      const int d = e / kCols, c = e % kCols;
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) add = fmaf(KC[j * P + d], V[j * kCols + c], add);
      ST[e] = ST[e] * ET[d] + add;
    }
  }
}

template <typename T, int DK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = ssm_scan_kernel<T, DK>;
  const int smem = smem_floats<DK>() * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
  }
  kern<<<dim3((a.Dv + kCols - 1) / kCols, a.H, a.B), kThreads, smem, stream>>>(a);
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

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and y; ld and u are
// float32).  strides: 16 element strides, (b, s, h, d) of q, k, v, ld in
// that order.  Returns a cudaError_t code (0 on success); the launch is
// checked with cudaGetLastError().
extern "C" int ssm_scan_launch(int dtype, int dk, const void* q, const void* k,
                               const void* v, const float* ld, const float* u,
                               void* y, const long long* strides, int B, int S,
                               int H, int Dv, int bonus, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dv < 1 || (bonus && !u))
    return cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.ld = ld; a.u = u; a.y = y;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
    a.sl[i] = strides[12 + i];
  }
  a.B = B; a.S = S; a.H = H; a.Dv = Dv; a.bonus = bonus;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dk<float>(a, dk, st);
  if (dtype == 1) return launch_dk<__nv_bfloat16>(a, dk, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
