// Blockwise causal attention with an online softmax: the Hopper port of the
// TPU kernel `flash_attention_bhsd` (`_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py, behind
// ops.flash_attention (the no-cache forward's attention).
//
// What it computes (per batch row b, query head h, KV head h / g): for each
// query position i, softmax over the admitted keys j of q_i . k_j * scale
// (scale = 1 / sqrt(hd)), times v_j.  Key j is admitted when j < S and
// j <= i (causal), j > i - window (window > 0) and j / chunk == i / chunk
// (chunk > 0).  The arithmetic keeps the TPU kernel's constants and order:
// logits in fp32, masked logits set to -1e30 and their p set to 0, the
// running (m, l, acc) rescaled by exp(m_prev - m_new) per key block, l
// clamped at 1e-30 before the division, and p kept in fp32 for the PV
// product (q, k, v are widened to fp32 on load; the output is rounded to
// q's dtype once).
//
// What bounds it: operations.  Per (b, h) the causal work is about
// 2 * S^2 * hd flops (QK^T and PV over the lower triangle) against
// (2 * S * hd + 2 * S * hd / g) * bytes moved; at S = 2048, hd = 128 that
// is over 1000 flops per byte, far above the card's ridge.  On the bf16
// tensor cores (989 TFLOP/s) the least time at qwen3_0_6b's prefill
// (B = 2, H = 16, S = 2048) is about 0.035 ms.
//
// Design (simple first: fp32 FMA on the CUDA cores, no tensor cores, no
// TMA; a later PR makes it fast):
// - the TPU grid walks the k blocks as a sequential axis and carries
//   (acc, m, l) in VMEM.  Here one CTA owns one (q block of 64 rows, h, b)
//   and loops over the key blocks itself, keeping (acc, m, l) in
//   registers.  CTAs of the last q blocks, which have the most key blocks
//   under a causal mask, are launched first.
// - the loop runs only over key blocks that hold an admitted key for some
//   row of the q block (from the causal, window and chunk limits).  A
//   skipped block is fully masked for every row and would leave m, l and
//   acc unchanged (m_new = m, alpha = 1, p = 0), so skipping is exact.
// - GQA: the CTA reads K/V of head h / g directly; there is no expanded
//   copy (the JAX wrapper repeats K/V over the query heads).
// - S need not be a multiple of the block: rows >= S are not stored, keys
//   >= S are masked and their K/V rows zero-filled.
// - 256 threads as 16 x 16.  Q and K tiles are staged in shared memory as
//   fp32, transposed ([d][row], rows padded to 68 floats) so that a thread
//   reads its 4 query rows and 4 keys with two float4 loads per d; each
//   thread holds a 4 x 4 block of logits.  Row maxima and sums reduce over
//   the 16 threads of a row with warp shuffles.  p goes to shared memory
//   (transposed) and the V tile replaces the K tile; a thread accumulates
//   its 4 rows x hd/16 columns of the output.
// - head_dim is a template parameter: 64, 80 and 128 are built (the smoke
//   configs, zamba2_2_7b's shared attention, qwen3_0_6b).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per block
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLD = kBQ + 4;       // padded row of a transposed tile
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;   // (B, S, H, hd)
  const void* k;   // (B, S, KV, hd)
  const void* v;   // (B, S, KV, hd)
  void* o;         // (B, S, H, hd)
  int B, S, H, KV, causal, window, chunk;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool admitted(const Args& a, int qp, int kp) {
  bool ok = kp < a.S;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window) ok = ok && kp > qp - a.window;
  if (a.chunk) ok = ok && (kp / a.chunk) == (qp / a.chunk);
  return ok;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(Args a) {
  constexpr int kCols = HD / 16;   // output columns per thread
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                // [HD][kLD]: Q tile, transposed
  float* KVs = Qt + HD * kLD;      // [HD][kLD] K tile transposed; then
                                   // [kBK][HD] V tile
  float* Pt = KVs + HD * kLD;      // [kBK][kLD]: p, transposed

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int S = a.S;
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const size_t q_row = static_cast<size_t>(a.H) * HD;
  const size_t kv_row = static_cast<size_t>(a.KV) * HD;
  const T* qg = static_cast<const T*>(a.q) + static_cast<size_t>(b) * S * q_row
                + static_cast<size_t>(h) * HD;
  const T* kg = static_cast<const T*>(a.k)
                + static_cast<size_t>(b) * S * kv_row
                + static_cast<size_t>(kvh) * HD;
  const T* vg = static_cast<const T*>(a.v)
                + static_cast<size_t>(b) * S * kv_row
                + static_cast<size_t>(kvh) * HD;
  T* og = static_cast<T*>(a.o) + static_cast<size_t>(b) * S * q_row
          + static_cast<size_t>(h) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD, s = q0 + i;
    Qt[d * kLD + i] = s < S ? to_f(qg[s * q_row + d]) : 0.f;
  }

  // the key blocks that can hold an admitted key for some row of the block
  const int q_last = min(q0 + kBQ, S) - 1;
  int lo = 0, hi = S - 1;
  if (a.window) lo = max(lo, q0 - a.window + 1);
  if (a.chunk) {
    lo = max(lo, (q0 / a.chunk) * a.chunk);
    hi = min(hi, (q_last / a.chunk) * a.chunk + a.chunk - 1);
  }
  if (a.causal) hi = min(hi, q_last);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (lo / kBK) * kBK; k0 <= hi; k0 += kBK) {
    __syncthreads();  // Q staged; the last block's PV is done with KVs, Pt
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, s = k0 + j;
      KVs[d * kLD + j] = s < S ? to_f(kg[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kLD + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&KVs[d * kLD + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

    // mask, then the online-softmax update of each of the thread's rows
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = admitted(a, qp, k0 + tx * 4 + c);
        sc[r][c] = ok[c] ? sc[r][c] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = ok[c] ? expf(sc[r][c] - m_new) : 0.f;
        rs += sc[r][c];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading the K tile

#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + c) * kLD + ty * 4]) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, s = k0 + j;
      KVs[j * HD + d] = s < S ? to_f(vg[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&Pt[j * kLD + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = KVs[j * HD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = q0 + ty * 4 + r;
    if (s >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      put(og + s * q_row + tx + 16 * c, acc[r][c] / lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = flash_kernel<T, HD>;
  const int smem = (2 * HD * kLD + kBK * kLD) * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_q = (a.S + kBQ - 1) / kBQ;
  kern<<<dim3(n_q, a.H, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and the output).
// Returns a cudaError_t code (0 on success); the launch is checked with
// cudaGetLastError().
extern "C" int flash_attention_launch(int dtype, int head_dim, const void* q,
                                      const void* k, const void* v, void* out,
                                      int B, int S, int H, int KV, int causal,
                                      int window, int chunk, float scale,
                                      void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  Args a{q, k, v, out, B, S, H, KV, causal, window, chunk, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, head_dim, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, head_dim, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
