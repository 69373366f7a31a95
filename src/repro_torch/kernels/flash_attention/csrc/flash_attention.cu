// Blockwise causal attention with an online softmax on the CUDA cores, in
// fp32: the fp32 path of ops.flash_attention, a port of the TPU kernel
// `flash_attention_bhsd` (`_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py.  bf16 inputs, the
// no-cache forward's main path, go to the tensor-core kernel in
// flash_attention_tc.cu instead: flash_attention_launch below picks the
// kernel by the inputs' type.
//
// What it computes (per batch row b, query head h, KV head h / g): for each
// query position i, softmax over the admitted keys j of q_i . k_j * scale
// (scale = 1 / sqrt(hd)), times v_j.  Key j is admitted when j < S and
// j <= i (causal), j > i - window (window > 0) and j / chunk == i / chunk
// (chunk > 0).  The arithmetic keeps the TPU kernel's constants and order:
// logits in fp32, masked logits set to -1e30 and their p set to 0, the
// running (m, l, acc) rescaled by exp(m_prev - m_new) per key block, l
// clamped at 1e-30 before the division, and p kept in fp32 for the PV
// product.
//
// What bounds it: operations, at 4 * hd flops per admitted (query, key)
// pair; in fp32 the tensor cores offer only TF32, which would not keep the
// fp32 products, so this kernel runs on the CUDA cores (67 TFLOP/s).  It
// serves chip_smoke.py's fp32 block-parity checks, not the bf16 main path.
//
// Design (simple: fp32 FMA, no tensor cores, no TMA):
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
// - 256 threads as 16 x 16.  Q and K tiles are staged in shared memory
//   transposed ([d][row], rows padded to 68 floats) so that a thread
//   reads its 4 query rows and 4 keys with two float4 loads per d; each
//   thread holds a 4 x 4 block of logits.  Row maxima and sums reduce over
//   the 16 threads of a row with warp shuffles.  p goes to shared memory
//   (transposed) and the V tile replaces the K tile; a thread accumulates
//   its 4 rows x hd/16 columns of the output.
// - head_dim is a template parameter: 64, 80 and 128 are built (the smoke
//   configs, zamba2_2_7b's shared attention, qwen3_0_6b).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per block
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLD = kBQ + 4;       // padded row of a transposed tile
constexpr float kNegInf = -1e30f;

struct Args {
  const float* q;  // (B, S, H, hd)
  const float* k;  // (B, S, KV, hd)
  const float* v;  // (B, S, KV, hd)
  float* o;        // (B, S, H, hd)
  int B, S, H, KV, causal, window, chunk;
  float scale;
};

__device__ __forceinline__ bool admitted(const Args& a, int qp, int kp) {
  bool ok = kp < a.S;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window) ok = ok && kp > qp - a.window;
  if (a.chunk) ok = ok && (kp / a.chunk) == (qp / a.chunk);
  return ok;
}

template <int HD>
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
  const float* qg = a.q + static_cast<size_t>(b) * S * q_row
                    + static_cast<size_t>(h) * HD;
  const float* kg = a.k + static_cast<size_t>(b) * S * kv_row
                    + static_cast<size_t>(kvh) * HD;
  const float* vg = a.v + static_cast<size_t>(b) * S * kv_row
                    + static_cast<size_t>(kvh) * HD;
  float* og = a.o + static_cast<size_t>(b) * S * q_row
              + static_cast<size_t>(h) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD, s = q0 + i;
    Qt[d * kLD + i] = s < S ? qg[s * q_row + d] : 0.f;
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
      KVs[d * kLD + j] = s < S ? kg[s * kv_row + d] : 0.f;
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
      KVs[j * HD + d] = s < S ? vg[s * kv_row + d] : 0.f;
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
      og[s * q_row + tx + 16 * c] = acc[r][c] / lc;
  }
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = flash_kernel<HD>;
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

cudaError_t launch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64>(a, stream);
    case 80: return launch<80>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_tc_launch(int head_dim, const void* q,
                                         const void* k, const void* v,
                                         void* out, int B, int S, int H,
                                         int KV, int causal, int window,
                                         int chunk, float scale,
                                         void* stream);

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and the output).  The
// type picks the kernel: float32 runs the CUDA-core kernel above, bfloat16
// the tensor-core kernel (flash_attention_tc.cu); *variant is set to 0 or
// 1 to say which was launched.  Returns a cudaError_t code (0 on success);
// the launch is checked with cudaGetLastError().
extern "C" int flash_attention_launch(int dtype, int head_dim, const void* q,
                                      const void* k, const void* v, void* out,
                                      int B, int S, int H, int KV, int causal,
                                      int window, int chunk, float scale,
                                      void* stream, int* variant) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  if (dtype == 0) {
    *variant = 0;
    Args a{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(out), B, S, H,
           KV, causal, window, chunk, scale};
    return launch_hd(a, head_dim, static_cast<cudaStream_t>(stream));
  }
  if (dtype == 1) {
    *variant = 1;
    return flash_attention_tc_launch(head_dim, q, k, v, out, B, S, H, KV,
                                     causal, window, chunk, scale, stream);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
