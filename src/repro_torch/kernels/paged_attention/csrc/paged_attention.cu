// Paged attention with the new rows' K/V scatter fused in: the Hopper port
// of the TPU kernel `paged_attention_grouped` (`_kernel`) in
// src/repro/kernels/paged_attention/paged_attention.py, behind
// ops.paged_attention_update / ops.paged_attention.
//
// What it computes (per slot b, KV head kv): the S new K/V rows of the
// slot are written into their block-table-addressed page rows (ring slot
// (last - S + 1 + s) mod T, cast to the pool dtype); then the S*g query
// rows of the GQA group (row r = token r / g, query head kv*g + r % g)
// attend over the slot's logical ring of T = P * page_size entries, read
// page by page through the block table, with an fp32 online softmax.  A
// ring entry counts only when the absolute position it holds,
// k_pos = last - ((last - ring) mod T), satisfies k_pos >= 0, ring < T,
// k_pos <= q_pos[row / g] and, with a window, k_pos > q_pos - window.
//
// What bounds it: bytes.  Each attended pool page is read once per CTA
// (page_size * hd * 2 pool elements for K and V) against ~4 flops per
// element per query row; with S*g <= 32 rows that is far below the H100's
// ~295 flop/byte ridge, so the least time is the pool bytes read over
// 3.35 TB/s.
//
// Design (simple first; a later PR makes it fast):
// - one CTA per (kv, b), 8 warps.  A warp carries up to 4 query rows in
//   registers (hd / 32 fp32 values per lane for q and the accumulator);
//   blocks of more than 32 rows run in passes, each pass re-streaming the
//   pages.
// - scatter first, then __syncthreads(), then attend.  This is safe with
//   one CTA per (b, kv) only because of the copy-on-write contract: every
//   page written in a tick is private to one slot (scheduler.py
//   `ensure_private`, and the write/read contract in the TPU kernel's
//   docstring), so no CTA reads a page that another CTA writes — except the
//   null page 0.  A later split over pages (split-K for decode) must move
//   the scatter into its own pass first.
// - the null page 0 is written concurrently by every idle lane, so it
//   holds racy garbage.  Masked entries are removed by SELECTION: an
//   invalid key is never scored and its V row never enters the sum (no
//   multiply-by-zero that would turn a garbage inf into NaN).  A page none
//   of whose entries can count for the pass's rows is not loaded at all.
// - pages are staged in shared memory as fp32 (2 * page_size * hd * 4
//   bytes).  Each key is scored by one warp: a lane-parallel partial dot
//   over hd / 32 elements and a butterfly reduction; keys are taken 16 at a
//   time per online-softmax rescale.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;
constexpr int kKeyChunk = 16;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;          // (B, S, H, hd) activation dtype
  const void* k_new;      // (B, S, KV, hd) or null (attention only)
  const void* v_new;
  void* k_pool;           // (n_pages, page_size, KV, hd) pool dtype
  void* v_pool;
  const int* block_table; // (B, P)
  const int* q_pos;       // (B, S)
  const int* last_pos;    // (B,)
  void* out;              // (B, S, H, hd) activation dtype
  int B, S, H, KV, page_size, P, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int pos_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Does ring entry `ring` count for a query row at position `qp`?
__device__ __forceinline__ bool admitted(int ring, int last, int T, int qp,
                                         int window) {
  const int k_pos = last - pos_mod(last - ring, T);
  return k_pos >= 0 && ring < T && k_pos <= qp &&
         (window <= 0 || k_pos > qp - window);
}

template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  constexpr int E = HD / 32;
  extern __shared__ float smem[];
  float* k_tile = smem;
  float* v_tile = smem + a.page_size * HD;

  const int kv = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S, KV = a.KV, H = a.H, g = H / KV, psz = a.page_size;
  const int T = a.P * psz;
  const int last = a.last_pos[b];
  const int* bt = a.block_table + (size_t)b * a.P;
  TP* kp = static_cast<TP*>(a.k_pool);
  TP* vp = static_cast<TP*>(a.v_pool);

  // 1. scatter this (b, kv) slice of the S new rows into their pages
  if (a.k_new != nullptr) {
    const TQ* kn = static_cast<const TQ*>(a.k_new);
    const TQ* vn = static_cast<const TQ*>(a.v_new);
    for (int i = tid; i < S * HD; i += kThreads) {
      const int s = i / HD, d = i % HD;
      const int slot = pos_mod(last - (S - 1) + s, T);
      const size_t dst =
          (((size_t)bt[slot / psz] * psz + slot % psz) * KV + kv) * HD + d;
      const size_t src = (((size_t)b * S + s) * KV + kv) * HD + d;
      kp[dst] = from_f<TP>(to_f(kn[src]));
      vp[dst] = from_f<TP>(to_f(vn[src]));
    }
    __syncthreads();  // the block's own writes are visible to its reads
  }

  // 2. attend, in passes of up to kRowsPerPass query rows
  const TQ* qg = static_cast<const TQ*>(a.q);
  TQ* og = static_cast<TQ*>(a.out);
  const int* qpos = a.q_pos + (size_t)b * S;
  const int rows = S * g;
  for (int r0 = 0; r0 < rows; r0 += kRowsPerPass) {
    const int r_end = min(rows, r0 + kRowsPerPass);
    // query positions spanned by this pass (the page-skip test below)
    int lo_pos = qpos[r0 / g], hi_pos = lo_pos;
    for (int s = r0 / g + 1; s <= (r_end - 1) / g; ++s) {
      lo_pos = min(lo_pos, qpos[s]);
      hi_pos = max(hi_pos, qpos[s]);
    }

    float qv[kRowsPerWarp][E], acc[kRowsPerWarp][E];
    float m[kRowsPerWarp], l[kRowsPerWarp];
    int rpos[kRowsPerWarp];
    size_t roff[kRowsPerWarp];
    bool live[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = r0 + warp * kRowsPerWarp + j;
      live[j] = r < r_end;
      const int s = live[j] ? r / g : 0;
      roff[j] = (((size_t)b * S + s) * H + kv * g + (live[j] ? r % g : 0)) *
                HD;
      rpos[j] = qpos[s];
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qv[j][e] = live[j] ? to_f(qg[roff[j] + lane + 32 * e]) : 0.f;
        acc[j][e] = 0.f;
      }
    }

    for (int ip = 0; ip < a.P; ++ip) {
      // skip a page none of whose entries can count for this pass
      int need = 0;
      for (int t = tid; t < psz; t += kThreads) {
        const int ring = ip * psz + t;
        const int k_pos = last - pos_mod(last - ring, T);
        need |= k_pos >= 0 && ring < T && k_pos <= hi_pos &&
                (a.window <= 0 || k_pos > lo_pos - a.window);
      }
      if (!__syncthreads_or(need)) continue;

      const size_t page = (size_t)bt[ip];
      for (int i = tid; i < psz * HD; i += kThreads) {
        const int t = i / HD, d = i % HD;
        const size_t src = ((page * psz + t) * KV + kv) * HD + d;
        k_tile[i] = to_f(kp[src]);
        v_tile[i] = to_f(vp[src]);
      }
      __syncthreads();

      for (int t0 = 0; t0 < psz; t0 += kKeyChunk) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          if (!live[j]) continue;  // warp-uniform
          float sc[kKeyChunk];
          unsigned ok = 0;
          float m_tile = kNegInf;
#pragma unroll
          for (int u = 0; u < kKeyChunk; ++u) {
            sc[u] = kNegInf;
            const int t = t0 + u;
            // warp-uniform: depends on the row and the key only
            if (t < psz && admitted(ip * psz + t, last, T, rpos[j],
                                    a.window)) {
              float part = 0.f;
#pragma unroll
              for (int e = 0; e < E; ++e)
                part += qv[j][e] * k_tile[t * HD + lane + 32 * e];
              sc[u] = warp_sum(part) * a.scale;
              ok |= 1u << u;
              m_tile = fmaxf(m_tile, sc[u]);
            }
          }
          if (!ok) continue;
          const float m_new = fmaxf(m[j], m_tile);
          const float alpha = expf(m[j] - m_new);
          l[j] *= alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
#pragma unroll
          for (int u = 0; u < kKeyChunk; ++u) {
            if (!(ok & (1u << u))) continue;
            const float pr = expf(sc[u] - m_new);
            l[j] += pr;
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[j][e] += pr * v_tile[(t0 + u) * HD + lane + 32 * e];
          }
          m[j] = m_new;
        }
      }
      __syncthreads();  // before the next page overwrites the tiles
    }

#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      if (!live[j]) continue;
      const float denom = fmaxf(l[j], 1e-30f);
#pragma unroll
      for (int e = 0; e < E; ++e)
        og[roff[j] + lane + 32 * e] = from_f<TQ>(acc[j][e] / denom);
    }
  }
}

template <typename TQ, typename TP, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)a.page_size * HD * sizeof(float);
  auto kern = paged_attention_kernel<TQ, TP, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.KV, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TP>
cudaError_t launch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<TQ, TP, 64>(a, stream);
    case 128: return launch<TQ, TP, 128>(a, stream);
    case 256: return launch<TQ, TP, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code
// (0 on success); the launch is checked with cudaGetLastError().
extern "C" int paged_attention_launch(
    int q_dtype, int pool_dtype, int head_dim, const void* q,
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const int* block_table, const int* q_pos, const int* last_pos, void* out,
    int B, int S, int H, int KV, int page_size, int P, int window,
    float scale, void* stream) {
  Args a{q, k_new, v_new, k_pool, v_pool, block_table, q_pos, last_pos, out,
         B, S, H, KV, page_size, P, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && pool_dtype == 0)
    return launch_hd<float, float>(a, head_dim, st);
  if (q_dtype == 1 && pool_dtype == 0)
    return launch_hd<__nv_bfloat16, float>(a, head_dim, st);
  if (q_dtype == 1 && pool_dtype == 1)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(a, head_dim, st);
  if (q_dtype == 0 && pool_dtype == 1)
    return launch_hd<float, __nv_bfloat16>(a, head_dim, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
