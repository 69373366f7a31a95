// Paged attention with the new rows' K/V scatter fused in: the Hopper port
// of the TPU kernel `paged_attention_grouped` (`_kernel`) in
// src/repro/kernels/paged_attention/paged_attention.py, behind
// ops.paged_attention_update / ops.paged_attention.
//
// What it computes (per slot b, KV head kv): the S new K/V rows of the
// slot are written into their block-table-addressed page rows (ring slot
// (last - S + 1 + s) mod T, cast to the pool dtype); then the R = S*g query
// rows of the GQA group (row r = token r / g, query head kv*g + r % g)
// attend over the slot's logical ring of T = P * page_size entries, read
// through the block table, with an fp32 online softmax.  A ring entry
// counts only when the absolute position it holds,
// k_pos = last - ((last - ring) mod T), satisfies k_pos >= 0, ring < T,
// k_pos <= q_pos[row / g] and, with a window, k_pos > q_pos - window.
//
// What bounds it: at serving shapes, latency.  The least time is bytes
// (each admitted pool entry read once, ~4 flops per element and query
// row, far below the ~295 flop/byte ridge), but a decode tick reads only
// ~2 MB of the pool, under a microsecond at 3.35 TB/s.  What a launch
// costs is its chain of dependent steps.  The design keeps two trips to
// device memory on that chain (the inputs, then the pages) and runs many
// short chains side by side.
//
// Design:
// - the ring is split over CTAs.  The grid is (KV * row blocks, B,
//   n_split): a CTA owns kRows query rows of one (b, kv) and a fixed run
//   of `pages_per_split` block-table entries, n_split = ceil(P /
//   pages_per_split).  It depends on shapes only (nothing is read from the
//   device to choose it), so a launch can be captured in a CUDA graph.  A
//   CTA none of whose entries can count for its rows loads no page and
//   writes an empty partial (m = -1e30, l = 0).
// - the splits are merged by the last CTA of each (b, kv, row block) to
//   finish: each CTA writes its partial (m, l, acc) to the scratch the
//   wrapper allocated (torch.empty; its size follows from the shapes) and
//   takes a ticket, an acquire-release atomic at GPU scope after a CTA
//   barrier, which publishes the partial; the CTA that draws the last
//   ticket loads all partials at once, merges them by log-sum-exp
//   rescaling in fp32 and resets the ticket to 0, so that the next launch
//   (or the next replay of a CUDA graph) finds it so.  The tickets are the
//   caller's: a zeroed buffer that the wrapper keeps for each CUDA stream
//   (a launch under graph capture gets its own), so two launches that run
//   at once on two streams never take each other's tickets; the kernel
//   keeps no device-global state.  An empty partial (l = 0) is skipped by
//   selection: it adds no exp(-1e30 - (-1e30)) = 1 term and its acc is
//   never read.  With n_split = 1 a CTA writes its output directly, with
//   no scratch and no ticket.  (A thread-block cluster merging through
//   distributed shared memory was tried and timed slower: its CTAs must
//   be co-scheduled, and at this kernel's register count the clusters
//   took a second wave.)
// - every load that needs nothing else is issued at once, first: the
//   slot's last position, the CTA's block-table entries (kept in shared
//   memory), its query rows and the new K/V rows.  Then the scatter, the
//   admission test and one barrier; then the pages.
// - the scatter stays fused.  Each CTA writes the new rows that land in
//   ITS OWN pages, then __syncthreads(), then attends to its own pages
//   only.  That needs no second pass because of the copy-on-write
//   contract: every page written in a tick is private to one slot
//   (scheduler.py `ensure_private`, and the write/read contract in the TPU
//   kernel's docstring), and inside a slot each page is one block-table
//   entry, owned by one split.  So no CTA reads a page that another CTA
//   writes in the same launch, except (a) the CTAs of other row blocks of
//   the same split, which write the very same values to the same rows (a
//   read sees its own CTA's write or an identical one), and (b) the null
//   page 0, below.
// - the null page 0 is written concurrently by every idle lane, so it
//   holds racy garbage.  Masked entries are removed by SELECTION: an
//   invalid key is never loaded or scored and its V row never enters the
//   sum (no multiply-by-zero that would turn a garbage inf into NaN).
// - inside a CTA every warp works: a key is scored by a group of
//   HD / kSlice lanes, each holding kSlice head-dim elements of q (from
//   shared memory), of K and of V (16-byte loads straight from the pool
//   into registers, all of a group's kKeysPerRound keys issued before any
//   is used), so a warp scores 32 * kSlice / HD keys per shuffle round.
//   The dots of all (row, key) pairs of a round run side by side, and
//   rows past the CTA's last are skipped (a test the whole CTA agrees
//   on).  Every key group keeps its own online-softmax state per row; the
//   groups of a warp merge by shuffles, the warps through shared memory.
// - tools/paged_split_tiles.py times other warp counts, rows per CTA,
//   keys per round and splits, and where a launch's time goes.
// - the reference's constants: -1e30 for an empty running max, l >= 1e-30
//   for the divisor (a row with no admitted entry gives 0), fp32 softmax
//   and accumulation.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 16;         // head-dim elements per lane of a key group
constexpr int kRows = 4;           // query rows per CTA
constexpr int kKeysPerRound = 2;   // keys a group loads before it uses any
constexpr int kMergeBatch = 8;     // partials a merging thread loads at once
constexpr int kBtCache = 64;       // block-table entries kept in shared memory
constexpr int kRecord = 4;         // a partial's m, l and two unused, then acc
constexpr int kMaxTickets = 1 << 14;
constexpr long long kMaxScratchBytes = 64ll << 20;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;          // (B, S, H, hd) activation dtype
  const void* k_new;      // (B, S, KV, hd) or null (attention only)
  const void* v_new;
  void* k_pool;           // (n_pages, page_size, KV, hd) pool dtype
  void* v_pool;
  const int* block_table; // (B, P)
  const int* q_pos;       // (B, S) or null: last - S + 1 .. last
  const int* last_pos;    // (B,)
  void* out;              // (B, S, H, hd) activation dtype
  float* part;            // the splits' partials, or null when n_split == 1
  unsigned* tickets;      // one per (b, kv, row block) of a splitting
                          // launch, 0 before it and left at 0
  int B, S, H, KV, page_size, P, window, pages_per_cta, n_split;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// kSlice consecutive elements into registers, 16 bytes per load
__device__ __forceinline__ void load_slice(const float* p, float (&r)[kSlice]) {
#pragma unroll
  for (int i = 0; i < kSlice / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    r[4 * i] = v.x; r[4 * i + 1] = v.y; r[4 * i + 2] = v.z; r[4 * i + 3] = v.w;
  }
}
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p,
                                           float (&r)[kSlice]) {
#pragma unroll
  for (int i = 0; i < kSlice / 8; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[h]));
      r[8 * i + 2 * h] = f.x;
      r[8 * i + 2 * h + 1] = f.y;
    }
  }
}

__device__ __forceinline__ int pos_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// Does an entry holding absolute position k_pos count for a query at qp?
__device__ __forceinline__ bool admitted(int k_pos, int qp, int window) {
  return k_pos >= 0 && k_pos <= qp && (window <= 0 || k_pos > qp - window);
}

// The ticket's old value, incremented with acquire-release semantics at GPU
// scope.
__device__ __forceinline__ unsigned take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(t) : "memory");
  return old;
}

// Merge partial (mo, lo, ao) into (m, l, acc); a partial with l = 0 is
// empty and skipped by selection.
__device__ __forceinline__ void merge_into(float& m, float& l, float4& acc,
                                           float mo, float lo, float4 ao) {
  if (!(lo > 0.f)) return;
  if (!(l > 0.f)) {
    m = mo;
    l = lo;
    acc = ao;
    return;
  }
  const float mn = fmaxf(m, mo), ca = expf(m - mn), cb = expf(mo - mn);
  l = l * ca + lo * cb;
  acc = make_float4(acc.x * ca + ao.x * cb, acc.y * ca + ao.y * cb,
                    acc.z * ca + ao.z * cb, acc.w * ca + ao.w * cb);
  m = mn;
}

template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  constexpr int L = HD / kSlice;            // lanes per key group
  constexpr int kGroupsPerWarp = 32 / L;
  constexpr int kGroups = kWarps * kGroupsPerWarp;
  constexpr int C = HD / 4;                 // float4 chunks of a row
  __shared__ __align__(16) float q_s[kRows][HD];
  __shared__ __align__(16) float w_acc[kWarps][kRows][HD];
  __shared__ float w_m[kWarps][kRows], w_l[kWarps][kRows];
  __shared__ int bt_s[kBtCache];
  __shared__ bool s_last;

  const int S = a.S, KV = a.KV, g = a.H / KV, psz = a.page_size;
  const int kv = blockIdx.x % KV, rb = blockIdx.x / KV;
  const int b = blockIdx.y, split = blockIdx.z;
  const int ticket = blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp * kGroupsPerWarp + lane / L, gl = lane % L;
  const int T = a.P * psz;
  const int page0 = split * a.pages_per_cta;
  const int n_bt = min(a.pages_per_cta, a.P - page0);
  const int key0 = page0 * psz, key1 = min(T, key0 + a.pages_per_cta * psz);
  const int r0 = rb * kRows, nrows = min(kRows, S * g - r0);
  const int* bt = a.block_table + (size_t)b * a.P + page0;
  TP* kp = static_cast<TP*>(a.k_pool);
  TP* vp = static_cast<TP*>(a.v_pool);
  const TQ* qg = static_cast<const TQ*>(a.q);
  const TQ* kn = static_cast<const TQ*>(a.k_new);
  const TQ* vn = static_cast<const TQ*>(a.v_new);
  TQ* og = static_cast<TQ*>(a.out);
  auto row_off = [&](int r, int c) {  // q / out element of row r, chunk c
    return (((size_t)b * S + r / g) * a.H + kv * g + r % g) * HD + 4 * c;
  };

  // 1. every load that needs nothing else, at once: last, the CTA's
  //    block-table entries, its query rows, the first new K/V chunk
  const int last = a.last_pos[b];
  for (int i = tid; i < min(n_bt, kBtCache); i += kThreads) bt_s[i] = bt[i];
  float4 q4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < nrows * C) q4 = load4(qg + row_off(r0 + tid / C, tid % C));
  int rpos[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int s = j < nrows ? (r0 + j) / g : 0;
    rpos[j] = a.q_pos ? a.q_pos[(size_t)b * S + s] : last - (S - 1) + s;
  }
  const bool scatter = kn != nullptr;
  float4 k4 = q4, v4 = q4;
  if (scatter && tid < S * C) {
    const size_t src = (((size_t)b * S + tid / C) * KV + kv) * HD + 4 * (tid % C);
    k4 = load4(kn + src);
    v4 = load4(vn + src);
  }
  for (int i = tid; i < nrows * C; i += kThreads) {
    if (i >= kThreads) q4 = load4(qg + row_off(r0 + i / C, i % C));
    *reinterpret_cast<float4*>(&q_s[i / C][4 * (i % C)]) = q4;
  }
  __syncthreads();  // bt_s
  auto page_of = [&](int ip) {  // ip: block-table entry of this CTA
    return ip < kBtCache ? bt_s[ip] : bt[ip];
  };

  // 2. scatter the new rows that land in this CTA's pages
  if (scatter) {
    for (int i = tid; i < S * C; i += kThreads) {
      const int s = i / C, c = i % C;
      if (i >= kThreads) {
        const size_t src = (((size_t)b * S + s) * KV + kv) * HD + 4 * c;
        k4 = load4(kn + src);
        v4 = load4(vn + src);
      }
      const int slot = pos_mod(last - (S - 1) + s, T);
      if (slot < key0 || slot >= key1) continue;
      const size_t dst =
          (((size_t)page_of(slot / psz - page0) * psz + slot % psz) * KV + kv) *
              HD + 4 * c;
      store4(kp + dst, k4);
      store4(vp + dst, v4);
    }
  }

  // 3. may any entry of this CTA count for one of its rows?  (also the
  //    barrier after the scatter and the q rows)
  int lo = 0x7fffffff, hi = -0x7fffffff;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (j < nrows) {
      lo = min(lo, rpos[j]);
      hi = max(hi, rpos[j]);
    }
  int need = 0;
  for (int t = key0 + tid; t < key1; t += kThreads) {
    const int k_pos = last - pos_mod(last - t, T);
    need |= k_pos >= 0 && k_pos <= hi && (a.window <= 0 || k_pos > lo - a.window);
  }
  const bool any = __syncthreads_or(need);

  if (any) {
    // 4. each key group: an online softmax over its keys of the CTA
    float m[kRows], l[kRows], acc[kRows][kSlice];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < kSlice; ++e) acc[j][e] = 0.f;
    }
    const int d0 = gl * kSlice;
    for (int t0 = key0 + grp; t0 < key1; t0 += kGroups * kKeysPerRound) {
      float kr[kKeysPerRound][kSlice], vr[kKeysPerRound][kSlice];
      int kpos[kKeysPerRound];
      bool live[kKeysPerRound];
#pragma unroll
      for (int u = 0; u < kKeysPerRound; ++u) {
        const int t = t0 + u * kGroups;
        kpos[u] = last - pos_mod(last - t, T);
        live[u] = t < key1 && kpos[u] >= 0 && kpos[u] <= hi &&
                  (a.window <= 0 || kpos[u] > lo - a.window);
        if (live[u]) {
          const size_t off =
              (((size_t)page_of(t / psz - page0) * psz + t % psz) * KV + kv) *
                  HD + d0;
          load_slice(kp + off, kr[u]);
          load_slice(vp + off, vr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kSlice; ++e) kr[u][e] = vr[u][e] = 0.f;
        }
      }
      // the scores of every (row, key) pair of the round: four partial
      // sums per dot, then the groups' shuffle rounds side by side (rows
      // past nrows skipped: nrows is the same for the whole CTA)
      float sc[kRows][kKeysPerRound];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j >= nrows) continue;
        float qv[kSlice];
#pragma unroll
        for (int e = 0; e < kSlice; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&q_s[j][d0 + e]);
          qv[e] = v.x; qv[e + 1] = v.y; qv[e + 2] = v.z; qv[e + 3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < kKeysPerRound; ++u) {
          float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < kSlice; ++e)
            p4[e % 4] = fmaf(qv[e], kr[u][e], p4[e % 4]);
          sc[j][u] = (p4[0] + p4[1]) + (p4[2] + p4[3]);
        }
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int u = 0; u < kKeysPerRound; ++u)
            if (j < nrows)
              sc[j][u] += __shfl_xor_sync(0xffffffffu, sc[j][u], o);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j >= nrows) continue;
        bool ok[kKeysPerRound];
        float m_tile = kNegInf;
        bool any_ok = false;
#pragma unroll
        for (int u = 0; u < kKeysPerRound; ++u) {
          sc[j][u] *= a.scale;
          ok[u] = live[u] && admitted(kpos[u], rpos[j], a.window);
          if (ok[u]) {
            m_tile = fmaxf(m_tile, sc[j][u]);
            any_ok = true;
          }
        }
        if (!any_ok) continue;  // group-uniform; no shuffles below
        const float m_new = fmaxf(m[j], m_tile);
        const float alpha = expf(m[j] - m_new);
        l[j] *= alpha;
#pragma unroll
        for (int e = 0; e < kSlice; ++e) acc[j][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kKeysPerRound; ++u) {
          if (!ok[u]) continue;
          const float p = expf(sc[j][u] - m_new);
          l[j] += p;
#pragma unroll
          for (int e = 0; e < kSlice; ++e) acc[j][e] = fmaf(p, vr[u][e], acc[j][e]);
        }
        m[j] = m_new;
      }
    }

    // 5. merge the key groups of a warp (shuffles), then the warps
    //    (shared memory); a group with l = 0 is skipped by selection
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j >= nrows) continue;
        const float mo = __shfl_xor_sync(0xffffffffu, m[j], o);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[j], o);
        const float mn = fmaxf(l[j] > 0.f ? m[j] : kNegInf,
                               lo_ > 0.f ? mo : kNegInf);
        const float ca = l[j] > 0.f ? expf(m[j] - mn) : 0.f;
        const float cb = lo_ > 0.f ? expf(mo - mn) : 0.f;
#pragma unroll
        for (int e = 0; e < kSlice; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], o);
          acc[j][e] = (l[j] > 0.f ? acc[j][e] * ca : 0.f) +
                      (lo_ > 0.f ? ao * cb : 0.f);
        }
        l[j] = (l[j] > 0.f ? l[j] * ca : 0.f) + (lo_ > 0.f ? lo_ * cb : 0.f);
        m[j] = mn;
      }
    }
    if (lane < L) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j >= nrows) continue;
        if (lane == 0) {
          w_m[warp][j] = m[j];
          w_l[warp][j] = l[j];
        }
#pragma unroll
        for (int e = 0; e < kSlice; e += 4)
          *reinterpret_cast<float4*>(&w_acc[warp][j][d0 + e]) =
              make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
      }
    }
    __syncthreads();
  }

  // 6. this CTA's result: the output itself (one split), or its partial
  //    (a record of kRecord + HD floats per row: m, l, unused, acc)
  auto record = [&](int sp, int j) {
    return a.part + (((size_t)ticket * a.n_split + sp) * kRows + j) *
                        (kRecord + HD);
  };
  for (int i = tid; i < nrows * C; i += kThreads) {
    const int j = i / C, c = i % C;
    float mx = kNegInf, den = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    if (any) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        merge_into(mx, den, A, w_m[w][j], w_l[w][j],
                   *reinterpret_cast<const float4*>(&w_acc[w][j][4 * c]));
    }
    if (a.n_split == 1) {
      const float inv = 1.f / fmaxf(den, 1e-30f);
      store4(og + row_off(r0 + j, c),
             make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv));
    } else {
      float* rec = record(split, j);
      if (c == 0) {
        rec[0] = mx;
        rec[1] = den;
      }
      if (any)  // an empty partial's acc is never read
        *reinterpret_cast<float4*>(rec + kRecord + 4 * c) = A;
    }
  }
  if (a.n_split == 1) return;

  // 7. the last CTA of this (b, kv, row block) to finish merges the
  //    splits, kMergeBatch partials' loads in flight at a time.  The
  //    barrier orders the CTA's partial before thread 0's ticket, whose
  //    acquire-release at GPU scope publishes it and, for the last CTA,
  //    makes every other CTA's partial visible (the next barrier passes
  //    that on to the CTA's other threads)
  __syncthreads();
  if (tid == 0)
    s_last = take_ticket(&a.tickets[ticket]) == (unsigned)(a.n_split - 1);
  __syncthreads();
  if (!s_last) return;
  for (int i = tid; i < nrows * C; i += kThreads) {
    const int j = i / C, c = i % C;
    float mx = kNegInf, den = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < a.n_split; s0 += kMergeBatch) {
      float2 ml[kMergeBatch];
      float4 pa[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        ml[u] = make_float2(kNegInf, 0.f);
        if (s0 + u < a.n_split) {
          const float* rec = record(s0 + u, j);
          ml[u] = __ldcg(reinterpret_cast<const float2*>(rec));
          pa[u] = __ldcg(reinterpret_cast<const float4*>(rec + kRecord + 4 * c));
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)  // empty partials: skipped
        merge_into(mx, den, A, ml[u].x, ml[u].y, pa[u]);
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    store4(og + row_off(r0 + j, c),
           make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv));
  }
  if (tid == 0) a.tickets[ticket] = 0;
}

// How the launch is cut: row blocks per (b, kv) and CTAs per ring.  The
// ring is split unless the tickets or the scratch would not fit.
struct Plan {
  int n_rb, n_split;
  long long scratch_floats;
};

Plan plan(int B, int S, int H, int KV, int hd, int P, int pages_per_split) {
  Plan p;
  p.n_rb = (S * (H / KV) + kRows - 1) / kRows;
  p.n_split = pages_per_split > 0
                  ? (P + pages_per_split - 1) / pages_per_split : 1;
  const long long tickets = (long long)B * KV * p.n_rb;
  p.scratch_floats = tickets * p.n_split * kRows * (kRecord + hd);
  if (p.n_split <= 1 || tickets > kMaxTickets ||
      p.scratch_floats * 4 > kMaxScratchBytes) {
    p.n_split = 1;
    p.scratch_floats = 0;
  }
  return p;
}

template <typename TQ, typename TP, int HD>
cudaError_t launch(const Args& a, int n_rb, cudaStream_t stream) {
  paged_attention_kernel<TQ, TP, HD>
      <<<dim3(a.KV * n_rb, a.B, a.n_split), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TP>
cudaError_t launch_hd(const Args& a, int hd, int n_rb, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<TQ, TP, 64>(a, n_rb, stream);
    case 128: return launch<TQ, TP, 128>(a, n_rb, stream);
    case 256: return launch<TQ, TP, 256>(a, n_rb, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32 elements of scratch a launch with these shapes needs (0: the ring
// is not split; pass a null scratch).
extern "C" long long paged_attention_scratch_floats(int B, int S, int H,
                                                    int KV, int head_dim,
                                                    int P,
                                                    int pages_per_split) {
  return plan(B, S, H, KV, head_dim, P, pages_per_split).scratch_floats;
}

// uint32 tickets a splitting launch may take (the size of the buffer that
// paged_attention_launch's `tickets` points to), and those a launch with
// these shapes takes (0: the ring is not split).
extern "C" int paged_attention_max_tickets(void) { return kMaxTickets; }
extern "C" int paged_attention_tickets(int B, int S, int H, int KV,
                                       int head_dim, int P,
                                       int pages_per_split) {
  const Plan p = plan(B, S, H, KV, head_dim, P, pages_per_split);
  return p.n_split > 1 ? B * KV * p.n_rb : 0;
}

// dtype codes: 0 = float32, 1 = bfloat16.  q_pos may be null (the
// contiguous block ending at last_pos); k_new/v_new null for attention
// only; scratch as paged_attention_scratch_floats says; tickets: at least
// paged_attention_tickets() zeroed uint32 (the launch leaves them at 0),
// used only when the ring is split.  Returns a cudaError_t code (0 on
// success); the launch is checked with cudaGetLastError().
extern "C" int paged_attention_launch(
    int q_dtype, int pool_dtype, int head_dim, const void* q,
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const int* block_table, const int* q_pos, const int* last_pos, void* out,
    float* scratch, unsigned* tickets, int B, int S, int H, int KV,
    int page_size, int P, int window, int pages_per_split, float scale,
    void* stream) {
  const Plan p = plan(B, S, H, KV, head_dim, P, pages_per_split);
  if (p.n_split > 1 && (scratch == nullptr || tickets == nullptr))
    return cudaErrorInvalidValue;
  Args a{q, k_new, v_new, k_pool, v_pool, block_table, q_pos, last_pos, out,
         p.n_split > 1 ? scratch : nullptr, tickets, B, S, H, KV, page_size,
         P, window, p.n_split > 1 ? pages_per_split : P, p.n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && pool_dtype == 0)
    return launch_hd<float, float>(a, head_dim, p.n_rb, st);
  if (q_dtype == 1 && pool_dtype == 0)
    return launch_hd<__nv_bfloat16, float>(a, head_dim, p.n_rb, st);
  if (q_dtype == 1 && pool_dtype == 1)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(a, head_dim, p.n_rb, st);
  if (q_dtype == 0 && pool_dtype == 1)
    return launch_hd<float, __nv_bfloat16>(a, head_dim, p.n_rb, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
