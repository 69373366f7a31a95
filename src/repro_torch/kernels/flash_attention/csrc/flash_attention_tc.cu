// Blockwise causal attention with an online softmax on Hopper's tensor
// cores: the bf16 path of ops.flash_attention, the port of the TPU kernel
// `flash_attention_bhsd` (`_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py.  flash_attention.cu
// dispatches bf16 inputs here (and keeps its CUDA-core kernel for fp32).
//
// What it computes is what the fp32 kernel computes (see its notes): per
// batch row b, query head h and KV head h / g, softmax over the admitted
// keys of q_i . k_j * scale, times v_j, with the causal, sliding-window and
// chunked-local terms, -1e30 for masked logits and p = 0 for masked keys,
// the running (m, l, acc) rescaled once per key block, l clamped at 1e-30,
// and the output rounded to bf16 once.
//
// What bounds it: operations.  At qwen3_0_6b's prefill (B = 2, S = 2048,
// H = 16, KV = 8, hd = 128) the causal work is 34.4 GFLOP against 50 MB
// moved, about 0.035 ms at the bf16 tensor-core peak.  This kernel does
// 1.5 times that minimal work (p times V twice, below) and computes the
// diagonal key blocks whole.
//
// Design:
// - products on the tensor cores with wgmma (sm_90a).  S = Q K^T: M = 64
//   query rows per consumer warpgroup, N = 128 keys, K = hd in steps of 16,
//   both operands K-major in shared memory.  O += P V: P from registers
//   (the fp32 S accumulator converted in place to the A fragment: the two
//   layouts put the same (row, column) pairs in the same thread), V from
//   shared memory through the descriptor's transpose bit (V is stored
//   [key][hd], MN-major for B), N = hd.
// - p keeps fp32 precision, as the TPU kernel's fp32 p @ v does: p is split
//   into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both terms are
//   multiplied with the same V tile (about 16 significant bits of p against
//   8 for one bf16 term).  l sums the unrounded fp32 p.  q, k, v are bf16,
//   so the products are exact and only the fp32 summation order differs
//   from the TPU kernel's.
// - warp specialisation: one producer warp keeps K and V tiles in flight
//   with TMA into a ring of kStages stages, signalled by mbarriers (one
//   "full" barrier per tile and stage, one "empty" per stage that the 256
//   consumer threads arrive at when their products have read it); Q (128
//   rows) is loaded once.  setmaxnreg moves registers from the producer
//   warpgroup to the two consumer warpgroups.
// - tensor maps are 4-D over (hd, heads, S, B) in the model layout, so GQA
//   reads KV head h / g with no copies, and TMA's zero fill covers the
//   ragged edge of S: a tile never crosses into the next batch row.  A row
//   holds at most 64 bf16 columns under the 128-byte swizzle, so hd = 80
//   and 128 are loaded as two panels of 64 columns; for hd = 80 the second
//   panel's columns 80..127 lie past the tensor map's hd and are zero
//   filled (never the next head's data), QK^T runs 5 steps of 16 and PV
//   one m64n80 product.
// - the softmax runs in registers in the base-2 domain (scale * log2(e)
//   folded into the logits): row maxima reduce over the four threads that
//   share a row of the accumulator, and the mask terms are evaluated only
//   on key blocks that straddle a causal, window, chunk or S edge.  Key
//   blocks that no row of the CTA admits are skipped (exact, as in the
//   fp32 kernel), and the CTAs of the last q blocks, which have the most
//   key blocks under a causal mask, are launched first.
// - the tensor maps are encoded on the host at each launch with
//   cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint
//   (no -lcuda), and passed as __grid_constant__ parameters.
// - tiles of 128 query rows by 128 keys in a ring of 2 stages: no spills
//   (ptxas), and on the H100 neither a third stage nor blocks of 64 keys
//   ran faster (tools/flash_tc_tiles.py times the variants; PERF.md).
//   Pipeline depth does not bound it: each consumer warpgroup runs its
//   softmax and the p split between its own products, so the tensor cores
//   wait while it does, and the other warpgroup's products overlap only
//   by chance of scheduling.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;        // query rows per CTA (two warpgroups of 64)
constexpr int kBK = 128;        // keys per block: 64 or 128
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16 columns
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int kPanels = (HD + 63) / 64;
  static constexpr int kQPanel = kBQ * kRowBytes;
  static constexpr int kKVPanel = kBK * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKVPanel;  // one K or V tile
  static constexpr int kBarriers = 1 + 3 * kStages;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

struct TcArgs {
  void* o;  // (B, S, H, hd) bf16
  int B, S, H, group, causal, window, chunk, n_q;
  float scale_log2;  // 1 / sqrt(hd) * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with the given parity to complete.  A wait
// that lasts seconds can only be a broken pipeline: trap, so that the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = now_ns();
    else if (now_ns() - start > 4000000000ull) __trap();
  }
}

// One box of the 4-D map (hd, heads, S, B) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
        "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle.  K-major
// operands (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
// a k step of 16 columns advances the start by 32 bytes.  The MN-major B
// operand (V): keys of 128 bytes, 8-key groups 1024 bytes apart (SBO), the
// second 64-column panel LBO bytes on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void own(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// S (+)= Q K^T for one k step of 16 columns: N = BK keys.
template <int BK>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (BK == 128) wgmma_ss_n128(s, da, db, scale_d);
  else wgmma_ss_n64(s, da, db, scale_d);
}

// O += P V for one k step of 16 keys: N = HD in one instruction.
template <int HD>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (HD == 80) wgmma_rs_n80(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

__device__ __forceinline__ bool admitted(const TcArgs& a, int qp, int kp) {
  bool ok = kp < a.S;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window) ok = ok && kp > qp - a.window;
  if (a.chunk) ok = ok && (kp / a.chunk) == (qp / a.chunk);
  return ok;
}

// The online-softmax update of one key block in the accumulator layout:
// sc[4j + 2i + c] holds row row0 + 8i, key col0 + 8j + c.  Turns the raw
// logits into fp32 p in place; returns each row's rescale factor in alpha.
template <bool MASK>
__device__ __forceinline__ void softmax_block(float (&sc)[kBK / 2],
                                              float (&m)[2],
                                              float (&l)[2], float (&alpha)[2],
                                              const TcArgs& a, int row0,
                                              int col0) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * a.scale_log2;
      if (MASK && !admitted(a, row0 + 8 * (e >> 1), col0 + 8 * j + (e & 1)))
        x = kNegInf;
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];  // this thread's share of the row sum
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(sc[4 * j + e] - m[e >> 1]);
      if (MASK && !admitted(a, row0 + 8 * (e >> 1), col0 + 8 * j + (e & 1)))
        p = 0.f;
      sc[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const TcArgs a) {
  using T = Tiles<HD>;
  static_assert(HD % 16 == 0 && HD <= 128, "head_dim: 64, 80 or 128");
  static_assert(kBK == 64 || kBK == 128, "keys per block: 64 or 128");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(base);
  const uint32_t sK = sQ + T::kQBytes;              // kStages K tiles
  const uint32_t sV = sK + kStages * T::kKVBytes;   // kStages V tiles
  const uint32_t bars = sV + kStages * T::kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int n_bh = a.H * a.B;
  const int qb = a.n_q - 1 - static_cast<int>(blockIdx.x) / n_bh;  // longest
  const int h = static_cast<int>(blockIdx.x) % n_bh % a.H;         // rows
  const int b = static_cast<int>(blockIdx.x) % n_bh / a.H;         // first
  const int kvh = h / a.group;
  const int S = a.S, q0 = qb * kBQ;

  // the key blocks that can hold an admitted key for some row of the CTA
  const int q_last = min(q0 + kBQ, S) - 1;
  int lo = 0, hi = S - 1;
  if (a.window) lo = max(lo, q0 - a.window + 1);
  if (a.chunk) {
    lo = max(lo, (q0 / a.chunk) * a.chunk);
    hi = min(hi, (q_last / a.chunk) * a.chunk + a.chunk - 1);
  }
  if (a.causal) hi = min(hi, q_last);
  const int kb0 = lo / kBK, n_blocks = hi / kBK - kb0 + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup; one thread starts the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(sQ + p * T::kQPanel, &tq, q_full, 64 * p, h, q0, b);
      for (int it = 0; it < n_blocks; ++it) {
        const int s = it % kStages;
        const int k0 = (kb0 + it) * kBK;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(sK + s * T::kKVBytes + p * T::kKVPanel, &tk, k_full(s),
                   64 * p, kvh, k0, b);
        mbar_expect_tx(v_full(s), T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(sV + s * T::kKVBytes + p * T::kKVPanel, &tv, v_full(s),
                   64 * p, kvh, k0, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // a consumer warpgroup: 64 query rows of the CTA
  const int cw = tid / 128 - 1, t = tid % 128, warp = t / 32, lane = t % 32;
  const int wr0 = q0 + 64 * cw, wr1 = wr0 + 63;
  const int row0 = wr0 + 16 * warp + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);                // column within 8
  const uint32_t sQw = sQ + 64 * cw * kRowBytes;

  float o[HD / 2], sc[kBK / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
#pragma unroll
  for (int x = 0; x < kBK / 2; ++x) sc[x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_blocks; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = (kb0 + it) * kBK, kend = k0 + kBK - 1;
    const uint32_t sKs = sK + s * T::kKVBytes, sVs = sV + s * T::kKVBytes;

    // S = Q K^T
    mbar_wait(k_full(s), parity);
    own(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns of the panel
      mma_qk<kBK>(sc, smem_desc(sQw + (kk / 4) * T::kQPanel + off, 16),
                  smem_desc(sKs + (kk / 4) * T::kKVPanel + off, 16), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    own(sc);

    // the mask only where the block straddles an edge for this warpgroup
    bool inside = kend < S;
    if (a.causal) inside = inside && kend <= wr0;
    if (a.window) inside = inside && k0 > wr1 - a.window;
    if (a.chunk)
      inside = inside && k0 / a.chunk == kend / a.chunk
               && wr0 / a.chunk == wr1 / a.chunk
               && k0 / a.chunk == wr0 / a.chunk;
    float alpha[2];
    if (inside) softmax_block<false>(sc, m, l, alpha, a, row0, k0 + cq);
    else softmax_block<true>(sc, m, l, alpha, a, row0, k0 + cq);
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];

    // p = p_hi + p_lo as A fragments: k step kk holds keys 16kk..16kk+15,
    // i.e. accumulator columns 8j..8j+7 for j = 2kk (regs 0, 1) and
    // j = 2kk + 1 (regs 2, 3), rows row0 (regs 0, 2) and row0 + 8 (1, 3)
    uint32_t phi[kBK / 16][4], plo[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        const float p0 = sc[x], p1 = sc[x + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(h2);
        phi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
        plo[kk][r] = bf16x2(p0 - hf.x, p1 - hf.y);
      }

    // O += p_hi V + p_lo V
    mbar_wait(v_full(s), parity);
    own(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = smem_desc(sVs + kk * 16 * kRowBytes, T::kKVPanel);
      mma_pv<HD>(o, phi[kk], dv);
      mma_pv<HD>(o, plo[kk], dv);
    }
    wg_commit();
    wg_wait_all();
    own(o);
    own(phi);
    own(plo);
    mbar_arrive(empty(s));
  }

  // o / l, rounded to bf16 once; rows past S are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const size_t q_row = static_cast<size_t>(a.H) * HD;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o)
                      + static_cast<size_t>(b) * S * q_row
                      + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          o[4 * j + 2 * i] / lc, o[4 * j + 2 * i + 1] / lc);
      *reinterpret_cast<__nv_bfloat162*>(og + row * q_row + 8 * j + cq) = v;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The model-layout tensor (B, S, heads, hd) as a 4-D map, innermost first,
// read in boxes of 64 columns x 1 head x `rows` rows with the 128-byte
// swizzle; reads past hd or S are zero filled.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
            int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = 2ull * hd;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int causal, int window,
                   int chunk, float scale, cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, HD, H, S, B, kBQ)
      || !encode(fn, &tk, k, HD, KV, S, B, kBK)
      || !encode(fn, &tv, v, HD, KV, S, B, kBK))
    return cudaErrorInvalidValue;
  auto kern = flash_tc_kernel<HD>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<HD>::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_q = (S + kBQ - 1) / kBQ;
  TcArgs a{out, B, S, H, H / KV, causal, window, chunk, n_q,
           scale * kLog2e};
  kern<<<n_q * H * B, kThreads, Tiles<HD>::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA for head_dim 64, 80 or 128 (0 for any
// other), for reports beside ptxas's registers and spills.
extern "C" int flash_attention_tc_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 64: return Tiles<64>::kSmem;
    case 80: return Tiles<80>::kSmem;
    case 128: return Tiles<128>::kSmem;
    default: return 0;
  }
}

// bf16 q, k, v and output, each contiguous in the model layout and 16-byte
// aligned (TMA); head_dim 64, 80 or 128.  Called by flash_attention_launch
// (flash_attention.cu).  Returns a cudaError_t code.
extern "C" int flash_attention_tc_launch(int head_dim, const void* q,
                                         const void* k, const void* v,
                                         void* out, int B, int S, int H,
                                         int KV, int causal, int window,
                                         int chunk, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(q, k, v, out, B, S, H, KV, causal, window,
                               chunk, scale, st);
    case 80: return launch<80>(q, k, v, out, B, S, H, KV, causal, window,
                               chunk, scale, st);
    case 128: return launch<128>(q, k, v, out, B, S, H, KV, causal, window,
                                 chunk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
