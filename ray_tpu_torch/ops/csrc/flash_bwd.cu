// Flash-attention backward for NVIDIA Hopper (sm_90a): TMA, mbarriers, wgmma
// and a producer warp. bf16 in, f32 sums.
//
// Replaces ray_tpu/ops/attention.py::_fused_bwd_kernel (the Pallas TPU
// kernel that _mha_backward_bhsd launches). Same function, one pass over
// each (q tile, kv tile) pair: it recomputes p = exp(s - lse) from
// s = (q * scale) . k^T in f32 and forms
//   dv += p^T . do      (p rounded to bf16)
//   dp  = do . v^T
//   ds  = p * (dp - delta)          delta = rowsum(do * o)
//   dk += ds^T . (q * scale)        (ds rounded to bf16)
//   dq += ds . (k * scale)
// under a causal mask built from the GLOBAL positions q_off / kv_off. Masked
// entries of p are forced to exactly 0 (the Pallas kernel gets there through
// exp(-1e30 - lse), which is 0 only for a finite lse), and a kv tile that no
// q row sees gets dk = dv = 0.
//
// Rounding. The products take q and k as they are, and the scale is applied
// to their f32 sums: to s before the exponential, to dk before its cast, to
// dq in the cast kernel. With the scale rounded to bf16 (as the TPU kernel
// folds it), this is exactly the TPU kernel's arithmetic when the scale is a
// power of two (hd 64: 0.125). At hd 128 the TPU kernel rounds q * scale and
// k * scale to bf16 before the products and this kernel does not, which moves
// those operands by up to 2**-9 relative (the on-card error is in PERF.md).
//
// What bounds it. At B=24, H=12, S=1024, hd=64 causal (one GPT-2-124M layer
// at the training batch) it reads q, k, v, o, do and lse and writes dq, dk
// and dv, about 300 MB, against 5 products of 2 * hd operations over each
// visible (q, kv) pair, about 97 GFLOP: 90 us at 3.35 TB/s against 98 us at
// 989 TFLOP/s, so operations bound it (0.0978 ms), and only wgmma reaches
// that rate. The design keeps every product on wgmma, every tile copy on
// TMA under the products, and dq's sum across blocks off per-element atomics
// and inside L2.
//
// Design. Three kernels on the caller's stream, launched by one C call:
// - Prologue: delta = rowsum(do * o) and lse * log2(e) in f32 into row
//   buffers padded to whole q tiles (padding rows: delta 0, lse +inf, so a
//   zero-filled q row past Sq gets p = 0), and dq's f32 accumulator zeroed.
// - Main kernel, persistent: one block per SM walks over (128-row kv tile,
//   b*h) work items head by head (work_item), dealt in the forward's snake
//   order. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg.dec) and one thread issues the TMA loads: K and V once per
//   item, then per 64-row q tile q, do (3-D maps [B*H, S, hd], so rows past S
//   read zeros and never the next head's) and the tile's lse and delta rows
//   (1-D bulk copies), into a ring of STAGES stages with full/empty
//   mbarriers. Two consumer warpgroups (setmaxnreg.inc) own 64 kv rows each
//   and hold dk and dv in f32 registers for the whole item. Per q tile,
//   each consumer warpgroup:
//     s^T = K . q^T and dp^T = V . do^T    wgmma, q and do K-major B
//       operands; K and V are register A operands at hd 64 (read from the
//       swizzled tile once an item), shared-memory ones at hd 128
//     p^T, ds^T on the accumulators in registers, packed to bf16 as the A
//       operands of the next two products, and ds^T stored to a swizzled
//       shared tile (double-buffered) that both warpgroups fill
//     dv += p^T . do and dk += ds^T . q    RS wgmma, do and q MN-major
//     dq_part = ds . K[:, its half of hd]  SS wgmma over all 128 kv rows, ds
//       read MN-major from the shared tile, K MN-major
//   and dq_part goes through a swizzled f32 staging tile to one TMA bulk
//   reduce-add (cp.reduce.async.bulk.tensor, .add f32) per 32-column box
//   into the f32 accumulator; the 3-D map drops rows past Sq. dk and dv
//   leave once per item by TMA store from a swizzled staging tile.
// - Epilogue: dq = accumulator * scale, cast to bf16.
// The bulk reduces of different blocks add in the order the blocks run, so
// dq's bits vary from run to run (as the atomics of the design before did).
// A warpgroup waits for each of its products, and the two warpgroups meet
// once a q step; PERF.md lists the schemes that measured slower on an H100
// (dq one step late, p computed under dp's product, double-buffered dq
// staging, dq's cast folded into this kernel).
//
// Tiles. hd 64: 128-row kv tiles, 64-row q tiles, 4 stages. hd 128: the same
// tiles and 3 stages (all the shared memory there is): dk and dv take 128 f32
// registers a thread, s^T and dp^T 64.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 64;                      // q rows per step of the q loop
constexpr int WG_ROWS = 64;                      // kv rows per consumer warpgroup
constexpr int NUM_CONSUMERS = 2;                 // consumer warpgroups
constexpr int BLOCK_N = WG_ROWS * NUM_CONSUMERS; // kv rows per work item
constexpr int NUM_THREADS = 128 * (1 + NUM_CONSUMERS);
constexpr int CONSUMER_WARPS = 4 * NUM_CONSUMERS;
constexpr int LAUNCH_REGS = 168;                 // 65536 / 384, down to a multiple of 8
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// setmaxnreg.inc takes registers only from those the block's producer gave
// back with setmaxnreg.dec; asking for more blocks the consumers for ever
static_assert(NUM_CONSUMERS * (CONSUMER_REGS - LAUNCH_REGS) <= LAUNCH_REGS - PRODUCER_REGS,
              "consumer registers beyond what the producer frees");
constexpr int F32_BOX_COLS = 32;                 // f32 columns of one dq box: 128 bytes
constexpr int ROW_BYTES = BLOCK_M * 4;           // one q tile's lse or delta
constexpr int ROW_PAD = BLOCK_M;                 // row buffers padded to whole q tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;                 // a block's limit on sm_90

template <int HD>
struct Cfg {
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  // hd 64: K and V as register A operands of s^T and dp^T (32 registers),
  // read from shared memory once an item; hd 128 has no registers to spare
  static constexpr bool KV_IN_REGS = HD == 64;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int Q_BOX_BYTES = BLOCK_M * 128;
  static constexpr int KV_BOX_BYTES = BLOCK_N * 128;
  static constexpr int Q_TILE_BYTES = BOXES * Q_BOX_BYTES;     // one q or do tile
  static constexpr int KV_TILE_BYTES = BOXES * KV_BOX_BYTES;   // K or V
  static constexpr int STAGE_BYTES = 2 * Q_TILE_BYTES;         // q then do
  static constexpr int DS_BYTES = BLOCK_N * BLOCK_M * 2;       // one ds^T buffer
  static constexpr int DQ_BOX_BYTES = BLOCK_M * 128;           // 64 rows x 32 f32
  static constexpr int DQ_BYTES = (HD / F32_BOX_COLS) * DQ_BOX_BYTES;
  static constexpr int OUT_BOX_BYTES = WG_ROWS * 128;          // 64 kv rows x 64 bf16
  static constexpr int OUT_WG_BYTES = 2 * BOXES * OUT_BOX_BYTES;  // dk then dv
  static constexpr int V_OFF = KV_TILE_BYTES;
  static constexpr int STAGE_OFF = 2 * KV_TILE_BYTES;
  static constexpr int DS_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;
  // dk and dv's staging at the end of an item reuses ds^T's and dq's
  static constexpr int OUT_OFF = DS_OFF;
  static constexpr int ROWS_OFF = DQ_OFF + DQ_BYTES;           // lse, delta per stage
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * ROW_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
  static_assert(NUM_CONSUMERS * OUT_WG_BYTES <= 2 * DS_BYTES + DQ_BYTES, "dk/dv staging");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

struct Problem {
  int BH, Sq, Skv, q_off, kv_off, causal;
  int n_qt, n_kt;  // 64-row q tiles and 128-row kv tiles per (b, h)
  int sq_pad;      // row stride of the lse and delta buffers
};

// ---- PTX beyond hopper.cuh -----------------------------------------------------

// `bytes` contiguous bytes from global memory to shared memory at dst,
// completion counted on barrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// add one f32 box from shared memory at src into a 3-D map at (column, row,
// b*h), atomically per element; rows past the tensor's end are dropped
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void st_shared_f32x2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// barrier over the 256 threads of both consumer warpgroups
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// keeps the A registers of an RS product alive and unchanged until its wait
template <int K>
__device__ __forceinline__ void pin_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d (+)= A . B with both operands in shared memory by descriptor (TRANS_A,
// TRANS_B = 1: MN-major), f32 accumulate; scale_d = 0 overwrites d
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int N, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma width");
  if constexpr (N == 32) {
    wgmma_m64n32k16_ss<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n64k16_ss<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  }
}

// ---- the backward's own pieces -------------------------------------------------

// Work item -> (kv tile, b*h), head by head: the blocks that run at once
// work on a few heads, so the dq rows they add into stay in L2 (kv tile 0 of
// every head first measured 1.4x slower on an H100: PERF.md). Under a causal
// mask the first kv tiles of a head are the heavy ones; the snake order of
// nth_item gives a block that had kv tile i in one round about tile
// n_kt - 1 - i in the next.
__device__ __forceinline__ void work_item(int w, const Problem& p, int& kt, int& bh) {
  kt = w % p.n_kt;
  bh = w / p.n_kt;
}

// the first q tile that sees any row of the kv tile at kv_start (n_qt: none);
// 64-bit positions, offsets may be anywhere in int32
__device__ __forceinline__ int first_q_tile(int kv_start, const Problem& p) {
  if (!p.causal) return 0;
  const long long row = (long long)p.kv_off + kv_start - p.q_off;  // first row that sees it
  return row <= 0 ? 0 : row >= p.Sq ? p.n_qt : (int)(row / BLOCK_M);
}

template <int HD>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_dk,
                 const __grid_constant__ CUtensorMap tm_dv,
                 const __grid_constant__ CUtensorMap tm_dq,  // f32 accumulator
                 const float* __restrict__ rows,  // lse * log2(e), then delta
                 const Problem p, float scale) {
  using C = Cfg<HD>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sk = base, sv = base + C::V_OFF;
  const uint32_t stage0 = base + C::STAGE_OFF;   // stage s: q then do at stage0 + s * STAGE_BYTES
  const uint32_t ds0 = base + C::DS_OFF;         // ds^T buffer b at ds0 + b * DS_BYTES
  const uint32_t sdq = base + C::DQ_OFF;         // dq staging: HD / 32 boxes
  const uint32_t srows = base + C::ROWS_OFF;     // stage s: lse then delta
  const uint32_t bars = base + C::BAR_OFF;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  const uint32_t full0 = bars + 16, empty0 = bars + 16 + 8 * STAGES;  // + 8 * stage

  const int tid = threadIdx.x;
  const int n_work = p.n_kt * p.BH;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (__shfl_sync(FULL, tid / 128, 0) == 0) {  // warp-uniform to the compiler
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      int it = 0;  // q tiles loaded by this block so far: stage and phase
      for (int n = 0, w; (w = nth_item(n, n_work)) >= 0; ++n) {
        int kt, bh;
        work_item(w, p, kt, bh);
        const int kv_start = kt * BLOCK_N;
        mbar_wait(kv_empty, (n & 1) ^ 1);  // the consumers are done with K and V
        mbar_expect_tx(kv_full, 2 * C::KV_TILE_BYTES);
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b) {
          tma_load_3d(sk + b * C::KV_BOX_BYTES, &tm_k, kv_full, b * BOX_COLS, kv_start, bh);
          tma_load_3d(sv + b * C::KV_BOX_BYTES, &tm_v, kv_full, b * BOX_COLS, kv_start, bh);
        }
        const float* lse_row = rows + (size_t)bh * p.sq_pad;
        const float* delta_row = lse_row + (size_t)p.BH * p.sq_pad;
        for (int j = first_q_tile(kv_start, p); j < p.n_qt; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, C::STAGE_BYTES + 2 * ROW_BYTES);
          const uint32_t qs = stage0 + s * C::STAGE_BYTES, dos = qs + C::Q_TILE_BYTES;
#pragma unroll
          for (int b = 0; b < C::BOXES; ++b) {
            tma_load_3d(qs + b * C::Q_BOX_BYTES, &tm_q, full, b * BOX_COLS, j * BLOCK_M, bh);
            tma_load_3d(dos + b * C::Q_BOX_BYTES, &tm_do, full, b * BOX_COLS, j * BLOCK_M, bh);
          }
          const uint32_t rs = srows + s * 2 * ROW_BYTES;
          bulk_load(rs, lse_row + j * BLOCK_M, ROW_BYTES, full);
          bulk_load(rs + ROW_BYTES, delta_row + j * BLOCK_M, ROW_BYTES, full);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 kv rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = __shfl_sync(FULL, tid / 128, 0) - 1;  // warp-uniform to the compiler
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r0 = warp * 16 + g;           // this thread's kv rows in the warpgroup: r0, r0 + 8
    const float scale_bf = __bfloat162float(__float2bfloat16(scale));
    const float scale_log2 = scale_bf * LOG2E;
    const uint32_t kw = sk + cw * WG_ROWS * 128, vw = sv + cw * WG_ROWS * 128;  // its K, V rows
    // its half of dq's columns: in K (MN-major B of dq = ds . K) and in staging
    const uint32_t k_half = sk + (HD == 64 ? cw * 64 : cw * C::KV_BOX_BYTES);
    const uint32_t dq_stage = sdq + cw * (HD / 64) * C::DQ_BOX_BYTES;
    const uint32_t out_dk = base + C::OUT_OFF + cw * C::OUT_WG_BYTES;
    const uint32_t out_dv = out_dk + C::BOXES * C::OUT_BOX_BYTES;
    int it = 0;  // q tiles consumed by this block so far: stage, phase and ds^T buffer
    for (int n = 0, w; (w = nth_item(n, n_work)) >= 0; ++n) {
      int kt, bh;
      work_item(w, p, kt, bh);
      const int kv_start = kt * BLOCK_N;
      const int wg_start = kv_start + cw * WG_ROWS;  // this warpgroup's first kv row
      float dk[HD / 2], dv[HD / 2];  // m64nHD accumulators
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
      if (tid % 128 == 0) bulk_wait_read();  // the last item's dk, dv stores have read staging
      consumer_sync();
      mbar_wait(kv_full, n & 1);
      constexpr int KV_FRAGS = C::KV_IN_REGS ? HD / 16 : 1;
      uint32_t ka[KV_FRAGS][4], va[KV_FRAGS][4];  // this warpgroup's K, V rows
      if constexpr (C::KV_IN_REGS) {
        const int row = cw * WG_ROWS + r0;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = 2 * (kk % 4), box = (kk / 4) * C::KV_BOX_BYTES + 4 * t;
          const int offs[4] = {swizzled(row, c), swizzled(row + 8, c), swizzled(row, c + 1),
                               swizzled(row + 8, c + 1)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[kk][i] = *reinterpret_cast<const uint32_t*>(smem + box + offs[i]);
            va[kk][i] = *reinterpret_cast<const uint32_t*>(smem + C::V_OFF + box + offs[i]);
          }
        }
      }

      for (int j = first_q_tile(kv_start, p); j < p.n_qt; ++j, ++it) {
        const int s = it % STAGES, q_start = j * BLOCK_M;
        const uint32_t qs = stage0 + s * C::STAGE_BYTES, dos = qs + C::Q_TILE_BYTES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

        // s^T = K . q^T and dp^T = V . do^T: a 16-column step moves 32 bytes
        // along the swizzled rows, and at hd 128 columns 64.. are the second box
        float st[BLOCK_M / 2], dpt[BLOCK_M / 2];
        pin(st);
        pin(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk / 4) * C::Q_BOX_BYTES + (kk % 4) * 32;
          if constexpr (C::KV_IN_REGS) {
            wgmma_rs<BLOCK_M, 0>(st, ka[kk], sw128_desc(qs + col, 0), kk > 0);
          } else {
            wgmma_ss<BLOCK_M, 0, 0>(st, sw128_desc(kw + (kk / 4) * C::KV_BOX_BYTES + (kk % 4) * 32, 0),
                                    sw128_desc(qs + col, 0), kk > 0);
          }
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk / 4) * C::Q_BOX_BYTES + (kk % 4) * 32;
          if constexpr (C::KV_IN_REGS) {
            wgmma_rs<BLOCK_M, 0>(dpt, va[kk], sw128_desc(dos + col, 0), kk > 0);
          } else {
            wgmma_ss<BLOCK_M, 0, 0>(dpt, sw128_desc(vw + (kk / 4) * C::KV_BOX_BYTES + (kk % 4) * 32, 0),
                                    sw128_desc(dos + col, 0), kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait();
        pin(st);
        pin(dpt);

        // p = exp(s - lse), exactly 0 where masked; ds = p * (dp - delta).
        // A mask is needed where a kv row may lie in the future of a q row, or
        // past Skv; a q row past Sq has lse +inf, so p = 0 there anyway.
        const bool need_mask =
            wg_start + WG_ROWS > p.Skv ||
            (p.causal && (long long)p.q_off + q_start < (long long)p.kv_off + wg_start + WG_ROWS - 1);
        int lim[2];  // per kv row: q columns below lim + 2t are masked
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wg_start + r0 + 8 * r;
          long long lo = row >= p.Skv ? BLOCK_M
                         : p.causal ? (long long)p.kv_off + row - p.q_off - q_start
                                    : 0;
          lo = lo < 0 ? 0 : lo > BLOCK_M ? BLOCK_M : lo;
          lim[r] = (int)lo - 2 * t;
        }
        const float* lse_s = reinterpret_cast<const float*>(smem + C::ROWS_OFF + s * 2 * ROW_BYTES);
        const float* delta_s = lse_s + BLOCK_M;
        uint32_t pa[BLOCK_M / 16][4], dsa[BLOCK_M / 16][4];  // bf16 A operands
#pragma unroll
        for (int nt = 0; nt < BLOCK_M / 8; ++nt) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + nt * 8 + 2 * t);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + nt * 8 + 2 * t);
          float pv[4], dsv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[e] = ex2(fmaf(st[nt * 4 + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (need_mask && nt * 8 + (e & 1) < lim[e >> 1]) pv[e] = 0.f;
            dsv[e] = pv[e] * (dpt[nt * 4 + e] - ((e & 1) ? d2.y : d2.x));
          }
          pa[nt / 2][(nt % 2) * 2] = pack_bf16(pv[0], pv[1]);
          pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
          dsa[nt / 2][(nt % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
          dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
        }

        // ds^T into this warpgroup's rows of the shared tile: [128 kv][64 q],
        // 128-byte swizzled, the MN-major A operand of dq = ds . K
        const uint32_t dsb = ds0 + (it & 1) * C::DS_BYTES;
        {
          const uint32_t row_a = dsb + (cw * WG_ROWS + r0) * 128 + 4 * t, swz = g << 4;
#pragma unroll
          for (int nt = 0; nt < BLOCK_M / 8; ++nt) {
            const uint32_t a = row_a + ((nt << 4) ^ swz);
            st_shared_u32(a, dsa[nt / 2][(nt % 2) * 2]);
            st_shared_u32(a + 8 * 128, dsa[nt / 2][(nt % 2) * 2 + 1]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma

        // dv += p^T . do and dk += ds^T . q: do and q are MN-major B operands;
        // a 16-row step moves two 1024-byte row groups, and at hd 128 the
        // second 64-column box is Q_BOX_BYTES further (the leading byte offset)
        pin(dv);
        pin(dk);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < BLOCK_M / 16; ++kq)
          wgmma_rs<HD, 1>(dv, pa[kq], sw128_desc(dos + kq * 2048, C::Q_BOX_BYTES), 1);
#pragma unroll
        for (int kq = 0; kq < BLOCK_M / 16; ++kq)
          wgmma_rs<HD, 1>(dk, dsa[kq], sw128_desc(qs + kq * 2048, C::Q_BOX_BYTES), 1);
        wgmma_commit();
        consumer_sync();  // both warpgroups' rows of ds^T are in the tile
        wgmma_wait();
        pin(dv);
        pin(dk);
        pin_frags(pa);
        pin_frags(dsa);
        // the stage's q, do, lse and delta are read: the next TMA write of it
        // (async proxy) comes after these reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (lane == 0) mbar_arrive(empty0 + 8 * s);

        // dq_part = ds . K[:, this warpgroup's half]: ds^T's rows are the
        // contraction (a 16-row step is 2048 bytes in both operands)
        float dq[HD / 4];
        pin(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk)
          wgmma_ss<HD / 2, 1, 1>(dq, sw128_desc(dsb + kk * 2048, C::DS_BYTES),
                                 sw128_desc(k_half + kk * 2048, C::KV_BOX_BYTES), kk > 0);
        wgmma_commit();
        wgmma_wait();
        pin(dq);

        // dq_part through the f32 staging tile (32-column boxes, 128-byte
        // swizzle) and one bulk reduce-add per box into the accumulator
        if (tid % 128 == 0) bulk_wait_read();  // the last reduce has read the staging
        wg_sync(cw);
        {
          const uint32_t row_a = dq_stage + r0 * 128 + (t & 1) * 8;
#pragma unroll
          for (int nt = 0; nt < HD / 16; ++nt) {
            const uint32_t chunk = (nt % 4) * 2 + (t >> 1);
            const uint32_t a = row_a + (nt / 4) * C::DQ_BOX_BYTES + ((chunk ^ g) << 4);
            st_shared_f32x2(a, dq[nt * 4], dq[nt * 4 + 1]);
            st_shared_f32x2(a + 8 * 128, dq[nt * 4 + 2], dq[nt * 4 + 3]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA
        wg_sync(cw);
        if (tid % 128 == 0) {
#pragma unroll
          for (int b = 0; b < HD / 64; ++b)
            tma_reduce_add_3d(&tm_dq, dq_stage + b * C::DQ_BOX_BYTES,
                              (cw * (HD / 64) + b) * F32_BOX_COLS, q_start, bh);
          bulk_commit();
        }
      }
      // K and V are no longer read (the next TMA write of them, async proxy,
      // comes after the reads of their fragments)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) mbar_arrive(kv_empty);

      // epilogue: dk * scale and dv in bf16 through a swizzled staging tile
      // per warpgroup (over ds^T's and dq's) and one TMA store a 64-column
      // box, which drops kv rows past Skv
      if (tid % 128 == 0) bulk_wait_read();  // the reduces have read dq's staging
      consumer_sync();                       // and both warpgroups are done with ds^T
      {
        const uint32_t row_o = (warp * 16 + g) * 128 + 4 * t, swz = g << 4;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const uint32_t a = row_o + (dt / 8) * C::OUT_BOX_BYTES + (((dt % 8) << 4) ^ swz);
          st_shared_u32(out_dk + a, pack_bf16(dk[dt * 4] * scale_bf, dk[dt * 4 + 1] * scale_bf));
          st_shared_u32(out_dk + a + 8 * 128,
                        pack_bf16(dk[dt * 4 + 2] * scale_bf, dk[dt * 4 + 3] * scale_bf));
          st_shared_u32(out_dv + a, pack_bf16(dv[dt * 4], dv[dt * 4 + 1]));
          st_shared_u32(out_dv + a + 8 * 128, pack_bf16(dv[dt * 4 + 2], dv[dt * 4 + 3]));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA
      wg_sync(cw);
      if (tid % 128 == 0) {
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b) {
          tma_store_3d(&tm_dk, out_dk + b * C::OUT_BOX_BYTES, b * BOX_COLS, wg_start, bh);
          tma_store_3d(&tm_dv, out_dv + b * C::OUT_BOX_BYTES, b * BOX_COLS, wg_start, bh);
        }
        bulk_commit();
      }
    }
    if (tid % 128 == 0) bulk_wait_all();  // the stores are done before the block ends
  }
}

// delta = rowsum(do * o) and lse * log2(e) into row buffers padded to whole
// q tiles (padding: delta 0, lse +inf), and dq's f32 accumulator zeroed. A
// row is HD / 8 threads of one warp, each a 16-byte chunk of o and do.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prologue_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ dq_acc,
                          float* __restrict__ rows, int BH, int Sq, int sq_pad) {
  constexpr int LANES = HD / 8;  // threads per row
  const long long n_rows = (long long)BH * sq_pad;
  const long long stride = (long long)gridDim.x * blockDim.x / LANES;
  const int lane = threadIdx.x % 32, sub = lane % LANES;
  // r0: the first row of this warp, so that every lane of a warp loops alike
  for (long long r0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x - lane) / LANES;
       r0 < n_rows; r0 += stride) {
    const long long r = r0 + lane / LANES;
    const int bh = (int)(r / sq_pad), i = (int)(r % sq_pad);
    const bool real = r < n_rows && i < Sq;
    float d = 0.f;
    if (real) {
      const size_t off = ((size_t)bh * Sq + i) * HD + sub * 8;
      const uint4 a = *reinterpret_cast<const uint4*>(o + off);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
      const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* bh2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(ah[k]), y = __bfloat1622float2(bh2[k]);
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
      }
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dq_acc + off) = zero;
      *reinterpret_cast<float4*>(dq_acc + off + 4) = zero;
    }
#pragma unroll
    for (int m = LANES / 2; m > 0; m >>= 1) d += __shfl_xor_sync(FULL, d, m);
    if (r < n_rows && sub == 0) {
      rows[r] = real ? lse[(size_t)bh * Sq + i] * LOG2E : INFINITY;
      rows[n_rows + r] = d;
    }
  }
}

// dq = accumulator * scale in bf16, 8 values a thread
__global__ void __launch_bounds__(256)
flash_bwd_dq_cast_kernel(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                         long long n8, float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(dq_acc)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(dq_acc)[2 * i + 1];
    const uint4 out = {pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale),
                       pack_bf16(b.x * scale, b.y * scale), pack_bf16(b.z * scale, b.w * scale)};
    reinterpret_cast<uint4*>(dq)[i] = out;
  }
}

// ---- host side --------------------------------------------------------------

int padded_rows(int Sq) { return (Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD; }

// blocks for a grid-stride loop over `n` items of 256-thread blocks
int stride_blocks(long long n, int sms) {
  const long long want = (n + 255) / 256, most = 16LL * sms;
  return (int)(want < most ? want : most);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                   void* scratch, int B, int H, int Sq, int Skv, int q_off, int kv_off,
                   float scale, int causal, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (encoder() == nullptr) return cudaErrorSymbolNotFound;
  const int BH = B * H, sq_pad = padded_rows(Sq);
  float* dq_acc = static_cast<float*>(scratch);
  float* rows = dq_acc + (size_t)BH * Sq * HD;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv, tdq;
  if (!encode(&tq, q, BH, Sq, HD, BLOCK_M) || !encode(&tdo, dout, BH, Sq, HD, BLOCK_M) ||
      !encode(&tk, k, BH, Skv, HD, BLOCK_N) || !encode(&tv, v, BH, Skv, HD, BLOCK_N) ||
      !encode(&tdk, dk, BH, Skv, HD, WG_ROWS) || !encode(&tdv, dv, BH, Skv, HD, WG_ROWS) ||
      !encode_3d(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_acc, BH, Sq, HD, F32_BOX_COLS,
                 BLOCK_M))
    return cudaErrorInvalidValue;
  // once per device: the kernel's shared-memory limit, and the SM count
  static int sm_count[64] = {};  // 0: not yet set on that device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    int sms = 0;
    if ((err = cudaFuncSetAttribute(flash_bwd_kernel<HD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess)
      return err;
    sm_count[device] = sms;
  }
  const int sms = sm_count[device];
  const long long n_rows = (long long)BH * sq_pad;
  flash_bwd_prologue_kernel<HD><<<stride_blocks(n_rows * (HD / 8), sms), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), dq_acc, rows, BH, Sq, sq_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const Problem p{BH, Sq, Skv, q_off, kv_off, causal, (Sq + BLOCK_M - 1) / BLOCK_M,
                  (Skv + BLOCK_N - 1) / BLOCK_N, sq_pad};
  const int work = p.n_kt * p.BH;
  flash_bwd_kernel<HD><<<work < sms ? work : sms, NUM_THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, tdq, rows, p, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n8 = (long long)BH * Sq * HD / 8;
  flash_bwd_dq_cast_kernel<<<stride_blocks(n8, sms), 256, 0, stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), n8, __bfloat162float(__float2bfloat16(scale)));
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous bf16 [B, H, S, hd], 16-byte
// aligned; lse: f32 [B, H, Sq]; scratch: 16-byte aligned, at least
// flash_bwd_scratch_bytes(B * H, Sq, hd) bytes (dq's f32 accumulator, then the
// lse and delta rows). Launches the prologue, the main kernel and dq's cast
// on `stream`; returns the first launch error (0 on success), or an error
// code if the tensor maps cannot be made.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dq, void* dk, void* dv,
                              void* scratch, int B, int H, int Sq, int Skv, int hd, int q_off,
                              int kv_off, float scale, int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, scratch, B, H, Sq, Skv, q_off,
                        kv_off, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, scratch, B, H, Sq, Skv, q_off,
                         kv_off, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of scratch a call at (B * H, Sq, hd) needs.
extern "C" long long flash_bwd_scratch_bytes(int BH, int Sq, int hd) {
  return 4LL * BH * ((long long)Sq * hd + 2LL * padded_rows(Sq));
}

// Dynamic shared memory the main kernel requests at head dim hd, in bytes
// (0 for an hd it does not take).
extern "C" int flash_bwd_smem_bytes(int hd) {
  return hd == 64 ? Cfg<64>::SMEM : hd == 128 ? Cfg<128>::SMEM : 0;
}
