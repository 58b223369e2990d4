// Flash-attention forward for NVIDIA Hopper (sm_90a): TMA, mbarriers, wgmma
// and a producer warp. bf16 in, f32 softmax.
//
// Replaces ray_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel that
// _mha_forward_bhsd launches). Same function: q, k, v in [B, H, S, hd]; the
// softmax scale folded into q once, rounded to bf16 as the TPU kernel does;
// logits and the online-softmax state (m, l, acc) in f32; p cast to bf16
// before p.v; a causal mask built from the GLOBAL positions q_off / kv_off
// (64-bit); kv tiles wholly in the future skipped, the mask applied only on
// diagonal tiles and on the ragged tail when Skv is not a multiple of the
// tile. A row with no visible key gets o = 0 and lse = -1e30.
//
// What bounds it. At the training shape B=24, H=12, S=1024, hd=64 causal it
// must read q, k, v and write o and lse, 152 MB, and do 38.7 GFLOP of
// visible work: 45 us at 3.35 TB/s and 39 us at 989 TFLOP/s on an H100 SXM.
// The shape sits at the ridge, so the copies must run under the products
// and the products must run on wgmma, the only path to the tensor cores'
// full rate; a block must never wait for its own loads.
//
// Design.
// - Persistent grid: one block per SM walks over (128-row q tile, b*h)
//   work items, the latest q tiles of every head first (under a causal mask
//   they carry the most kv tiles), dealt in a snake order so the light tiles
//   fill the tail.
// - Warp specialisation: 3 warpgroups. Warpgroup 0 is the producer: it gives
//   up registers (setmaxnreg.dec) and one thread issues every TMA load. The
//   two consumer warpgroups take the registers (setmaxnreg.inc) and own 64
//   query rows each of the 128-row q tile.
// - TMA: q, k, v and o are 3-D tensor maps [B*H, S, hd], so a box that runs
//   past S reads zeros (and a store drops those rows) and never touches the
//   next head's rows. Boxes are 64 columns (one 128-byte row of bf16) with
//   the 128-byte swizzle that wgmma reads; hd 128 takes two boxes side by
//   side. The maps are encoded on the host at every call and not cached:
//   encoding is a host-only computation of about a microsecond, and the
//   pointers change from call to call.
// - A ring of STAGES K/V stages in shared memory, each with a "full" barrier
//   (the producer's arrive.expect_tx, completed by the TMA's bytes) and an
//   "empty" barrier (one arrival per consumer warp after the wgmma.wait_group
//   that last reads the stage). q has its own full/empty pair, so the next
//   work item's q and first K/V tiles load while the consumers finish the
//   current one.
// - Consumers: q is read once from the swizzled tile, scaled, rounded to bf16
//   and kept in registers as the wgmma A operand. S = (q*scale).k^T is
//   wgmma m64nNk16 with k as a K-major B operand in swizzled shared memory;
//   the online softmax runs on the accumulator layout in registers; p is
//   re-packed as bf16 into the register A operand of o += p.v, and v is read
//   as an MN-major B operand: the transpose is a bit in the instruction, not
//   a copy. A warpgroup waits for each of its products; the other warpgroup
//   runs its softmax meanwhile. (Issuing s_{j+1} before the softmax of tile
//   j, with explicit turns between the warpgroups, measured no faster on an
//   H100: PERF.md.)
// - Epilogue: o / l goes through a swizzled staging tile per warpgroup and
//   one TMA store per 64-column box; lse is written directly.
// - Tile sizes. hd 64: 128-row kv tiles (S accumulator 64 f32, o 32, p 32,
//   q 16 registers a thread), 6 stages, 225 KB of shared memory. hd 128:
//   64-row kv tiles (S 32, o 64, p 16, q 32), 5 stages, 225 KB: 128-row
//   tiles would take 64 KB a stage, leaving room for 2 stages only.
// Kernel times against the bound are in PERF.md.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 128;              // q rows per work item
constexpr int WG_ROWS = 64;               // q rows per consumer warpgroup
constexpr int NUM_CONSUMERS = 2;          // consumer warpgroups
constexpr int NUM_THREADS = 128 * (1 + NUM_CONSUMERS);
constexpr int CONSUMER_WARPS = 4 * NUM_CONSUMERS;
constexpr int PRODUCER_REGS = 40;         // 128 * 40 + 256 * 232 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr float NEG_BIG = -1e30f;         // lse of a row with no visible key
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int BLOCK_N = HD == 64 ? 128 : 64;  // kv rows per tile (see header)
  static constexpr int STAGES = HD == 64 ? 6 : 5;       // K/V stages: all the smem there is
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int Q_BOX_BYTES = BLOCK_M * BOX_COLS * 2;
  static constexpr int KV_BOX_BYTES = BLOCK_N * BOX_COLS * 2;
  static constexpr int Q_BYTES = BOXES * Q_BOX_BYTES;
  static constexpr int KV_TILE_BYTES = BOXES * KV_BOX_BYTES;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_TILE_BYTES;        // K then V
  static constexpr int O_WG_BYTES = BOXES * WG_ROWS * BOX_COLS * 2;  // one warpgroup's o
  static constexpr int O_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = O_OFFSET + NUM_CONSUMERS * O_WG_BYTES;
  // q, the stages, o's staging, the barriers, and 1 KB to align the base
  static constexpr int SMEM = BAR_OFFSET + 8 * (2 + 2 * STAGES) + 1024;
};

struct Problem {
  int BH, Sq, Skv, q_off, kv_off, causal;
  int n_qt;  // 128-row q tiles per (b, h)
};

// ---- the forward's own pieces (the shared ones are in hopper.cuh) -----------

// Work item -> (q tile, b*h): the latest q tiles of every head first (under
// a causal mask they carry the most kv tiles), so the light ones fill the tail
__device__ __forceinline__ void work_item(int w, const Problem& p, int& qt, int& bh) {
  qt = p.n_qt - 1 - w / p.BH;
  bh = w % p.BH;
}

// kv tiles a q tile starting at q_start visits: under a causal mask, those
// not wholly in the future of its last row (64-bit positions)
template <int BLOCK_N>
__device__ __forceinline__ int kv_tiles(int q_start, const Problem& p) {
  const int nk = (p.Skv + BLOCK_N - 1) / BLOCK_N;
  if (!p.causal) return nk;
  const long long last_q = (long long)p.q_off + min(q_start + BLOCK_M, p.Sq) - 1;
  const long long span = last_q - p.kv_off;  // last visible kv index
  const long long tiles = span < 0 ? 0 : span / BLOCK_N + 1;
  return tiles < nk ? (int)tiles : nk;
}

// s = (q * scale) . k^T for the kv tile at shared address ks, committed as
// one group: k is a K-major B operand; a 16-column step moves 32 bytes along
// the swizzled row, and at hd 128 columns 64.. are in the second box
template <int HD, int BLOCK_N>
__device__ __forceinline__ void s_product(float (&sc)[BLOCK_N / 2],
                                          const uint32_t (&qa)[HD / 16][4], uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_rs<BLOCK_N, 0>(
        sc, qa[kk], sw128_desc(ks + (kk / 4) * Cfg<HD>::KV_BOX_BYTES + (kk % 4) * 32, 0),
        kk > 0);
  wgmma_commit();
}

// The online-softmax step of one kv tile, on the s accumulator in registers:
// when `mask`, entries past Skv or in the future of their row (by global
// position) become -inf; then s becomes p = exp(s - max) in place, alpha
// gets the factor that rescales o and l, and l = l * alpha + rowsum(p). A
// row's columns are spread over the 4 threads of a quad. A row with no
// visible key so far keeps max -inf and p = 0.
template <int BLOCK_N>
__device__ __forceinline__ void softmax_step(float (&sc)[BLOCK_N / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], bool mask,
                                             int col0, long long row_g, const Problem& p,
                                             int t) {
  if (mask) {
    // the last visible column of each row, relative to this thread's first
    // column col0 + 2t, in 32 bits: the tile's columns are compile-time
    // offsets from it
    const long long last = p.causal ? row_g - p.kv_off - col0 : (long long)BLOCK_N;
    const long long tail = (long long)p.Skv - 1 - col0;
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      long long v = last + (p.causal ? 8 * r : 0);
      v = v < tail ? v : tail;
      v = v < -1 ? -1 : v > BLOCK_N ? BLOCK_N : v;
      lim[r] = (int)v - 2 * t;
    }
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i)
      if ((i / 4) * 8 + (i & 1) > lim[(i >> 1) & 1]) sc[i] = -INFINITY;
  }
  // row maxima in 4 interleaved chains per row (short dependency chains at
  // few registers)
  constexpr int NT = BLOCK_N / 8;  // column tiles
  static_assert(NT % 4 == 0, "4 chains per row");
  float t0[4], t1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    t0[c] = fmaxf(sc[c * 4], sc[c * 4 + 1]);
    t1[c] = fmaxf(sc[c * 4 + 2], sc[c * 4 + 3]);
  }
#pragma unroll
  for (int nt = 4; nt < NT; ++nt) {
    t0[nt % 4] = fmaxf(t0[nt % 4], fmaxf(sc[nt * 4], sc[nt * 4 + 1]));
    t1[nt % 4] = fmaxf(t1[nt % 4], fmaxf(sc[nt * 4 + 2], sc[nt * 4 + 3]));
  }
  float mx[2] = {fmaxf(fmaxf(m[0], fmaxf(t0[0], t0[1])), fmaxf(t0[2], t0[3])),
                 fmaxf(fmaxf(m[1], fmaxf(t1[0], t1[1])), fmaxf(t1[2], t1[3]))};
  float mb[2];  // the row's base in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    mb[r] = mx[r] == -INFINITY ? 0.f : mx[r] * LOG2E;
    alpha[r] = ex2(fmaf(m[r], LOG2E, -mb[r]));
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i)
    sc[i] = ex2(fmaf(sc[i], LOG2E, -mb[(i >> 1) & 1]));  // p = exp(s - max)
  // row sums of p, in 4 interleaved chains per row
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    t0[c] = sc[c * 4] + sc[c * 4 + 1];
    t1[c] = sc[c * 4 + 2] + sc[c * 4 + 3];
  }
#pragma unroll
  for (int nt = 4; nt < NT; ++nt) {
    t0[nt % 4] += sc[nt * 4] + sc[nt * 4 + 1];
    t1[nt % 4] += sc[nt * 4 + 2] + sc[nt * 4 + 3];
  }
  t0[0] = (t0[0] + t0[1]) + (t0[2] + t0[3]);
  t1[0] = (t1[0] + t1[1]) + (t1[2] + t1[3]);
  l[0] = l[0] * alpha[0] + t0[0];
  l[1] = l[1] * alpha[1] + t1[0];
}

template <int HD>
__device__ __forceinline__ void rescale_o(float (&acc)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// p packed as bf16 into the A operand of o += p.v: k-step kt takes the
// accumulator's column tiles 2kt and 2kt + 1
template <int BLOCK_N>
__device__ __forceinline__ void pack_p(const float (&sc)[BLOCK_N / 2],
                                       uint32_t (&pa)[BLOCK_N / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
    pa[nt / 2][(nt % 2) * 2] = pack_bf16(sc[nt * 4], sc[nt * 4 + 1]);
    pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(sc[nt * 4 + 2], sc[nt * 4 + 3]);
  }
}

// o += p . v for one kv tile at shared address vs, committed as one group:
// v is an MN-major B operand (transposed by the instruction); a 16-row step
// moves two 1024-byte row groups, and at hd 128 the second 64-column box is
// KV_BOX_BYTES further (the leading byte offset)
template <int HD, int BLOCK_N>
__device__ __forceinline__ void pv_product(float (&acc)[HD / 2],
                                           const uint32_t (&pa)[BLOCK_N / 16][4],
                                           uint32_t vs) {
#pragma unroll
  for (int kt = 0; kt < BLOCK_N / 16; ++kt)
    wgmma_rs<HD, 1>(acc, pa[kt], sw128_desc(vs + kt * 2048, Cfg<HD>::KV_BOX_BYTES), 1);
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse,
                 const Problem p, float scale) {
  using C = Cfg<HD>;
  constexpr int BLOCK_N = C::BLOCK_N, STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sq = base;                      // q: BOXES boxes of [128 rows][64 cols]
  const uint32_t skv = base + C::Q_BYTES;        // stage s: K then V at skv + s * STAGE_BYTES
  const uint32_t so = base + C::O_OFFSET;        // warpgroup cw's o at so + cw * O_WG_BYTES
  const uint32_t bars = base + C::BAR_OFFSET;
  const uint32_t q_full = bars, q_empty = bars + 8;
  const uint32_t full0 = bars + 16, empty0 = bars + 16 + 8 * STAGES;  // + 8 * stage

  const int tid = threadIdx.x;
  const int n_work = p.n_qt * p.BH;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
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
      int it = 0;  // kv tiles loaded by this block so far: stage and phase
      for (int n = 0, w; (w = nth_item(n, n_work)) >= 0; ++n) {
        int qt, bh;
        work_item(w, p, qt, bh);
        const int q_start = qt * BLOCK_M;
        mbar_wait(q_empty, (n & 1) ^ 1);  // the consumers hold q in registers
        mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b)
          tma_load_3d(sq + b * C::Q_BOX_BYTES, &tm_q, q_full, b * BOX_COLS, q_start, bh);
        const int n_tiles = kv_tiles<BLOCK_N>(q_start, p);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, C::STAGE_BYTES);
          const uint32_t ks = skv + s * C::STAGE_BYTES, vs = ks + C::KV_TILE_BYTES;
#pragma unroll
          for (int b = 0; b < C::BOXES; ++b) {
            tma_load_3d(ks + b * C::KV_BOX_BYTES, &tm_k, full, b * BOX_COLS, j * BLOCK_N, bh);
            tma_load_3d(vs + b * C::KV_BOX_BYTES, &tm_v, full, b * BOX_COLS, j * BLOCK_N, bh);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = __shfl_sync(FULL, tid / 128, 0) - 1;  // warp-uniform to the compiler
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r0 = cw * WG_ROWS + warp * 16 + g;  // this thread's tile rows: r0, r0 + 8
    const float scale_bf = __bfloat162float(__float2bfloat16(scale));
    int it = 0;  // kv tiles consumed by this block so far: stage and phase
    for (int n = 0, w; (w = nth_item(n, n_work)) >= 0; ++n) {
      int qt, bh;
      work_item(w, p, qt, bh);
      const int q_start = qt * BLOCK_M;
      const int n_tiles = kv_tiles<BLOCK_N>(q_start, p);
      // kv tiles visible to every row of this warpgroup, unmasked
      int n_full = p.Skv / BLOCK_N;
      if (p.causal) {
        const long long seen = (long long)p.q_off + q_start + cw * WG_ROWS - p.kv_off + 1;
        const long long full_tiles = seen < 0 ? 0 : seen / BLOCK_N;
        if (full_tiles < n_full) n_full = (int)full_tiles;
      }

      // q * scale in bf16 (as the TPU kernel folds it), as wgmma A fragments
      mbar_wait(q_full, n & 1);
      uint32_t qa[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const unsigned char* box = smem + (kk / 4) * C::Q_BOX_BYTES + 4 * t;
        const int c = 2 * (kk % 4);
        const int offs[4] = {swizzled(r0, c), swizzled(r0 + 8, c), swizzled(r0, c + 1),
                             swizzled(r0 + 8, c + 1)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(box + offs[i]));
          qa[kk][i] = pack_bf16(f.x * scale_bf, f.y * scale_bf);
        }
      }
      // the next TMA write of q (async proxy) comes after these reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);

      float m[2] = {-INFINITY, -INFINITY};  // running max, natural units
      float l[2] = {0.f, 0.f};
      float acc[HD / 2];  // o: HD / 8 column tiles x 4, the m64nHD accumulator
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float sc[BLOCK_N / 2];         // s, then p in f32: the m64nBLOCK_N accumulator
      uint32_t pa[BLOCK_N / 16][4];  // p in bf16: the A operand of o += p.v
      const long long row_g = (long long)p.q_off + q_start + r0;

      // Per kv tile: s = q.k^T, the online softmax on the accumulator in
      // registers, o += p.v, then the stage goes back to the producer. A
      // warpgroup waits for each of its products; the other warpgroup's
      // softmax runs meanwhile.
      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const uint32_t kv = skv + s * C::STAGE_BYTES;
        pin(sc);
        wgmma_fence();
        s_product<HD, BLOCK_N>(sc, qa, kv);
        wgmma_wait();
        pin(sc);
        float alpha[2];  // the factor o and l are rescaled by
        softmax_step<BLOCK_N>(sc, m, l, alpha, j >= n_full, j * BLOCK_N, row_g, p, t);
        pack_p<BLOCK_N>(sc, pa);
        rescale_o<HD>(acc, alpha);
        pin(acc);
        wgmma_fence();
        pv_product<HD, BLOCK_N>(acc, pa, kv + C::KV_TILE_BYTES);
        wgmma_wait();
        pin(acc);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }

      // epilogue: o = acc / l in bf16, lse = m + log(l); l == 0 gives 0, -1e30.
      // o goes through this warpgroup's swizzled staging tile in shared
      // memory and one TMA store a 64-column box, which drops rows past Sq.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
      }
      const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
      const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
      const uint32_t stage_o = so + cw * C::O_WG_BYTES;
      // this thread's rows in the staging tile are warp * 16 + g and 8 rows
      // further; both swizzle their 16-byte chunks by g
      const uint32_t row_o = stage_o + (warp * 16 + g) * 128 + 4 * t, swz = g << 4;
      if (tid % 128 == 0) bulk_wait_read();  // the last item's store has read the tile
      wg_sync(cw);
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const uint32_t a = row_o + (dt / 8) * (WG_ROWS * 128) + (((dt % 8) << 4) ^ swz);
        st_shared_u32(a, pack_bf16(acc[dt * 4] * inv0, acc[dt * 4 + 1] * inv0));
        st_shared_u32(a + 8 * 128, pack_bf16(acc[dt * 4 + 2] * inv1, acc[dt * 4 + 3] * inv1));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA
      wg_sync(cw);
      if (tid % 128 == 0) {
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b)
          tma_store_3d(&tm_o, stage_o + b * (WG_ROWS * 128), b * BOX_COLS,
                       q_start + cw * WG_ROWS, bh);
        bulk_commit();
      }
      const int row0 = q_start + r0, row1 = row0 + 8;
      if (t == 0) {
        float* lp = lse + (size_t)bh * p.Sq;
        if (row0 < p.Sq) lp[row0] = l[0] > 0.f ? m[0] + logf(l[0]) : NEG_BIG;
        if (row1 < p.Sq) lp[row1] = l[1] > 0.f ? m[1] + logf(l[1]) : NEG_BIG;
      }
    }
    if (tid % 128 == 0) bulk_wait_all();  // the stores are done before the block ends
  }
}

// ---- host side --------------------------------------------------------------

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int H, int Sq, int Skv, int q_off, int kv_off, float scale,
                   int causal, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (encoder() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  if (!encode(&tq, q, B * H, Sq, HD, BLOCK_M) || !encode(&tk, k, B * H, Skv, HD, C::BLOCK_N) ||
      !encode(&tv, v, B * H, Skv, HD, C::BLOCK_N) || !encode(&to, o, B * H, Sq, HD, WG_ROWS))
    return cudaErrorInvalidValue;
  // once per device: the kernel's shared-memory limit, and the SM count
  static int sm_count[64] = {};  // 0: not yet set on that device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    int sms = 0;
    if ((err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess)
      return err;
    sm_count[device] = sms;
  }
  const int sms = sm_count[device];
  const Problem p{B * H, Sq, Skv, q_off, kv_off, causal, (Sq + BLOCK_M - 1) / BLOCK_M};
  const int work = p.n_qt * p.BH;
  flash_fwd_kernel<HD><<<work < sms ? work : sms, NUM_THREADS, C::SMEM, stream>>>(
      tq, tk, tv, to, static_cast<float*>(lse), p, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 [B, H, S, hd], 16-byte aligned; lse: f32
// [B, H, Sq]. Returns the launch's cudaGetLastError() (0 on success), or
// an error code if the tensor maps cannot be made.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Sq,
                              int Skv, int hd, int q_off, int kv_off,
                              float scale, int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Sq, Skv, q_off, kv_off, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Sq, Skv, q_off, kv_off, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a launch at head dim hd requests, in bytes (0 for
// an hd the kernel does not take).
extern "C" int flash_fwd_smem_bytes(int hd) {
  return hd == 64 ? Cfg<64>::SMEM : hd == 128 ? Cfg<128>::SMEM : 0;
}
