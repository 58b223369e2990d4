// Flash-attention backward for NVIDIA Hopper (sm_90a), bf16 in, f32 sums.
//
// Replaces ray_tpu/ops/attention.py::_fused_bwd_kernel (the Pallas TPU
// kernel that _mha_backward_bhsd launches). Same function, one pass over
// each (q tile, kv tile) pair: with qs = q * scale and k_scaled = k * scale
// rounded to bf16, it recomputes p = exp(qs . k^T - lse) in f32 and forms
//   dv += p^T . do      (p rounded to bf16)
//   dp  = do . v^T
//   ds  = p * (dp - delta)          delta = rowsum(do * o), from the caller
//   dk += ds^T . qs     (ds rounded to bf16; no further scale)
//   dq += ds . k_scaled
// under a causal mask built from the GLOBAL positions q_off / kv_off. Masked
// entries of p are forced to exactly 0 (the Pallas kernel gets there through
// exp(-1e30 - lse), which is 0 only for a finite lse). dk and dv are
// written once, in bf16; dq is summed in an f32 [B, H, Sq, hd] buffer that
// the caller zeroes and casts after the launch.
//
// Design. One thread block per (b, h, 64-row kv tile), 4 warps, kv-major:
// each warp owns 16 kv rows and computes s^T = k . qs^T and dp^T = v . do^T,
// so p^T and ds^T come out of the f32 accumulators already laid out as the
// A fragments of dv += p^T . do and dk += ds^T . qs, and dk, dv stay in
// registers across the whole q loop. K, V and k_scaled sit in shared memory
// for the block's life. The block walks the q tiles from the first one the
// causal mask lets see its kv tile; q and do tiles (and lse, delta) are
// double-buffered by cp.async, rows past Sq zero-filled. For dq, ds^T is
// staged in shared memory and read back transposed by ldmatrix.trans as
// the A fragment of ds . k_scaled; each warp takes a 16-row x 64-column
// piece of the tile's dq and adds it into the f32 buffer with atomicAdd
// (the TPU keeps dq as a whole-row block resident in VMEM across kv steps,
// which a Hopper SM has no room or ordering for). The atomics make the bits
// of dq depend on the order the blocks run in. hd = 64 takes 64-row q
// tiles; hd = 128 takes 32-row q tiles so that dk and dv (128 registers a
// thread) leave room for the rest.
//
// What bounds it. At B=24, H=12, S=1024, hd=64 causal (one GPT-2-124M
// layer at the training batch) it reads q, k, v, o, do and lse and writes
// dq, dk and dv, about 300 MB, against 5 products of 2 * hd operations over
// each visible (q, kv) pair, about 97 GFLOP: 90 us at 3.35 TB/s against
// 98 us at 989 TFLOP/s, so operations bound it, and only wgmma reaches that
// rate. This version stays on mma.sync with one tile of copy in flight and
// pays for dq's atomics in L2; its time against the bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_N = 64;                  // kv rows per thread block
constexpr int NUM_WARPS = BLOCK_N / 16;      // each warp owns 16 kv rows
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;                       // bf16 of padding per smem row

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four 8x8 bf16 matrices, transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// 8 bf16 (one 16-byte chunk) times s, each product rounded to bf16
__device__ __forceinline__ void scale_chunk(__nv_bfloat16* p, float s) {
  uint4 raw = *reinterpret_cast<uint4*>(p);
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pr[i]);
    pr[i] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

template <int HD, int BLOCK_M>
struct Smem {
  static constexpr int LDS = HD + PAD;            // row stride of the hd-wide tiles
  static constexpr int LDP = BLOCK_M + PAD;       // row stride of ds^T
  static constexpr int KV_TILE = BLOCK_N * LDS;   // K, V, k_scaled
  static constexpr int Q_TILE = BLOCK_M * LDS;    // one q or do buffer
  static constexpr int BYTES =
      (3 * KV_TILE + 4 * Q_TILE + BLOCK_N * LDP) * 2 + 4 * BLOCK_M * 4;
};

template <int HD, int BLOCK_M>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv,
                 int H, int Sq, int Skv, int q_off, int kv_off, float scale,
                 int causal) {
  using S = Smem<HD, BLOCK_M>;
  constexpr int LDS = S::LDS, LDP = S::LDP;
  constexpr int CHUNKS = HD / 8;                  // 16-byte chunks per row
  constexpr int MT = BLOCK_M / 8;                 // n8 tiles across a q tile
  constexpr int DQ_ROW_GROUPS = BLOCK_M / 16;     // dq pieces: 16 q rows x 64 cols
  static_assert(DQ_ROW_GROUPS * (HD / 64) == NUM_WARPS, "one dq piece per warp");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + S::KV_TILE;
  __nv_bfloat16* KSs = Vs + S::KV_TILE;           // k * scale, bf16
  __nv_bfloat16* Qs = KSs + S::KV_TILE;           // [2][BLOCK_M][LDS], scaled in place
  __nv_bfloat16* DOs = Qs + 2 * S::Q_TILE;        // [2][BLOCK_M][LDS]
  __nv_bfloat16* DSs = DOs + 2 * S::Q_TILE;       // ds^T: [BLOCK_N][LDP]
  float* Ls = reinterpret_cast<float*>(DSs + BLOCK_N * LDP);  // [2][BLOCK_M]
  float* Dl = Ls + 2 * BLOCK_M;                                 // [2][BLOCK_M]

  const int kv_start = blockIdx.x * BLOCK_N;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const __nv_bfloat16* qp = q + bh * Sq * HD;
  const __nv_bfloat16* dop = dout + bh * Sq * HD;
  const float* lp = lse + bh * Sq;
  const float* dlp = delta + bh * Sq;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int r0 = warp * 16 + g;           // this thread's kv rows: r0 and r0 + 8

  // q tiles to visit: from the first whose last row sees this kv tile's
  // first column (64-bit: offsets may be anywhere in int32)
  const int nq = (Sq + BLOCK_M - 1) / BLOCK_M;
  int first = 0;
  if (causal) {
    const long long row = (long long)kv_off + kv_start - q_off;  // first row that sees it
    first = row <= 0 ? 0 : (row >= Sq ? nq : (int)(row / BLOCK_M));
  }

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dt][i] = dv_acc[dt][i] = 0.f;

  if (first < nq) {
    const __nv_bfloat16* kp = k + bh * Skv * HD;
    const __nv_bfloat16* vp = v + bh * Skv * HD;
    for (int c = tid; c < BLOCK_N * CHUNKS; c += NUM_THREADS) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const bool valid = kv_start + r < Skv;
      const size_t off = valid ? (size_t)(kv_start + r) * HD + col : 0;
      cp_async_16(Ks + r * LDS + col, kp + off, valid);
      cp_async_16(Vs + r * LDS + col, vp + off, valid);
    }
  }
  // start copying q tile `tile` (with do, lse and delta) into buffer `buf`
  auto load_q = [&](int tile, int buf) {
    const int q_start = tile * BLOCK_M;
    for (int c = tid; c < BLOCK_M * CHUNKS; c += NUM_THREADS) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const bool valid = q_start + r < Sq;
      const size_t off = valid ? (size_t)(q_start + r) * HD + col : 0;
      cp_async_16(Qs + buf * S::Q_TILE + r * LDS + col, qp + off, valid);
      cp_async_16(DOs + buf * S::Q_TILE + r * LDS + col, dop + off, valid);
    }
    if (tid < 2 * BLOCK_M) {
      const int r = tid % BLOCK_M;
      const bool valid = q_start + r < Sq;
      const int src = valid ? q_start + r : 0;
      if (tid < BLOCK_M)
        cp_async_4(Ls + buf * BLOCK_M + r, lp + src, valid);
      else
        cp_async_4(Dl + buf * BLOCK_M + r, dlp + src, valid);
    }
  };
  if (first < nq) load_q(first, 0);
  cp_async_commit();

  // the scale in bf16, as the TPU kernel folds it into q and k
  const float scale_bf = __bfloat162float(__float2bfloat16(scale));
  // ldmatrix.x4.trans addressing. B fragments of two n8 tiles from a
  // row-major [k][n] tile: lane l addresses row l % 8 (+8 for lanes 8-15
  // and 24-31) at column (l / 16) * 8. A fragment of a 16x16 tile stored
  // transposed ([k][m]): matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
  // (m 0-7, k 8-15), (m 8-15, k 8-15).
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;
  const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8, a_col = ((lane >> 3) & 1) * 8;
  const long long kv_g0 = (long long)kv_off + kv_start;  // global position of kv row 0

  for (int j = first; j < nq; ++j) {
    const int buf = (j - first) & 1;
    const int q_start = j * BLOCK_M;
    if (j + 1 < nq) load_q(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();  // tile j (and K, V) have landed
    __syncthreads();
    __nv_bfloat16* Qb = Qs + buf * S::Q_TILE;
    const __nv_bfloat16* DOb = DOs + buf * S::Q_TILE;
    const float* Lb = Ls + buf * BLOCK_M;
    const float* Db = Dl + buf * BLOCK_M;
    for (int c = tid; c < BLOCK_M * CHUNKS; c += NUM_THREADS)
      scale_chunk(Qb + (c / CHUNKS) * LDS + (c % CHUNKS) * 8, scale_bf);
    if (j == first) {
      for (int c = tid; c < BLOCK_N * CHUNKS; c += NUM_THREADS) {
        const int off = (c / CHUNKS) * LDS + (c % CHUNKS) * 8;
        *reinterpret_cast<uint4*>(KSs + off) = *reinterpret_cast<const uint4*>(Ks + off);
        scale_chunk(KSs + off, scale_bf);
      }
    }
    __syncthreads();

    // s^T = k . qs^T and dp^T = v . do^T for this warp's 16 kv rows, f32
    float st[MT][4], dpt[MT][4];
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* kr = Ks + r0 * LDS + kk * 16 + 2 * t;
      const __nv_bfloat16* vr = Vs + r0 * LDS + kk * 16 + 2 * t;
      const uint32_t ka[4] = {ld_u32(kr), ld_u32(kr + 8 * LDS), ld_u32(kr + 8),
                              ld_u32(kr + 8 * LDS + 8)};
      const uint32_t va[4] = {ld_u32(vr), ld_u32(vr + 8 * LDS), ld_u32(vr + 8),
                              ld_u32(vr + 8 * LDS + 8)};
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) {
        const __nv_bfloat16* qr = Qb + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
        const __nv_bfloat16* dr = DOb + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_16816(st[nt], ka, ld_u32(qr), ld_u32(qr + 8));
        mma_16816(dpt[nt], va, ld_u32(dr), ld_u32(dr + 8));
      }
    }

    // p = exp(s - lse), exactly 0 where masked; ds = p * (dp - delta).
    // A mask is needed on the diagonal and on a ragged q or kv tail.
    const bool masked =
        q_start + BLOCK_M > Sq || kv_start + BLOCK_N > Skv ||
        (causal && (long long)q_off + q_start < kv_g0 + BLOCK_N - 1);
    uint32_t pa[BLOCK_M / 16][4], dsa[BLOCK_M / 16][4];  // bf16 A fragments
#pragma unroll
    for (int nt = 0; nt < MT; ++nt) {
      const int c = nt * 8 + 2 * t;  // q column of entries 0 and 2; +1 for 1, 3
      const float2 l2 = *reinterpret_cast<const float2*>(Lb + c);
      const float2 d2 = *reinterpret_cast<const float2*>(Db + c);
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c + (i & 1), row = r0 + (i >> 1) * 8;
        p[i] = __expf(st[nt][i] - ((i & 1) ? l2.y : l2.x));
        if (masked) {
          const bool hidden = q_start + col >= Sq || kv_start + row >= Skv ||
                              (causal && kv_g0 + row > (long long)q_off + q_start + col);
          if (hidden) p[i] = 0.f;
        }
        ds[i] = p[i] * (dpt[nt][i] - ((i & 1) ? d2.y : d2.x));
      }
      pa[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      // ds^T to shared memory for dq
      *reinterpret_cast<uint32_t*>(DSs + r0 * LDP + c) = dsa[nt / 2][(nt % 2) * 2];
      *reinterpret_cast<uint32_t*>(DSs + (r0 + 8) * LDP + c) =
          dsa[nt / 2][(nt % 2) * 2 + 1];
    }

    // dv += p^T . do and dk += ds^T . qs; do and qs are row-major [q][hd]
#pragma unroll
    for (int kt = 0; kt < BLOCK_M / 16; ++kt) {
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, DOb + (kt * 16 + b_row) * LDS + dt * 8 + b_col);
        mma_16816(dv_acc[dt], pa[kt], b[0], b[1]);
        mma_16816(dv_acc[dt + 1], pa[kt], b[2], b[3]);
        ldmatrix_x4_trans(b, Qb + (kt * 16 + b_row) * LDS + dt * 8 + b_col);
        mma_16816(dk_acc[dt], dsa[kt], b[0], b[1]);
        mma_16816(dk_acc[dt + 1], dsa[kt], b[2], b[3]);
      }
    }
    __syncthreads();  // ds^T is complete

    // dq[16 q rows, 64 cols] += ds . k_scaled: this warp's piece
    {
      const int qg = warp % DQ_ROW_GROUPS, hc = warp / DQ_ROW_GROUPS;
      float acc[8][4];
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < BLOCK_N / 16; ++kt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, DSs + (kt * 16 + a_row) * LDP + qg * 16 + a_col);
#pragma unroll
        for (int dt = 0; dt < 8; dt += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, KSs + (kt * 16 + b_row) * LDS + hc * 64 + dt * 8 + b_col);
          mma_16816(acc[dt], a, b[0], b[1]);
          mma_16816(acc[dt + 1], a, b[2], b[3]);
        }
      }
      const int row0 = q_start + qg * 16 + g, row1 = row0 + 8;
      float* dqp = dq + bh * Sq * HD + hc * 64 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        if (row0 < Sq) {
          atomicAdd(dqp + (size_t)row0 * HD + dt * 8, acc[dt][0]);
          atomicAdd(dqp + (size_t)row0 * HD + dt * 8 + 1, acc[dt][1]);
        }
        if (row1 < Sq) {
          atomicAdd(dqp + (size_t)row1 * HD + dt * 8, acc[dt][2]);
          atomicAdd(dqp + (size_t)row1 * HD + dt * 8 + 1, acc[dt][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with `buf` and ds^T before reuse
  }

  // dk, dv in bf16; rows past Skv are not written
  const int row0 = kv_start + r0, row1 = row0 + 8;
  __nv_bfloat16* dkp = dk + bh * Skv * HD;
  __nv_bfloat16* dvp = dv + bh * Skv * HD;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Skv) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)row0 * HD + col) =
          pack_bf16(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)row0 * HD + col) =
          pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (row1 < Skv) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)row1 * HD + col) =
          pack_bf16(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)row1 * HD + col) =
          pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int HD, int BLOCK_M>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv,
                   int B, int H, int Sq, int Skv, int q_off, int kv_off, float scale,
                   int causal, cudaStream_t stream) {
  // K, V, k_scaled, two q and two do buffers, ds^T, lse and delta:
  // 75 KB at hd = 64, 93 KB at hd = 128
  constexpr int smem = Smem<HD, BLOCK_M>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<HD, BLOCK_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + BLOCK_N - 1) / BLOCK_N, H, B);
  flash_bwd_kernel<HD, BLOCK_M><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, q_off, kv_off, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv: contiguous bf16 [B, H, S, hd], 16-byte aligned;
// lse, delta: f32 [B, H, Sq]; dq: f32 [B, H, Sq, hd], zeroed by the caller.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              void* dq, void* dk, void* dv, int B, int H, int Sq,
                              int Skv, int hd, int q_off, int kv_off, float scale,
                              int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Skv,
                            q_off, kv_off, scale, causal, s);
    case 128:
      return launch<128, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Skv,
                             q_off, kv_off, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
