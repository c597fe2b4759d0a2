// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of kernel 13.
//
// Replaces no TPU kernel: the reference trains through chunked_attention
// (src/repro/models/lm/attention.py:102), an XLA scan that jax.grad
// differentiates, and never differentiates its Pallas flash_attention
// (src/repro/kernels/flash_attention.py:71).  The port maps
// chunked_attention onto kernel 13 (flash_attention_fwd.cu), so its
// gradient on the card needs a kernel of its own.
//
// The function (FlashAttention-2's backward, as flash_attention_bwd_plain
// writes it in fp32): q (B, Sq, H, hd) and k/v (B, Sk, KV, hd), q head h
// reading KV head h % KV; o and dO like q; lse (B, H, Sq) fp32, the
// forward's log-sum-exp of each row's scaled scores (natural units).
//   D  = rowsum(dO * O)                       (B, H, Sq)
//   P  = exp(S * scale - lse), S = Q K^T       (masked: 0)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// dK and dV of KV head j sum over the q heads j, j + KV, j + 2 KV, ... that
// read it.  Every sum is fp32; dQ, dK, dV are written in the input dtype
// (fp32 or bf16).  The causal mask is by absolute position,
// q_offset + i >= j; keys past Sk and rows past Sq are masked.  Head dims
// 32, 64 and 128.  No atomics, in three launches on the caller's stream:
// every output element has one owner, so two launches on the same inputs
// are bit-equal.
//
// Bound on the H100: at the qwen3-0.6b training shape (B 4, S 1024, H 16,
// KV 8, hd 64, bf16, causal) the causal half of 5 products of
// 2 B H S^2 hd operations (21.5 GFLOP) at the bf16 tensor-core peak,
// 0.0217 ms (the 50.6 MB it moves take 0.015 ms).
//
// bf16 (training's path): D, then two warp-specialised tensor-core kernels.
// They are bound by the tensor cores.  One bf16 rounding of P or of dS
// leaves dQ, dK or dV more than one bf16 ulp from the plain version, which
// keeps both in fp32; so P and dS go in as bf16 hi + lo (split_bf16, as
// kernel 13 carries P), and each of the three products that take one of
// them (dV, dK, dQ) runs twice.  With S and dP made in both kernels, the
// tensor cores do 10 products against the function's 5: 0.043 ms at the
// peak.
//  1. D = rowsum(dO * O): one warp a (b, row, h), into the (B, H, Sq)
//     scratch.
//  2. dK/dV: one block a (b, KV head, 128-key tile), the heaviest (first)
//     key tiles first.  Two consumer warpgroups own 64 keys each; one warp
//     of a producer warpgroup loads, and setmaxnreg moves registers from
//     the producer (40) to the consumers (232).  K and V of the block's
//     keys arrive once by TMA and stay in shared memory.  A ring of kStages
//     stages carries the 64-row (Q, dO) tiles of every q head that reads
//     the KV head (causal: from the tile that holds row k0 - q_offset on),
//     TMA loads in the 128-byte (hd 32: 64-byte) swizzle, with their rows'
//     lse (times log2 e; +inf past Sq) and D, which the producer warp's
//     lanes store beside them before they arrive on the stage's barrier.
//     Per stage, S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with
//     both operands in shared memory; P^T = exp2(S^T scale log2 e -
//     lse log2 e) (one FFMA before ex2) and dS^T = P^T (dP^T - D) are made
//     in the accumulator's layout, the diagonal and ragged tiles masked
//     explicitly; then dV += P^T dO and dK += dS^T Q are wgmma m64nHDk16
//     with A from registers (hi, then lo) and B the stage's dO / Q tile
//     read MN-major.  dK and dV stay in registers for the whole walk (HD/2
//     fp32 each a thread); dK is scaled once at the end.  A warpgroup that
//     no row of a stage sees releases it untouched; a key tile that no row
//     sees writes zeros.  Each warpgroup waits for its stage's products
//     before the next stage: the two warpgroups interleave on the tensor
//     cores, and issuing stage u's S^T / dP^T beside stage u - 1's
//     dV / dK products (as the dQ kernel does) measured no faster at hd 64
//     (S^T and dP^T read 4 KB of shared memory per 64 x 64 x 16 product,
//     as much as the SM reads in the product's tensor-core time).
//  3. dQ: kernel 13's shape.  One block a (b * h, 128-row q tile), the
//     heaviest (last) tiles first; Q and dO stay in shared memory, K and V
//     go through a ring of 64-key stages.  S = Q K^T and dP = dO V^T from
//     shared memory, dS in registers, dQ += dS K with A from registers
//     (hi + lo) and K read MN-major.  Tile t's S and dP are issued together
//     with tile t - 1's dS K, so that product runs during tile t's
//     exponentials.
// TMA takes 16-byte aligned bases: a misaligned tensor returns
// cudaErrorMisalignedAddress before anything is launched.
//
// fp32 (the parity path): the scalar kernels below, fp32 FMAs from padded
// shared-memory tiles, which match the plain version to fp32 rounding
// (TF32 would not): dK/dV a (b, KV head, 64-key tile), dQ a (b, q head,
// 64-row tile).  A warp owns 16 rows of a 64 x 64 tile; lane (rg, cg)
// holds rows rg + 4i and columns cg + 8j, so every shared-memory access is
// conflict-free or a broadcast.
#include "flash_hopper.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

constexpr int kB = 64;                 // rows of a q tile and keys of a k tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // a warp: 16 rows of the tile
constexpr int kPStride = kB + 8;       // a warp's P / dS rows: 8 banks apart
constexpr int kDeltaWarps = 8;

template <typename T>
__device__ __forceinline__ float ld(const T* p) {
  if constexpr (std::is_same<T, float>::value) return *p;
  else return __bfloat162float(*p);
}

// Four 64 x (HD + 1) fp32 tiles, a warp's 16-row P / dS tile for each
// warp, and the q tile's lse and D.
template <int HD>
constexpr int smem_floats() {
  return 4 * kB * (HD + 1) + kWarps * 16 * kPStride + 2 * kB;
}

// Rows [r0, r0 + 64) of head ``head`` of a (B, S, heads, HD) tensor into a
// padded fp32 tile; rows past ``n`` are zeros.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int QS = HD + 1;
  for (int e = threadIdx.x; e < kB * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    dst[r * QS + c] = r0 + r < n ? ld(base + (long long)(r0 + r) * row_stride + c)
                                 : 0.f;
  }
}

template <int HD, typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, int n_heads,
                                       int sq, long long rows) {
  const long long row =
      (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32)
    sum = fmaf(ld(o + row * HD + c), ld(dout + row * HD + c), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFullMask, sum, off);
  if (lane == 0) {
    // row runs over (B, Sq, H); D is (B, H, Sq)
    const long long per_b = (long long)sq * n_heads;
    const long long b = row / per_b, rem = row % per_b;
    const int i = (int)(rem / n_heads), h = (int)(rem % n_heads);
    delta[(b * n_heads + h) * sq + i] = sum;
  }
}

// One block a (b, KV head, 64-key tile): dK and dV of its keys (fp32).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int n_heads, int n_kv,
    int sq, int sk, int causal, int q_offset, float scale) {
  using T = float;
  constexpr int QS = HD + 1;
  constexpr int NC = HD / 8;  // output columns a lane
  extern __shared__ float smem[];
  float* s_k = smem;             // the block's keys, kB x QS
  float* s_v = s_k + kB * QS;
  float* s_q = s_v + kB * QS;    // the current q tile
  float* s_do = s_q + kB * QS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_p = s_do + kB * QS + warp * 16 * kPStride;  // this warp's rows
  float* s_lse = s_do + kB * QS + kWarps * 16 * kPStride;
  float* s_dl = s_lse + kB;
  const int rg = lane / 8, cg = lane % 8;
  const int row0 = warp * 16 + rg;  // this lane's first key in the tile

  const int k0 = blockIdx.x * kB;  // causal: the heaviest tiles first
  const int b = blockIdx.y / n_kv, hk = blockIdx.y % n_kv;
  const long long rq = (long long)n_heads * HD;  // q / o / dO row stride
  const long long rk = (long long)n_kv * HD;     // k / v row stride
  load_tile<HD>(s_k, k + ((long long)b * sk * n_kv + hk) * HD, rk, k0, sk);
  load_tile<HD>(s_v, v + ((long long)b * sk * n_kv + hk) * HD, rk, k0, sk);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // rows below k0 - q_offset see none of these keys
  const int first_row = causal ? max(0, k0 - q_offset) : 0;
  const int n_qt = (sq + kB - 1) / kB;

  for (int h = hk; h < n_heads; h += n_kv) {
    const T* qb = q + ((long long)b * sq * n_heads + h) * HD;
    const T* db = dout + ((long long)b * sq * n_heads + h) * HD;
    const float* lb = lse + ((long long)b * n_heads + h) * sq;
    const float* dlb = delta + ((long long)b * n_heads + h) * sq;
    for (int t = first_row / kB; t < n_qt; ++t) {
      const int q0 = t * kB;
      __syncthreads();  // the last tile's reads are done
      load_tile<HD>(s_q, qb, rq, q0, sq);
      load_tile<HD>(s_do, db, rq, q0, sq);
      if (threadIdx.x < kB) {
        const int r = q0 + threadIdx.x;
        s_lse[threadIdx.x] = r < sq ? lb[r] : 0.f;
        s_dl[threadIdx.x] = r < sq ? dlb[r] : 0.f;
      }
      __syncthreads();

      // S^T (keys x rows) and dP^T = V dO^T over the head dim
      float s[4][8], dp[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[8], gv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = s_k[(row0 + 4 * i) * QS + d];
          vv[i] = s_v[(row0 + 4 * i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qv[j] = s_q[(cg + 8 * j) * QS + d];
          gv[j] = s_do[(cg + 8 * j) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
      // P^T, then dS^T = P^T (dP^T - D) in dp
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + row0 + 4 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = q0 + cg + 8 * j;
          const bool ok = r < sq && kpos < sk &&
                          (!causal || (long long)q_offset + r >= kpos);
          const float p = ok ? expf(s[i][j] * scale - s_lse[cg + 8 * j]) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - s_dl[cg + 8 * j]);
          s_p[(rg + 4 * i) * kPStride + cg + 8 * j] = p;
        }
      }
      __syncwarp();
      // dV += P^T dO
#pragma unroll 4
      for (int j = 0; j < kB; ++j) {
        float pv[4], gv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = s_p[(rg + 4 * i) * kPStride + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) gv[c] = s_do[j * QS + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc_v[i][c] = fmaf(pv[i], gv[c], acc_v[i][c]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s_p[(rg + 4 * i) * kPStride + cg + 8 * j] = dp[i][j];
      __syncwarp();
      // dK += dS^T Q (scaled at the end)
#pragma unroll 4
      for (int j = 0; j < kB; ++j) {
        float sv[4], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = s_p[(rg + 4 * i) * kPStride + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) qv[c] = s_q[j * QS + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc_k[i][c] = fmaf(sv[i], qv[c], acc_k[i][c]);
      }
      __syncwarp();  // the P tile is rewritten by the next q tile
    }
  }

  T* dkb = dk + ((long long)b * sk * n_kv + hk) * HD;
  T* dvb = dv + ((long long)b * sk * n_kv + hk) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + row0 + 4 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[(long long)key * rk + cg + 8 * c] = acc_k[i][c] * scale;
      dvb[(long long)key * rk + cg + 8 * c] = acc_v[i][c];
    }
  }
}

// One block a (b, q head, 64-row q tile): dQ of its rows (fp32).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int n_heads, int n_kv, int sq, int sk,
    int causal, int q_offset, float scale) {
  using T = float;
  constexpr int QS = HD + 1;
  constexpr int NC = HD / 8;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kB * QS;
  float* s_k = s_do + kB * QS;
  float* s_v = s_k + kB * QS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_p = s_v + kB * QS + warp * 16 * kPStride;
  const int rg = lane / 8, cg = lane % 8;
  const int row0 = warp * 16 + rg;  // this lane's first row in the q tile

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest tiles first
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int hk = h % n_kv;
  const long long rq = (long long)n_heads * HD;
  const long long rk = (long long)n_kv * HD;
  load_tile<HD>(s_q, q + ((long long)b * sq * n_heads + h) * HD, rq, q0, sq);
  load_tile<HD>(s_do, dout + ((long long)b * sq * n_heads + h) * HD, rq, q0,
                sq);
  const float* lb = lse + ((long long)b * n_heads + h) * sq;
  const float* dlb = delta + ((long long)b * n_heads + h) * sq;
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + row0 + 4 * i;
    lse_r[i] = r < sq ? lb[r] : 0.f;
    dl_r[i] = r < sq ? dlb[r] : 0.f;
  }
  const T* kb = k + ((long long)b * sk * n_kv + hk) * HD;
  const T* vb = v + ((long long)b * sk * n_kv + hk) * HD;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  int kv_end = sk;  // keys [0, kv_end) can be visible to this q tile
  if (causal) {
    const long long last = (long long)q_offset + min(q0 + kB, sq);
    kv_end = (int)min((long long)sk, last);
  }
  const int n_tiles = (kv_end + kB - 1) / kB;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    load_tile<HD>(s_k, kb, rk, k0, sk);
    load_tile<HD>(s_v, vb, rk, k0, sk);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float qv[4], gv[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = s_q[(row0 + 4 * i) * QS + d];
        gv[i] = s_do[(row0 + 4 * i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = s_k[(cg + 8 * j) * QS + d];
        vv[j] = s_v[(cg + 8 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + row0 + 4 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = r < sq && kpos < sk &&
                        (!causal || (long long)q_offset + r >= kpos);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        s_p[(rg + 4 * i) * kPStride + cg + 8 * j] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncwarp();
    // dQ += dS K (scaled at the end)
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float sv[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = s_p[(rg + 4 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = s_k[j * QS + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
    __syncwarp();
  }

  T* dqb = dq + ((long long)b * sq * n_heads + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + row0 + 4 * i;
    if (r >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dqb[(long long)r * rq + cg + 8 * c] = acc[i][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kStages = 4;  // ring depth of both kernels
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Bw {
  static constexpr int TB = 128;  // keys of a dK/dV block, q rows of a dQ one
  static constexpr int TS = 64;   // q rows (dK/dV) or keys (dQ) of a stage
  static constexpr int CONSUMERS = 256;  // two consumer warpgroups of 64
  static constexpr int THREADS = CONSUMERS + 128;  // + a producer warpgroup
  // registers a thread after setmaxnreg: 256 x 232 + 128 x 40 <= 64 K
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CW = HD < 64 ? HD : 64;  // columns per swizzle atom
  static constexpr int NCH = HD / CW;           // atoms across hd
  static constexpr int SWB = CW * 2;            // swizzle span, bytes
  static constexpr int BIG = TB * HD * 2;       // a block tile, bytes
  static constexpr int SMALL = TS * HD * 2;     // a stage tile, bytes
  // the block's two tiles, then kStages x two stage tiles, then (dK/dV)
  // kStages x (lse, D) of the stage's rows, then the barriers; + 1 KB to
  // align the base
  static constexpr int RING = 2 * BIG;
  static constexpr int ROWS = RING + kStages * 2 * SMALL;
  static constexpr int BAR = ROWS + kStages * 2 * TS * 4;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * kStages) + 1024;
};

// The consumer warpgroups of the dK/dV kernel: warpgroup wg owns keys
// kw .. kw + 63 of the block's 128; this thread rows r and r + 8 of them
// and, of every 8-column group of a 64 x N tile, the columns cq, cq + 1.
template <int HD>
__device__ __forceinline__ void dkdv_consumer(
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    uint32_t s_k, uint32_t ring, const float* s_rows, uint32_t bar_kv,
    uint32_t bar_f0, uint32_t bar_e0, int n_kv, int sq, int sk, int causal,
    int q_offset, float scale_log2, float scale, int k0, int b, int hk,
    int t0, int per_head, int n_stages) {
  using C = Bw<HD>;
  constexpr int TS = C::TS, CW = C::CW, SWB = C::SWB;
  constexpr int NS = TS / 2;   // S^T registers a thread: 64 x 64 / 128
  constexpr int NO = HD / 2;   // dK (and dV) registers a thread
  constexpr int KS = TS / 16;  // 16-row slices of a stage
  const int warp = __shfl_sync(kFullMask, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int kw = k0 + wg * 64;
  const int r = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // this warpgroup's K and V rows as A: K-major, 8-row groups 8 swizzled
  // rows apart, the next atom across hd TB rows on
  const uint64_t da_k = gmma_desc(s_k + wg * 64 * SWB, 16, 8 * SWB, SWB);
  const uint64_t da_v = da_k + ((C::BIG) >> 4);
  auto stage = [](int u) { return u % kStages; };
  auto q_tile = [&](int u) { return ring + stage(u) * 2 * C::SMALL; };

  float dkacc[NO], dvacc[NO], sacc[NS], dpacc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) dkacc[i] = dvacc[i] = 0.f;
  // P^T and dS^T of the stage as A fragments, hi and lo
  uint32_t phi[KS][4], plo[KS][4], dhi[KS][4], dlo[KS][4];

  // S^T = K Q^T and dP^T = V dO^T of stage u, issued as one group
  auto issue_s = [&](int u) {
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = dpacc[i] = 0.f;
    const uint64_t db_q = gmma_desc(q_tile(u), 16, 8 * SWB, SWB);
    const uint64_t db_do = db_q + (C::SMALL >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int sa = (kk * 16 / CW) * C::TB * SWB + (kk * 16 % CW) * 2;
      const int sb = (kk * 16 / CW) * TS * SWB + (kk * 16 % CW) * 2;
      wgmma_ss_n64(sacc, da_k + (sa >> 4), db_q + (sb >> 4), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int sa = (kk * 16 / CW) * C::TB * SWB + (kk * 16 % CW) * 2;
      const int sb = (kk * 16 / CW) * TS * SWB + (kk * 16 % CW) * 2;
      wgmma_ss_n64(dpacc, da_v + (sa >> 4), db_do + (sb >> 4), kk > 0);
    }
    wgmma_commit();
  };
  // dV += P^T dO and dK += dS^T Q of stage u (hi, then lo), issued; the
  // stage's dO and Q tiles as B, MN-major (the next atom across hd TS rows
  // on, 16-row slices 16 swizzled rows apart)
  auto issue_kv = [&](int u) {
    const uint64_t db_q = gmma_desc(q_tile(u), TS * SWB, 8 * SWB, SWB);
    const uint64_t db_do = db_q + (C::SMALL >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(dvacc, phi[kk], db_do + ((kk * 16 * SWB) >> 4));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(dvacc, plo[kk], db_do + ((kk * 16 * SWB) >> 4));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(dkacc, dhi[kk], db_q + ((kk * 16 * SWB) >> 4));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(dkacc, dlo[kk], db_q + ((kk * 16 * SWB) >> 4));
    wgmma_commit();
  };
  // P^T and dS^T of stage u (q rows q0 ..) from S^T and dP^T, split into
  // the A fragments.  Register pair 8 kk + 2 i is key row r + 8 (i & 1),
  // columns 16 kk + 8 (i >> 1) + cq and + 1 (slice kk of the fragments).
  auto grads = [&](auto mask_tag, int u, int q0) {
    constexpr bool MASK = decltype(mask_tag)::value;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      fence_regs(sacc[i]);
      fence_regs(dpacc[i]);
    }
    const float* lse2 = s_rows + stage(u) * 2 * TS;
    const float* dl = lse2 + TS;
    // key row i sees the stage's columns [lo[i], hi)
    int lo[2] = {0, 0}, hi = TS;
    if (MASK) {
      hi = min(sq - q0, TS);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = kw + r + 8 * i;
        long long first = causal ? (long long)key - q_offset - q0 : 0;
        if (key >= sk) first = TS;
        lo[i] = (int)max(0ll, min((long long)TS, first));
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 8 * kk + 2 * i;
        const int c = 16 * kk + 8 * (i >> 1) + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
        float p0 = fast_exp2(fmaf(sacc[e], scale_log2, -l2.x));
        float p1 = fast_exp2(fmaf(sacc[e + 1], scale_log2, -l2.y));
        if (MASK) {
          if (c < lo[i & 1] || c >= hi) p0 = 0.f;
          if (c + 1 < lo[i & 1] || c + 1 >= hi) p1 = 0.f;
        }
        split_bf16(p0, p1, phi[kk][i], plo[kk][i]);
        split_bf16(p0 * (dpacc[e] - d2.x), p1 * (dpacc[e + 1] - d2.y),
                   dhi[kk][i], dlo[kk][i]);
      }
  };

  mbar_wait(bar_kv, 0);
  for (int u = 0; u < n_stages; ++u) {
    const int q0 = (t0 + u % per_head) * TS;
    mbar_wait(bar_f0 + 8 * stage(u), (u / kStages) & 1);
    // rows q0 .. q0 + 63 see some of this warpgroup's keys
    if (kw < sk && (!causal || (long long)q_offset + q0 + TS - 1 >= kw)) {
      issue_s(u);
      wgmma_wait<0>();
      const bool masked = q0 + TS > sq || kw + 64 > sk ||
                          (causal && (long long)q_offset + q0 < kw + 63);
      if (masked) grads(std::true_type(), u, q0);
      else grads(std::false_type(), u, q0);
      issue_kv(u);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        fence_regs(dkacc[i]);
        fence_regs(dvacc[i]);
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fence_regs(phi[kk][i]);
          fence_regs(plo[kk][i]);
          fence_regs(dhi[kk][i]);
          fence_regs(dlo[kk][i]);
        }
    }
    __syncwarp();  // this warp is done with the stage
    if (lane == 0) mbar_arrive(bar_e0 + 8 * stage(u));
  }

  // dK * scale and dV in bf16, keys past Sk dropped
  const long long rk = (long long)n_kv * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + r + 8 * i;
    if (key >= sk) continue;
    const long long off = ((long long)b * sk + key) * rk + (long long)hk * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + cq) =
          __floats2bfloat162_rn(dkacc[4 * j + 2 * i] * scale,
                                dkacc[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + cq) =
          __floats2bfloat162_rn(dvacc[4 * j + 2 * i],
                                dvacc[4 * j + 2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Bw<HD>::THREADS, 1) flash_bwd_dkdv_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int n_heads, int n_kv, int sq, int sk,
    int causal, int q_offset, float scale_log2, float scale) {
  using C = Bw<HD>;
  constexpr int TS = C::TS, CW = C::CW, NCH = C::NCH, SWB = C::SWB;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1 KB boundary (the swizzle repeats every 1 KB)
  const uint32_t pad = ((smem_u32(smem_raw) + 1023u) & ~1023u) -
                       smem_u32(smem_raw);
  const uint32_t base = smem_u32(smem_raw) + pad;
  const uint32_t s_k = base, s_v = base + C::BIG;
  const uint32_t ring = base + C::RING;  // stage s: Q, then dO
  float* s_rows = reinterpret_cast<float*>(smem_raw + pad + C::ROWS);
  const uint32_t bar_kv = base + C::BAR;
  const uint32_t bar_f0 = bar_kv + 8;             // kStages full
  const uint32_t bar_e0 = bar_f0 + 8 * kStages;  // kStages empty

  const int k0 = blockIdx.y * C::TB;  // causal: the heaviest key tiles first
  const int b = blockIdx.x / n_kv, hk = blockIdx.x % n_kv;
  // rows below k0 - q_offset see none of the block's keys
  const long long first = causal ? max(0ll, (long long)k0 - q_offset) : 0;
  const int n_qt = (sq + TS - 1) / TS;
  const int t0 = (int)min((long long)n_qt, first / TS);
  const int per_head = n_qt - t0;
  const int n_stages = per_head * (n_heads / n_kv);
  // the warp index, broadcast so the compiler knows it is warp-uniform
  const int warp = __shfl_sync(kFullMask, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_e0 + 8 * s, C::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::CONSUMERS / 32) {  // the producer warpgroup: one warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(C::PRODUCER_REGS));
    if (warp == C::CONSUMERS / 32) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * C::BIG);
        for (int c = 0; c < NCH; ++c) {
          tma_load(s_k + c * C::TB * SWB, &tm_k, bar_kv, c * CW, hk, k0, b);
          tma_load(s_v + c * C::TB * SWB, &tm_v, bar_kv, c * CW, hk, k0, b);
        }
      }
      for (int u = 0; u < n_stages; ++u) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(bar_e0 + 8 * s, ((u / kStages) & 1) ^ 1);
        const int h = hk + (u / per_head) * n_kv;
        const int q0 = (t0 + u % per_head) * TS;
        // the stage's rows: lse in log2 units (+inf past Sq, so that P is
        // 0 there) and D
        const long long rb = ((long long)b * n_heads + h) * sq;
        float* rows = s_rows + s * 2 * TS;
        for (int i = lane; i < TS; i += 32) {
          const bool ok = q0 + i < sq;
          rows[i] = ok ? lse[rb + q0 + i] * kLog2e : INFINITY;
          rows[TS + i] = ok ? delta[rb + q0 + i] : 0.f;
        }
        const uint32_t full = bar_f0 + 8 * s;
        if (lane == 0) {
          const uint32_t tq = ring + s * 2 * C::SMALL;
          mbar_expect_tx(full, 2 * C::SMALL);
          for (int c = 0; c < NCH; ++c) {
            tma_load(tq + c * TS * SWB, &tm_q, full, c * CW, h, q0, b);
            tma_load(tq + C::SMALL + c * TS * SWB, &tm_do, full, c * CW, h,
                     q0, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(C::CONSUMER_REGS));
    dkdv_consumer<HD>(dk, dv, s_k, ring, s_rows, bar_kv, bar_f0, bar_e0,
                      n_kv, sq, sk, causal, q_offset, scale_log2, scale, k0,
                      b, hk, t0, per_head, n_stages);
  }
}

// The consumer warpgroups of the dQ kernel: warpgroup wg owns q rows
// qw .. qw + 63 of the block's 128; the layout of kernel 13's consumers.
template <int HD>
__device__ __forceinline__ void dq_consumer(
    __nv_bfloat16* __restrict__ dq, const float* __restrict__ lse,
    const float* __restrict__ delta, uint32_t s_q, uint32_t ring,
    uint32_t bar_q, uint32_t bar_f0, uint32_t bar_e0, int n_heads, int sq,
    int sk, int causal, int q_offset, float scale_log2, float scale, int q0,
    int b, int h, int n_tiles) {
  using C = Bw<HD>;
  constexpr int BK = C::TS, CW = C::CW, SWB = C::SWB;
  constexpr int NS = BK / 2;   // score registers a thread: 64 x BK / 128
  constexpr int NO = HD / 2;   // dQ registers a thread
  constexpr int KS = BK / 16;  // 16-key slices of a kv tile
  const int warp = __shfl_sync(kFullMask, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int qw = q0 + wg * 64;
  const int r = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int my_tiles =
      qw < sq ? (kv_end(qw + 64, sq, sk, causal, q_offset) + BK - 1) / BK : 0;
  // this warpgroup's Q and dO rows: K-major, 8-row groups 8 swizzled rows
  // apart
  const uint64_t da_q = gmma_desc(s_q + wg * 64 * SWB, 16, 8 * SWB, SWB);
  const uint64_t da_do = da_q + (C::BIG >> 4);
  auto stage = [](unsigned t) { return t % kStages; };
  auto parity = [](unsigned t) { return (t / kStages) & 1; };
  auto k_tile = [&](unsigned t) { return ring + stage(t) * 2 * C::SMALL; };
  // this warp is done with tile t's stage
  auto release = [&](unsigned t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e0 + 8 * stage(t));
  };
  auto wait_full = [&](unsigned t) {
    mbar_wait(bar_f0 + 8 * stage(t), parity(t));
  };

  // rows r and r + 8: lse in log2 units (+inf past Sq) and D
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r + 8 * i;
    const long long at = ((long long)b * n_heads + h) * sq + row;
    lse2[i] = row < sq ? lse[at] * kLog2e : INFINITY;
    dl[i] = row < sq ? delta[at] : 0.f;
  }
  float dqacc[NO], sacc[NS], dpacc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqacc[i] = 0.f;
  uint32_t dhi[KS][4], dlo[KS][4];  // dS of the tile whose dS K is pending

  // S = Q K^T and dP = dO V^T of tile t, issued as one group
  auto issue_s = [&](unsigned t) {
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = dpacc[i] = 0.f;
    const uint64_t db_k = gmma_desc(k_tile(t), 16, 8 * SWB, SWB);
    const uint64_t db_v = db_k + (C::SMALL >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int sa = (kk * 16 / CW) * C::TB * SWB + (kk * 16 % CW) * 2;
      const int sb = (kk * 16 / CW) * BK * SWB + (kk * 16 % CW) * 2;
      wgmma_ss_n64(sacc, da_q + (sa >> 4), db_k + (sb >> 4), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int sa = (kk * 16 / CW) * C::TB * SWB + (kk * 16 % CW) * 2;
      const int sb = (kk * 16 / CW) * BK * SWB + (kk * 16 % CW) * 2;
      wgmma_ss_n64(dpacc, da_do + (sa >> 4), db_v + (sb >> 4), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS_hi K, then dS_lo K for tile t, issued; K as B, MN-major
  auto issue_dq = [&](unsigned t) {
    const uint64_t db = gmma_desc(k_tile(t), BK * SWB, 8 * SWB, SWB);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(dqacc, dhi[kk], db + ((kk * 16 * SWB) >> 4));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(dqacc, dlo[kk], db + ((kk * 16 * SWB) >> 4));
    wgmma_commit();
  };
  // dS of tile t in place of dP (MASK: the diagonal or a ragged tile)
  auto grads = [&](auto mask_tag, unsigned t) {
    constexpr bool MASK = decltype(mask_tag)::value;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      fence_regs(sacc[i]);
      fence_regs(dpacc[i]);
    }
    // row i sees the keys of this tile whose offset from t BK + cq is
    // below vis[i]
    int vis[2];
    if (MASK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qw + r + 8 * i;
        long long lim = sk;
        if (causal) lim = min(lim, (long long)q_offset + row + 1);
        if (row >= sq) lim = 0;
        vis[i] = (int)max(-1ll, min(lim - (long long)t * BK - cq,
                                    (long long)BK));
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(
            fmaf(sacc[4 * j + e], scale_log2, -lse2[e >> 1]));
        if (MASK && 8 * j + (e & 1) >= vis[e >> 1]) p = 0.f;
        dpacc[4 * j + e] = p * (dpacc[4 * j + e] - dl[e >> 1]);
      }
  };
  auto grads_tile = [&](unsigned t) {
    const bool masked =
        (int)((t + 1) * BK) > sk || qw + 64 > sq ||
        (causal && (long long)(t + 1) * BK - 1 > (long long)q_offset + qw);
    if (masked) grads(std::true_type(), t);
    else grads(std::false_type(), t);
  };
  // dS as A fragments: slice kk is columns 16 kk .. 16 kk + 15, i.e.
  // registers 8 kk .. 8 kk + 7 in pairs
  auto split_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(dpacc[8 * kk + 2 * i], dpacc[8 * kk + 2 * i + 1],
                   dhi[kk][i], dlo[kk][i]);
  };
  // the pending dS K is done: its registers and stage are free
  auto dq_done = [&](unsigned t) {
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_regs(dqacc[i]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_regs(dhi[kk][i]);
        fence_regs(dlo[kk][i]);
      }
    release(t);
  };

  mbar_wait(bar_q, 0);
  if (my_tiles > 0) {
    wait_full(0);
    issue_s(0);
    wgmma_wait<0>();
    grads_tile(0);
    split_ds();
    // tile t's S and dP run on the tensor cores beside tile t - 1's dS K,
    // and its exponentials beside that dS K
    for (unsigned t = 1; t < (unsigned)my_tiles; ++t) {
      wait_full(t);
      issue_s(t);
      issue_dq(t - 1);
      wgmma_wait<1>();
      grads_tile(t);
      wgmma_wait<0>();
      dq_done(t - 1);
      split_ds();
    }
    wgmma_fence();
    issue_dq(my_tiles - 1);
    wgmma_wait<0>();
    dq_done(my_tiles - 1);
  }
  // the other warpgroup's tiles: the stage is released once loaded, so
  // every release of a stage follows the one before it
  for (unsigned t = my_tiles; t < (unsigned)n_tiles; ++t) {
    wait_full(t);
    release(t);
  }

  // dQ * scale in bf16, rows past Sq dropped
  const long long rs = (long long)n_heads * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* qrow = dq + ((long long)b * sq + row) * rs +
                          (long long)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j + cq) =
          __floats2bfloat162_rn(dqacc[4 * j + 2 * i] * scale,
                                dqacc[4 * j + 2 * i + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(Bw<HD>::THREADS, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int n_heads, int n_kv, int sq, int sk, int causal, int q_offset,
    float scale_log2, float scale) {
  using C = Bw<HD>;
  constexpr int BK = C::TS, CW = C::CW, NCH = C::NCH, SWB = C::SWB;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1 KB boundary (the swizzle repeats every 1 KB)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_do = base + C::BIG;
  const uint32_t ring = base + C::RING;  // stage s: K, then V
  const uint32_t bar_q = base + C::BAR;
  const uint32_t bar_f0 = bar_q + 8;             // kStages full (K and V)
  const uint32_t bar_e0 = bar_f0 + 8 * kStages;  // kStages empty

  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::TB;  // the last first
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int hk = h % n_kv;
  const int n_tiles =
      (kv_end(q0 + C::TB, sq, sk, causal, q_offset) + BK - 1) / BK;
  // the warp index, broadcast so the compiler knows it is warp-uniform
  const int warp = __shfl_sync(kFullMask, threadIdx.x / 32, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f0 + 8 * s, 1);
      mbar_init(bar_e0 + 8 * s, C::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::CONSUMERS / 32) {  // the producer warpgroup: one lane loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == C::CONSUMERS) {
      mbar_expect_tx(bar_q, 2 * C::BIG);
      for (int c = 0; c < NCH; ++c) {
        tma_load(s_q + c * C::TB * SWB, &tm_q, bar_q, c * CW, h, q0, b);
        tma_load(s_do + c * C::TB * SWB, &tm_do, bar_q, c * CW, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_e0 + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t sk_t = ring + s * 2 * C::SMALL;
        mbar_expect_tx(bar_f0 + 8 * s, 2 * C::SMALL);
        for (int c = 0; c < NCH; ++c) {
          tma_load(sk_t + c * BK * SWB, &tm_k, bar_f0 + 8 * s, c * CW, hk,
                   t * BK, b);
          tma_load(sk_t + C::SMALL + c * BK * SWB, &tm_v, bar_f0 + 8 * s,
                   c * CW, hk, t * BK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(C::CONSUMER_REGS));
    dq_consumer<HD>(dq, lse, delta, s_q, ring, bar_q, bar_f0, bar_e0,
                    n_heads, sq, sk, causal, q_offset, scale_log2, scale, q0,
                    b, h, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD, typename T>
static int launch_delta(const void* o, const void* dout, void* delta, int b,
                        int h, int sq, cudaStream_t stream) {
  const long long rows = (long long)b * sq * h;
  const long long n_blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<HD, T><<<(unsigned)n_blocks, 32 * kDeltaWarps, 0,
                                  stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, h, sq, rows);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_f32(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, void* dk, void* dv, int b, int h,
                      int n_kv, int sq, int sk, int causal, int q_offset,
                      cudaStream_t stream) {
  using T = float;
  if (b * h > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool opted_kv[kMaxDevices] = {}, opted_q[kMaxDevices] = {};
  auto kv_kernel = flash_bwd_dkdv_kernel<HD>;
  auto q_kernel = flash_bwd_dq_kernel<HD>;
  int e = opt_in_smem(kv_kernel, bytes, opted_kv);
  if (!e) e = opt_in_smem(q_kernel, bytes, opted_q);
  if (e) return e;
  const float scale = (float)(1.0 / sqrt((double)HD));
  e = launch_delta<HD, T>(o, dout, delta, b, h, sq, stream);
  if (e) return e;
  kv_kernel<<<dim3((sk + kB - 1) / kB, b * n_kv), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, h, n_kv, sq,
      sk, causal, q_offset, scale);
  e = (int)cudaGetLastError();
  if (e) return e;
  q_kernel<<<dim3((sq + kB - 1) / kB, b * h), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, h, n_kv, sq, sk, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, int b, int h,
                     int n_kv, int sq, int sk, int causal, int q_offset,
                     cudaStream_t stream) {
  using C = Bw<HD>;
  // TMA takes 16-byte aligned bases (and the stores bf16 pairs)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int n_kt = (sk + C::TB - 1) / C::TB, n_qt = (sq + C::TB - 1) / C::TB;
  if (n_kt > 65535 || n_qt > 65535) return (int)cudaErrorInvalidValue;
  // dK/dV: 64-row Q / dO stages, 128-key K / V tiles; dQ: the other way
  CUtensorMap q_s, do_s, k_b, v_b, q_b, do_b, k_s, v_s;
  int e = make_map(&q_s, q, b, sq, h, HD, C::CW, C::TS);
  if (!e) e = make_map(&do_s, dout, b, sq, h, HD, C::CW, C::TS);
  if (!e) e = make_map(&k_b, k, b, sk, n_kv, HD, C::CW, C::TB);
  if (!e) e = make_map(&v_b, v, b, sk, n_kv, HD, C::CW, C::TB);
  if (!e) e = make_map(&q_b, q, b, sq, h, HD, C::CW, C::TB);
  if (!e) e = make_map(&do_b, dout, b, sq, h, HD, C::CW, C::TB);
  if (!e) e = make_map(&k_s, k, b, sk, n_kv, HD, C::CW, C::TS);
  if (!e) e = make_map(&v_s, v, b, sk, n_kv, HD, C::CW, C::TS);
  if (e) return e;
  auto kv_kernel = flash_bwd_dkdv_tc_kernel<HD>;
  auto q_kernel = flash_bwd_dq_tc_kernel<HD>;
  static bool opted_kv[kMaxDevices] = {}, opted_q[kMaxDevices] = {};
  e = opt_in_smem(kv_kernel, C::SMEM, opted_kv);
  if (!e) e = opt_in_smem(q_kernel, C::SMEM, opted_q);
  if (e) return e;
  e = launch_delta<HD, __nv_bfloat16>(o, dout, delta, b, h, sq, stream);
  if (e) return e;
  const float scale = (float)(1.0 / sqrt((double)HD));
  // exp(s * scale - lse) = exp2(s * scale_log2 - lse * log2 e)
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  kv_kernel<<<dim3(b * n_kv, n_kt), C::THREADS, C::SMEM, stream>>>(
      q_s, k_b, v_b, do_s, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, h, n_kv, sq, sk, causal,
      q_offset, scale_log2, scale);
  e = (int)cudaGetLastError();
  if (e) return e;
  q_kernel<<<dim3(b * h, n_qt), C::THREADS, C::SMEM, stream>>>(
      q_b, k_s, v_s, do_b, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, h, n_kv, sq, sk, causal, q_offset, scale_log2,
      scale);
  return (int)cudaGetLastError();
}

// delta: fp32 (B, H, Sq) scratch.  dq like q; dk and dv like k.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int b, int h, int n_kv, int sq, int sk,
                                   int hd, int bf16, int causal, int q_offset,
                                   cudaStream_t stream) {
  if (n_kv <= 0 || h % n_kv || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    switch (hd) {
      case 32: return launch_tc<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
      case 64: return launch_tc<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
      case 128: return launch_tc<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
    case 64: return launch_f32<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
    case 128: return launch_f32<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
