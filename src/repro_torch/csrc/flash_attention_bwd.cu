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
// dK and dV of KV head j sum over the H / KV q heads that read it.  Every
// sum is fp32; dQ, dK, dV are written in the input dtype (fp32 or bf16).
// The causal mask is by absolute position, q_offset + i >= j; keys past Sk
// and rows past Sq are masked.  Head dims 32, 64 and 128.
//
// No atomics, in three launches on the caller's stream:
//  1. delta: one warp a (b, row, h), D into a (B, H, Sq) scratch;
//  2. dK/dV: one block a (b, KV head, 64-key tile) walks the q heads that
//     read the KV head and, for each, the q tiles that can see the keys
//     (causal: from the tile of row k0 - q_offset on), accumulating dK and
//     dV in registers;
//  3. dQ: one block a (b, q head, 64-row q tile) walks the key tiles its
//     rows can see, accumulating dQ in registers.
// S and P are computed twice (in 2 and in 3), so the kernels do 7 of the
// function's 5 products.
//
// Bound on the H100: at the qwen3-0.6b training shape (B 4, S 1024, H 16,
// KV 8, hd 64, bf16, causal) the causal half of 5 products of
// 2 B H S^2 hd operations (21.5 GFLOP) at the bf16 tensor-core peak,
// 0.0217 ms.  This first kernel is scalar: fp32 FMAs from shared-memory
// tiles, the layout of the forward's fp32 kernel (a warp owns 16 rows of
// a 64 x 64 tile; lane (rg, cg) holds rows rg + 4i and columns cg + 8j, so
// every shared-memory access is conflict-free or a broadcast), so it is
// bound by the fp32 rate (67 TFLOP/s at best, ~0.45 ms for 30 GFLOP of
// FMAs) and by shared-memory reads.  wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

constexpr unsigned kFullMask = 0xffffffffu;
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

template <typename T>
__device__ __forceinline__ T cast_out(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __float2bfloat16_rn(x);
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

// One block a (b, KV head, 64-key tile): dK and dV of its keys.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int n_heads, int n_kv, int sq, int sk, int causal, int q_offset,
    float scale) {
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
      dkb[(long long)key * rk + cg + 8 * c] = cast_out<T>(acc_k[i][c] * scale);
      dvb[(long long)key * rk + cg + 8 * c] = cast_out<T>(acc_v[i][c]);
    }
  }
}

// One block a (b, q head, 64-row q tile): dQ of its rows.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int n_heads,
    int n_kv, int sq, int sk, int causal, int q_offset, float scale) {
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
      dqb[(long long)r * rq + cg + 8 * c] = cast_out<T>(acc[i][c] * scale);
  }
}

constexpr int kMaxDevices = 64;

// Opt ``kernel`` into ``bytes`` of dynamic shared memory on the current
// device, once a device (cudaFuncSetAttribute applies to the current
// device only).
template <class K>
static int opt_in_smem(K kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

template <int HD, typename T>
static int launch(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta, void* dq,
                  void* dk, void* dv, int b, int h, int n_kv, int sq, int sk,
                  int causal, int q_offset, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool opted_kv[kMaxDevices] = {}, opted_q[kMaxDevices] = {};
  auto kv_kernel = flash_bwd_dkdv_kernel<HD, T>;
  auto q_kernel = flash_bwd_dq_kernel<HD, T>;
  int e = opt_in_smem(kv_kernel, bytes, opted_kv);
  if (!e) e = opt_in_smem(q_kernel, bytes, opted_q);
  if (e) return e;
  const float scale = (float)(1.0 / sqrt((double)HD));

  const long long rows = (long long)b * sq * h;
  const long long n_blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<HD, T><<<(unsigned)n_blocks, 32 * kDeltaWarps, 0,
                                  stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, h, sq, rows);
  e = (int)cudaGetLastError();
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

template <typename T>
static int launch_hd(int hd, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, int b, int h,
                     int n_kv, int sq, int sk, int causal, int q_offset,
                     cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
    case 64: return launch<64, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
    case 128: return launch<128, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, n_kv, sq, sk, causal, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// delta: fp32 (B, H, Sq) scratch.  dq like q; dk and dv like k.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int b, int h, int n_kv, int sq, int sk,
                                   int hd, int bf16, int causal, int q_offset,
                                   cudaStream_t stream) {
  if (n_kv <= 0 || h % n_kv) return (int)cudaErrorInvalidValue;
  if (b * h > 65535 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, b, h, n_kv, sq, sk, causal, q_offset,
                                    stream);
  return launch_hd<float>(hd, q, k, v, o, dout, lse, delta, dq, dk, dv, b, h,
                          n_kv, sq, sk, causal, q_offset, stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
