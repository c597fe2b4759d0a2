// Causal (or full) flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/flash_attention.py):
// q (B, Sq, H, hd) and k/v (B, Sk, H, hd), KV heads already tiled, in fp32 or
// bf16; s = (q . k) * 1/sqrt(hd) in fp32, masked to -1e30 where the key is
// past Sk or, when causal, past the query's absolute position
// (q_offset + i >= j); an online softmax over kv tiles keeps the running max
// m, sum l and output sum in fp32; the output is acc / max(l, 1e-30) in q's
// dtype.  Any Sq and Sk: the last q and kv tiles are masked.
//
// One block of 4 warps per (b*h, 64-row q tile), heaviest (last) q tiles
// first.  The q tile and one 64-row k/v tile at a time sit in shared memory
// in fp32; the causal loop stops at the tile holding the q tile's last
// diagonal key.  Each warp owns 16 q rows; lane (rg, cg) = (lane / 8,
// lane % 8) holds rows rg + 4i (i < 4) and keys cg + 8j (j < 8) of the score
// tile and columns cg + 8c (c < hd / 8) of the output, so a row's max and sum
// reduce over the 8 lanes of its row group with three shuffles, and every
// shared-memory access is conflict-free (padded strides).  Scalar fp32 FMAs.
//
// Bound on the H100: at the qwen3-0.6b prefill (B 4, S 1024, H 16, hd 64,
// bf16) the bytes of q, k, v and o (33.5 MB) and the causal half of
// 4 * B * H * S^2 * hd operations on the bf16 tensor cores are level
// (0.010 and 0.0087 ms).  This kernel runs on the fp32 pipes without tensor
// cores: it is right first; wgmma / TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPStride = kBK + 8;  // rows of a warp's P tile: 8 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr int smem_floats() {
  return 2 * kBQ * (HD + 1) + kBK * HD + kWarps * 16 * kPStride;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int n_heads, int sq, int sk,
    int causal, int q_offset, float scale) {
  constexpr int QS = HD + 1;  // padded row stride of the q and k tiles
  constexpr int NC = HD / 8;  // output columns per lane
  extern __shared__ float smem[];
  float* s_q = smem;               // kBQ x QS
  float* s_k = s_q + kBQ * QS;     // kBK x QS
  float* s_v = s_k + kBK * QS;     // kBK x HD
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_p = s_v + kBK * HD + warp * 16 * kPStride;  // this warp's 16 rows
  const int rg = lane / 8, cg = lane % 8;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const long long rs = (long long)n_heads * HD;  // sequence-row stride
  const T* qb = q + ((long long)b * sq * n_heads + h) * HD;
  const T* kb = k + ((long long)b * sk * n_heads + h) * HD;
  const T* vb = v + ((long long)b * sk * n_heads + h) * HD;
  T* ob = o + ((long long)b * sq * n_heads + h) * HD;

  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    s_q[r * QS + c] = q0 + r < sq ? to_f32(qb[(q0 + r) * rs + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  // keys [0, kv_end) can be visible to this q tile
  int kv_end = sk;
  if (causal) {
    const long long last = (long long)q_offset + min(q0 + kBQ, sq);
    kv_end = (int)min((long long)sk, last);
  }
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int row0 = warp * 16 + rg;  // this lane's first row in the q tile

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's k/v reads are done
    for (int e = threadIdx.x; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool ok = k0 + r < sk;
      s_k[r * QS + c] = ok ? to_f32(kb[(k0 + r) * rs + c]) : 0.f;
      s_v[r * HD + c] = ok ? to_f32(vb[(k0 + r) * rs + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(row0 + 4 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = s_k[(cg + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)q_offset + q0 + row0 + 4 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < sk && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        s_p[(rg + 4 * i) * kPStride + cg + 8 * j] = s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(rg + 4 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = s_v[j * HD + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncwarp();  // the P tile is rewritten by the next kv tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + row0 + 4 * i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) store(ob + r * rs + cg + 8 * c, acc[i][c] / den);
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int b, int h, int sq, int sk, int causal, int q_offset,
                  cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  auto kernel = flash_attention_fwd_kernel<T, HD>;
  static bool opted_in = false;
  if (!opted_in) {  // above 48 KB only as opted-in dynamic shared memory
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  const float scale = (float)(1.0 / sqrt((double)(HD)));
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, h, sq, sk, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    int b, int h, int sq, int sk, int hd, int causal,
                    int q_offset, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, b, h, sq, sk, causal, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, h, sq, sk, causal, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, h, sq, sk, causal, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int h,
                                   int sq, int sk, int hd, int bf16,
                                   int causal, int q_offset,
                                   cudaStream_t stream) {
  if (b * h > 65535) return (int)cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, h, sq, sk, hd, causal,
                                   q_offset, stream);
  return dispatch<float>(q, k, v, o, b, h, sq, sk, hd, causal, q_offset,
                         stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
