// DR-SpMM dense-tier sampled backward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_dense_tier_bwd
// (src/repro/kernels/drspmm.py:555):
//
//   dV[n, t] = sum_m Aᵀ[n, m] * gY[m, xi[n, t]]      Aᵀ (N, M), gY (M, dim)
//
// for the plan's stacked transposed dense-tier table.  The product is
// sampled inside the kernel, so the (N, dim) dense cotangent Aᵀ·gY is never
// written to device memory.
//
// Bound on the H100: memory, reading the table once (0.000321 ms for the
// 473 x 473 table of a scale-0.02 batch).  The table is nearly empty (a
// relation lands in the dense tier only with nnz <= 4096: that table holds
// 1,332 non-zeros, at most 8 a row), so what a row costs is latency: one
// round trip for its row of the table, one for the gY values it samples.
//
// Design: one warp a source row, kWarps warps a block, and no block-wide
// barrier (a warp never waits on another, so rows past n leave at once).
// The warp reads its row in windows of 32·kUnroll entries, every lane
// issuing its kUnroll coalesced loads before it tests any; a ballot of each
// 32-entry group appends the non-zero (m, a) pairs, in ascending m, to the
// warp's own list in shared memory (offsets from __popc of the ballot below
// the lane).  Lane t owns output positions t, t+32, ... and reads its k
// columns once; for the listed pairs it issues the gY loads of a batch
// (kBatch loads a lane: kBatch / (k/32) pairs, at least one) before it adds
// any, reading gY straight from global memory (L2-resident, M x dim x 4
// bytes).  Each pair is one FMA, acc += a * g, in ascending m whatever the
// shape constants, so the fp32 result is deterministic and the same bits
// at every shape.  A window's list is used up before the next window is
// read, so the list has a fixed size for any M.  Entries equal to zero are
// skipped (a row outside every dense relation comes back exactly 0), and
// columns outside [0, dim) sample nothing (they contribute 0).
//
// Shape, from the sweep of tools/dense_tier_probe.py on an NVIDIA H100 80GB
// HBM3 (700 W), at the 473 x 473 table: 1, 2, 4 or 8 warps a block, 4-16
// loads in flight and 8-32 groups a window all take 0.0021-0.0025 ms by
// the profiler: the time is the launch and two round trips.  Chosen: 4
// warps a block (119 blocks at N = 473 on 132 SMs), 16 groups a window (a
// 473-entry row in one window; 512 pairs x 8 bytes of list a warp, 16 KB
// a block), 8 loads in flight a lane, and 8 blocks an SM, which caps
// ptxas at 64 registers (55-63, no spills, at every k/32; uncapped it
// takes 56-72) and read fastest at every table size swept, 0.0021 at
// 473 x 473.
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 4;        // source rows (warps) a block
constexpr int kUnroll = 16;      // 32-entry groups loaded before any test
constexpr int kBatch = 8;        // gY loads a lane issues before any add
constexpr int kMinBlocks = 8;    // blocks an SM must hold (caps registers)
constexpr int kWindow = 32 * kUnroll;
constexpr int kMaxDim = 256;

template <int TPL>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
dense_tier_bwd_kernel(const float* __restrict__ at,
                      const float* __restrict__ gy,
                      const int* __restrict__ xi, float* __restrict__ out,
                      int n, int m, int k, int dim) {
  constexpr int kPairs = kBatch / TPL > 1 ? kBatch / TPL : 1;
  __shared__ float2 pairs[kWarps][kWindow];     // (m as int bits, a)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;                          // warp-uniform
  float2* list = pairs[warp];
  const unsigned below = (1u << lane) - 1u;
  int col[TPL];
  float acc[TPL];
#pragma unroll
  for (int j = 0; j < TPL; ++j) {
    const int t = lane + 32 * j;
    col[j] = -1;
    acc[j] = 0.f;
    if (t < k) {
      const int c = xi[(long long)row * k + t];
      if ((unsigned)c < (unsigned)dim) col[j] = c;
    }
  }
  const float* arow = at + (long long)row * m;
  for (int w0 = 0; w0 < m; w0 += kWindow) {
    float a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = w0 + 32 * u + lane;
      a[u] = c < m ? arow[c] : 0.f;
    }
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned nz = __ballot_sync(kFullMask, a[u] != 0.f);
      if (a[u] != 0.f)
        list[cnt + __popc(nz & below)] =
            make_float2(__int_as_float(w0 + 32 * u + lane), a[u]);
      cnt += __popc(nz);
    }
    __syncwarp();
    for (int p0 = 0; p0 < cnt; p0 += kPairs) {
      float g[kPairs][TPL];
#pragma unroll
      for (int b = 0; b < kPairs; ++b) {
        // past the list's end the last pair is read again and not added
        const long long base =
            (long long)__float_as_int(list[min(p0 + b, cnt - 1)].x) * dim;
#pragma unroll
        for (int j = 0; j < TPL; ++j)
          g[b][j] = col[j] >= 0 ? gy[base + col[j]] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kPairs; ++b) {
        if (p0 + b < cnt) {                      // warp-uniform
          const float av = list[p0 + b].y;
#pragma unroll
          for (int j = 0; j < TPL; ++j)
            if (col[j] >= 0) acc[j] += av * g[b][j];
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < TPL; ++j) {
    const int t = lane + 32 * j;
    if (t < k) out[(long long)row * k + t] = acc[j];
  }
}

template <int TPL>
static void launch(const float* at, const float* gy, const int* xi,
                   float* out, int n, int m, int k, int dim,
                   cudaStream_t stream) {
  dense_tier_bwd_kernel<TPL><<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                               stream>>>(at, gy, xi, out, n, m, k, dim);
}

extern "C" int drspmm_dense_tier_bwd(const float* at, const float* gy,
                                     const int* xi, float* out, int n, int m,
                                     int k, int dim, cudaStream_t stream) {
  if (dim > kMaxDim || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return 0;
  switch ((k + 31) / 32) {
    case 1: launch<1>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 2: launch<2>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 3: launch<3>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 4: launch<4>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 5: launch<5>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 6: launch<6>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 7: launch<7>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 8: launch<8>(at, gy, xi, out, n, m, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
