// DR-SpMM dense-tier forward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_dense_tier_fwd
// (src/repro/kernels/drspmm.py:506): Y (M, dim) = A (M, N) . densify(CBSR x),
// with the CBSR operand densified inside the kernel, so the dense (N, dim)
// operand never reaches device memory.
//
// Bound on the H100: memory, reading the table once (0.000321 ms for the
// 473 x 473 table of a scale-0.02 batch).  The table is nearly empty (a
// relation lands in the dense tier only with nnz <= 4096: that table holds
// 1,332 non-zeros, at most 8 a row), so what a row costs is latency: one
// round trip for its row of the table, one for the CBSR rows it densifies.
//
// Design: one warp an output row, kWarps warps a block, and no block-wide
// barrier (a warp never waits on another, so rows past m leave at once).
// The warp reads its row in windows of 32·kUnroll entries, every lane
// issuing its kUnroll coalesced loads before it tests any; a ballot of each
// 32-entry group appends the non-zero (s, a) pairs, in ascending s, to the
// warp's own list in shared memory.  Only the listed sources are densified:
// with k <= 32 the warp issues the CBSR loads of a batch of kBatch sources
// (pair t in lane t) before it scatters any, each source densified by the
// permutation scatter of cbsr_densify.cuh on the warp's own owner table;
// with k > 32 each source goes through the broadcast scatter.  Lane l owns
// output columns l, l+32, ...: each source is densified into a zeroed
// d[DPL] (duplicate CBSR columns summed first) and added as acc += a · d,
// in ascending s, zero entries of A skipped -- the products and order of
// the chunk walk this kernel replaced, so the fp32 result is the same bits,
// and deterministic at every shape.  A window's list is used up before the
// next window is read, so the list has a fixed size for any N.  A row with
// no non-zero entry comes back exactly 0.
//
// Shape, from the sweep of tools/dense_tier_probe.py --sweep-fwd on an
// NVIDIA H100 80GB HBM3 (700 W), at the 473 x 473 table (at most 8
// non-zeros a row): 1 or 4 warps a block, with or without the register
// cap, all take 0.0028 ms by the profiler, the launch, two round trips and
// the row's scatters one after another.  8 warps a block at 8 blocks an SM
// caps ptxas at 32 registers and spills (0.0037); 8 or 32 groups a window
// (0.0031), 4 sources in flight (0.0030) and 16 (spills at dim 256;
// 0.0036) are slower.  Chosen: kernel 5's shape, 4 warps a block (119
// blocks at M = 473 on 132 SMs), 16 groups a window (a 473-entry row in
// one window; 16 KB of lists a block), 8 sources in flight, and 8 blocks
// an SM (56-64 registers, no stack or spills at every DPL).
#include <cuda_runtime.h>

#include "cbsr_densify.cuh"

constexpr int kWarps = 4;        // output rows (warps) a block
constexpr int kUnroll = 16;      // 32-entry groups loaded before any test
constexpr int kBatch = 8;        // sources whose CBSR rows load together
constexpr int kMinBlocks = 8;    // blocks an SM must hold (caps registers)
constexpr int kWindow = 32 * kUnroll;

template <int DPL>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
dense_tier_fwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ xv,
                      const int* __restrict__ xi, float* __restrict__ out,
                      int m, int n, int k, int dim) {
  __shared__ float2 pairs[kWarps][kWindow];     // (s as int bits, a)
  __shared__ int owner_tab[kWarps][32 * DPL];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= m) return;                          // warp-uniform
  float2* list = pairs[warp];
  int* owner = owner_tab[warp];
  const unsigned below = (1u << lane) - 1u;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    owner[lane + 32 * j] = -1;
    acc[j] = 0.f;
  }
  const float* arow = a + (long long)row * n;
  for (int w0 = 0; w0 < n; w0 += kWindow) {
    float av[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = w0 + 32 * u + lane;
      av[u] = c < n ? arow[c] : 0.f;
    }
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned nz = __ballot_sync(kFullMask, av[u] != 0.f);
      if (av[u] != 0.f)
        list[cnt + __popc(nz & below)] =
            make_float2(__int_as_float(w0 + 32 * u + lane), av[u]);
      cnt += __popc(nz);
    }
    __syncwarp();
    for (int p0 = 0; p0 < cnt; p0 += kBatch) {
      if (k <= 32) {
        float pv[kBatch];
        int pc[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          // past the list's end the last source is read again, not added
          const long long base =
              (long long)__float_as_int(list[min(p0 + b, cnt - 1)].x) * k;
          pv[b] = 0.f;
          pc[b] = 0;
          if (lane < k) {
            pv[b] = xv[base + lane];
            pc[b] = xi[base + lane];
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (p0 + b < cnt) {                    // warp-uniform
            float d[DPL];
#pragma unroll
            for (int j = 0; j < DPL; ++j) d[j] = 0.f;
            scatter_row_pairs<DPL>(d, owner, pv[b], pc[b], dim, lane);
            const float w = list[p0 + b].y;
#pragma unroll
            for (int j = 0; j < DPL; ++j) acc[j] += w * d[j];
          }
        }
      } else {
        const int end = min(p0 + kBatch, cnt);
        for (int p = p0; p < end; ++p) {
          const long long base = (long long)__float_as_int(list[p].x) * k;
          float d[DPL];
#pragma unroll
          for (int j = 0; j < DPL; ++j) d[j] = 0.f;
          accumulate_cbsr_row<DPL>(d, xv + base, xi + base, k, 1.f, lane);
          const float w = list[p].y;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[j] += w * d[j];
        }
      }
    }
    __syncwarp();
  }
  float* o = out + (long long)row * dim;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < dim) o[col] = acc[j];
  }
}

template <int DPL>
static void launch(const float* a, const float* xv, const int* xi, float* out,
                   int m, int n, int k, int dim, cudaStream_t stream) {
  dense_tier_fwd_kernel<DPL><<<(m + kWarps - 1) / kWarps, 32 * kWarps, 0,
                               stream>>>(a, xv, xi, out, m, n, k, dim);
}

extern "C" int drspmm_dense_tier_fwd(const float* a, const float* xv,
                                     const int* xi, float* out, int m, int n,
                                     int k, int dim, cudaStream_t stream) {
  if (m == 0) return 0;
  switch ((dim + 31) / 32) {
    case 1: launch<1>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 2: launch<2>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 3: launch<3>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 4: launch<4>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 5: launch<5>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 6: launch<6>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 7: launch<7>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 8: launch<8>(a, xv, xi, out, m, n, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
