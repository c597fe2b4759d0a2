// Row-wise D-ReLU by bisection for Hopper (sm_90a).
//
// Replaces the TPU kernel drelu_pallas (src/repro/kernels/drelu_topk.py):
// per row, lo = min and hi = max, then 64 steps of mid = 0.5f*(lo+hi) with
// count(x >= mid) > k ? lo = mid : hi = mid; the output keeps x >= hi
// (ties kept) and zeroes the rest.
//
// One warp per row; the row lives in registers (lane l holds columns l,
// l+32, ...), so the 64 passes never touch memory: each pass counts with
// one __ballot_sync + __popc per register column.  The arithmetic is the
// plain version's, step for step, and the build has no fast-math, so the
// threshold and the output are bit-exact against it.
//
// Bound on the H100: memory (read x once, write it once); the 64 count
// passes are register work.
#include <cuda_runtime.h>

#include <math.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIters = 64;
constexpr int kWarps = 8;

template <int DPL>
__global__ void __launch_bounds__(256) drelu_bisect_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int d,
    int k) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // the whole warp leaves together
  const float* xr = x + (long long)row * d;
  float v[DPL];
  bool ok[DPL];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    ok[j] = col < d;
    v[j] = ok[j] ? xr[col] : 0.f;
    if (ok[j]) {
      lo = fminf(lo, v[j]);
      hi = fmaxf(hi, v[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFullMask, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFullMask, hi, off));
  }
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      cnt += __popc(__ballot_sync(kFullMask, ok[j] && v[j] >= mid));
    if (cnt > k)
      lo = mid;
    else
      hi = mid;
  }
  float* o = out + (long long)row * d;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    if (ok[j]) o[lane + 32 * j] = v[j] >= hi ? v[j] : 0.f;
  }
}

template <int DPL>
static void launch(const float* x, float* out, int n, int d, int k,
                   cudaStream_t stream) {
  drelu_bisect_kernel<DPL><<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                             stream>>>(x, out, n, d, k);
}

extern "C" int drelu_bisect(const float* x, float* out, int n, int d, int k,
                            cudaStream_t stream) {
  if (n == 0) return 0;
  switch ((d + 31) / 32) {
    case 1: launch<1>(x, out, n, d, k, stream); break;
    case 2: launch<2>(x, out, n, d, k, stream); break;
    case 3: launch<3>(x, out, n, d, k, stream); break;
    case 4: launch<4>(x, out, n, d, k, stream); break;
    case 5: launch<5>(x, out, n, d, k, stream); break;
    case 6: launch<6>(x, out, n, d, k, stream); break;
    case 7: launch<7>(x, out, n, d, k, stream); break;
    case 8: launch<8>(x, out, n, d, k, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
