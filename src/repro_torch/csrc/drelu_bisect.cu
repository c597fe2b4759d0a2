// Row-wise D-ReLU by bisection for Hopper (sm_90a).
//
// Replaces the TPU kernel drelu_pallas (src/repro/kernels/drelu_topk.py):
// per row, lo = min and hi = max, then 64 steps of mid = 0.5f*(lo+hi) with
// count(x >= mid) > k ? lo = mid : hi = mid; the output keeps x >= hi
// (ties kept) and zeroes the rest.
//
// The count is only ever compared with k.  Let s be the row sorted in
// descending order, duplicates kept, and t = s[k] its (k+1)-th largest
// value.  Then count(x >= mid) > k holds exactly when mid <= t:
//  - ties: the k+1 largest values are all >= t, and no value above t is
//    missing from them, so ties at t change neither side;
//  - +-0: -0.0 == +0.0 as floats, so the sign of a zero changes no
//    compare on either side (nor which value t is);
//  - +-inf are ordinary values of the order;
//  - mid NaN (0.5f*(-inf + inf)): both sides are false.
// So (lo, hi) depend only on (min, max, t): each row needs one exact
// selection, then the 64 steps as scalar compares `mid <= t`.  They are
// the plain version's float operations in the same order, and the build
// has no fast-math, so the output is bit for bit the plain version's.
// t comes from a sort network of fminf/fmaxf.
//
// Rows of up to kLaneMaxD = 64 values (the model's hidden width): one lane
// a row.  A block is one warp and its 32 rows; the warp stages them in
// shared memory with coalesced loads (all its loads in flight at once), at
// a stride of P+1 floats (odd, P = 32 or 64), so that the lanes' reads of
// their own rows hit 32 banks.  Each lane sorts its row in registers (an
// odd-even merge sort, padded with -inf to P), runs the 64 steps on its
// own (lo, hi, t), and the warp writes its rows coalesced, each row's
// threshold by a shuffle.  No atomics, no block barrier.  Wider rows: one
// warp a row (lane l holds columns l, l+32, ...), a warp-wide bitonic sort
// (a shuffle a register for strides below 32), t by one shuffle, the steps
// on every lane; there a lane's own network would outgrow its registers.
//
// Bound on the H100: memory, x read once and written once (8 bytes an
// element; 7.9 MB at 15,450 x 64).  Instructions a row at d 64: the lane's
// 543 comparators (1,086 fminf/fmaxf, which issue at half rate), 128 for
// min/max, 128 to pick t and about 320 for the 64 steps, plus the warp's
// staging and output (about 12 a row): about 65 warp instructions a row,
// against about 900 when a warp counted with ballots at each of the 64
// steps.
#include <cuda_runtime.h>

#include <math.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIters = 64;
constexpr int kLaneMaxD = 64;    // the widest row that one lane sorts
constexpr int kRows = 32;        // rows a block of the lane kernel
constexpr int kWarps = 8;        // rows (warps) a block of the warp kernel

// The 64 steps from (lo, hi) against t; returns hi, the threshold.
__device__ __forceinline__ float bisect(float lo, float hi, float t) {
#pragma unroll 8
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (mid <= t)
      lo = mid;
    else
      hi = mid;
  }
  return hi;
}

// Batcher's odd-even merge sort of v[0..N) ascending (N a power of two):
// 543 comparators at N 64, 191 at N 32, each an fminf and an fmaxf.  At
// merge size 2p and distance k the pair (a, a+k) is compared where a lies
// in the first half of its run of 2k from k % p on, and a and a+k lie in
// one run of 2p (loops of constant bounds, so that they unroll fully and
// v stays in registers).
template <int N>
__device__ __forceinline__ void sort_ascending(float (&v)[N]) {
#pragma unroll
  for (int p = 1; p < N; p <<= 1) {
#pragma unroll
    for (int k = p; k >= 1; k >>= 1) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        if (a + k < N && a >= k % p && (a - k % p) % (2 * k) < k &&
            a / (2 * p) == (a + k) / (2 * p)) {
          const float lo = fminf(v[a], v[a + k]);
          const float hi = fmaxf(v[a], v[a + k]);
          v[a] = lo;
          v[a + k] = hi;
        }
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kRows) drelu_lane_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int d,
    int k) {
  constexpr int kStride = P + 1;
  constexpr int kDpl = P / 32;   // columns a lane loads of a row
  __shared__ float tile[kRows * kStride];
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n - row0);
  const float* xb = x + row0 * d;
  float* ob = out + row0 * d;

  // stage the block's rows; the rows past n read as zeros (their lanes'
  // results are never written)
  float buf[kRows][kDpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kDpl; ++j) {
      const int c = lane + 32 * j;
      buf[r][j] = r < rows && c < d ? xb[(long long)r * d + c] : 0.f;
    }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kDpl; ++j) {
      const int c = lane + 32 * j;
      if (c < d) tile[r * kStride + c] = buf[r][j];
    }
  __syncwarp();

  const float* my = tile + lane * kStride;
  float v[P];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    v[i] = i < d ? my[i] : -INFINITY;
    if (i < d) {
      lo = fminf(lo, v[i]);
      hi = fmaxf(hi, v[i]);
    }
  }
  sort_ascending<P>(v);
  const int at = P - 1 - k;      // ascending, the -inf pads first
  float t = INFINITY;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i == at) t = v[i];
  hi = bisect(lo, hi, t);

  for (int r = 0; r < rows; ++r) {
    const float h = __shfl_sync(kFullMask, hi, r);
#pragma unroll
    for (int j = 0; j < kDpl; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        const float xv = tile[r * kStride + c];
        ob[(long long)r * d + c] = xv >= h ? xv : 0.f;
      }
    }
  }
}

template <int DPL>
__global__ void __launch_bounds__(32 * kWarps) drelu_warp_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int d,
    int k) {
  constexpr int P = 32 * DPL;    // DPL a power of two
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // the whole warp leaves together
  const float* xr = x + (long long)row * d;
  float v[DPL], s[DPL];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    v[j] = col < d ? xr[col] : 0.f;
    s[j] = col < d ? v[j] : -INFINITY;
    if (col < d) {
      lo = fminf(lo, v[j]);
      hi = fmaxf(hi, v[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFullMask, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFullMask, hi, off));
  }
  // element e = 32 * j + lane; at merge size sz the pair (e, e ^ st) goes
  // ascending where e & sz is 0
#pragma unroll
  for (int sz = 2; sz <= P; sz <<= 1) {
#pragma unroll
    for (int st = sz >> 1; st > 0; st >>= 1) {
      if (st >= 32) {
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int l = j ^ (st / 32);
          if (l > j) {
            const bool up = ((32 * j) & sz) == 0;
            const float a = fminf(s[j], s[l]), b = fmaxf(s[j], s[l]);
            s[j] = up ? a : b;
            s[l] = up ? b : a;
          }
        }
      } else {
        const bool lower = (lane & st) == 0;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const float o = __shfl_xor_sync(kFullMask, s[j], st);
          const bool up = ((32 * j + lane) & sz) == 0;
          s[j] = lower == up ? fminf(s[j], o) : fmaxf(s[j], o);
        }
      }
    }
  }
  const int at = P - 1 - k;
  float mine = s[0];
#pragma unroll
  for (int j = 1; j < DPL; ++j)
    if (at / 32 == j) mine = s[j];
  hi = bisect(lo, hi, __shfl_sync(kFullMask, mine, at % 32));
  float* o = out + (long long)row * d;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < d) o[col] = v[j] >= hi ? v[j] : 0.f;
  }
}

extern "C" int drelu_bisect(const float* x, float* out, int n, int d, int k,
                            cudaStream_t stream) {
  if (n == 0) return 0;
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  const int lane_blocks = (n + kRows - 1) / kRows;
  const int warp_blocks = (n + kWarps - 1) / kWarps;
  if (d <= kLaneMaxD && d <= 32)
    drelu_lane_kernel<32><<<lane_blocks, kRows, 0, stream>>>(x, out, n, d, k);
  else if (d <= kLaneMaxD && d <= 64)
    drelu_lane_kernel<64><<<lane_blocks, kRows, 0, stream>>>(x, out, n, d, k);
  else if (d <= 32)
    drelu_warp_kernel<1><<<warp_blocks, 32 * kWarps, 0, stream>>>(
        x, out, n, d, k);
  else if (d <= 64)
    drelu_warp_kernel<2><<<warp_blocks, 32 * kWarps, 0, stream>>>(
        x, out, n, d, k);
  else if (d <= 128)
    drelu_warp_kernel<4><<<warp_blocks, 32 * kWarps, 0, stream>>>(
        x, out, n, d, k);
  else
    drelu_warp_kernel<8><<<warp_blocks, 32 * kWarps, 0, stream>>>(
        x, out, n, d, k);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
