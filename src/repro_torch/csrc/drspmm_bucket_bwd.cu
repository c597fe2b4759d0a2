// Per-degree-bucket DR-SpMM sampled backward (Alg. 2, SSpMM) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel drspmm_bwd_bucket (src/repro/kernels/drspmm.py),
// the executor of ops.drspmm's per-bucket backward (backend "bucket"): one
// launch per degree bucket of the TRANSPOSED packing, straight over the
// bucket's ELL slab (nbr, w), both (R, E):
//
//   dV[j, t] = sum_e w[j,e] * gY[nbr[j,e], xi_rows[j, t]]      dV: (R, k)
//
// with xi_rows = x_idx gathered at the bucket's source rows.  Only the k
// sampled columns of each gY row are read, so the dense (N, dim) cotangent
// Aᵀ·gY is never formed.  Each source row j is owned by one warp, so the sum
// is fp32, has no atomics and is deterministic; the caller adds the rows
// into dV at the bucket's row ids (index_add_).
//
// Bound on the H100: memory.  Each real slot gathers k scattered floats of
// one gY row (a 256-byte row at dim 64, mostly L2 hits) and each output row
// is written once.  What the design does about it:
//  * for k <= 32 the warp splits into G = 32/KP slot groups of KP lanes
//    (KP = k rounded up to a power of two, at least 4): lane (s, t) samples
//    position t of slots s, s+G, ...  All of a group of 32 slots' loads are
//    issued before any is added, so 32 slots cost about one memory round
//    trip; the groups' partial sums are folded by shuffles in a fixed order;
//  * rows wider than 32 use one lane per position (up to 8 a lane), slot by
//    slot;
//  * padding slots (weight 0) issue no load, and a group of 32 slots that
//    is all padding is skipped warp-uniformly.
// Columns outside [0, dim) sample nothing (they contribute 0).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRows = 8;      // slab rows (warps) per block
constexpr int kMaxWide = 8;   // positions per lane for k > 32 (k <= 256)

template <int KP>
__global__ void __launch_bounds__(256) bucket_bwd_narrow(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const float* __restrict__ gy, const int* __restrict__ xi_rows,
    float* __restrict__ out, int n_rows, int e_width, int k, int dim) {
  constexpr int G = 32 / KP;   // slot groups per warp
  constexpr int NI = 32 / G;   // slots per lane for a group of 32 slots
  const int lane = threadIdx.x;
  const int t = lane % KP;
  const int s = lane / KP;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.y;
  if (row >= n_rows) return;  // warp-uniform; the kernel has no block sync
  int col = -1;
  if (t < k) {
    const int c = xi_rows[row * k + t];
    if ((unsigned)c < (unsigned)dim) col = c;
  }
  const int* nr = nbr + row * e_width;
  const float* wr = w + row * e_width;
  float acc = 0.f;
  for (int e0 = 0; e0 < e_width; e0 += 32) {
    int my_n = 0;
    float my_w = 0.f;
    if (e0 + lane < e_width) {
      my_n = nr[e0 + lane];
      my_w = wr[e0 + lane];
    }
    if (!__any_sync(kFullMask, my_w != 0.f)) continue;  // all padding
    float wt[NI], g[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int e = s + G * i;  // < 32; lanes past the slab's end hold w = 0
      wt[i] = __shfl_sync(kFullMask, my_w, e);
      const int tgt = __shfl_sync(kFullMask, my_n, e);
      g[i] = 0.f;
      if (wt[i] != 0.f && col >= 0) g[i] = gy[(long long)tgt * dim + col];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) acc += wt[i] * g[i];
  }
#pragma unroll
  for (int off = 16; off >= KP; off >>= 1)
    acc += __shfl_down_sync(kFullMask, acc, off);
  if (s == 0 && t < k) out[row * k + t] = acc;
}

__global__ void __launch_bounds__(256) bucket_bwd_wide(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const float* __restrict__ gy, const int* __restrict__ xi_rows,
    float* __restrict__ out, int n_rows, int e_width, int k, int dim) {
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.y;
  if (row >= n_rows) return;
  const int* xr = xi_rows + row * k;
  int col[kMaxWide];
  float acc[kMaxWide];
#pragma unroll
  for (int j = 0; j < kMaxWide; ++j) {
    const int t = lane + 32 * j;
    col[j] = -1;
    acc[j] = 0.f;
    if (t < k && (unsigned)xr[t] < (unsigned)dim) col[j] = xr[t];
  }
  const int* nr = nbr + row * e_width;
  const float* wr = w + row * e_width;
  for (int e0 = 0; e0 < e_width; e0 += 32) {
    int my_n = 0;
    float my_w = 0.f;
    if (e0 + lane < e_width) {
      my_n = nr[e0 + lane];
      my_w = wr[e0 + lane];
    }
    const int ne = min(32, e_width - e0);
    for (int e = 0; e < ne; ++e) {
      const float wt = __shfl_sync(kFullMask, my_w, e);
      const int tgt = __shfl_sync(kFullMask, my_n, e);
      if (wt == 0.f) continue;  // warp-uniform
      const float* gr = gy + (long long)tgt * dim;
#pragma unroll
      for (int j = 0; j < kMaxWide; ++j)
        if (col[j] >= 0) acc[j] += wt * gr[col[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxWide; ++j) {
    const int t = lane + 32 * j;
    if (t < k) out[row * k + t] = acc[j];
  }
}

template <int KP>
void launch_narrow(const int* nbr, const float* w, const float* gy,
                   const int* xi_rows, float* out, int n_rows, int e_width,
                   int k, int dim, cudaStream_t stream) {
  const int grid = (n_rows + kRows - 1) / kRows;
  bucket_bwd_narrow<KP><<<grid, dim3(32, kRows), 0, stream>>>(
      nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim);
}

}  // namespace

// dV (n_rows, k) of one transposed bucket slab; any e_width >= 1,
// 1 <= k <= 256.  Returns a CUDA error code (cudaGetLastError right after
// the launch).
extern "C" int drspmm_bucket_bwd(const int* nbr, const float* w,
                                 const float* gy, const int* xi_rows,
                                 float* out, int n_rows, int e_width, int k,
                                 int dim, cudaStream_t stream) {
  if (e_width < 1 || k < 1 || k > 32 * kMaxWide || dim < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  if (k <= 4)
    launch_narrow<4>(nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim, stream);
  else if (k <= 8)
    launch_narrow<8>(nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim, stream);
  else if (k <= 16)
    launch_narrow<16>(nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim, stream);
  else if (k <= 32)
    launch_narrow<32>(nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim, stream);
  else
    bucket_bwd_wide<<<(n_rows + kRows - 1) / kRows, dim3(32, kRows), 0,
                      stream>>>(nbr, w, gy, xi_rows, out, n_rows, e_width, k,
                                dim);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
