// Per-degree-bucket dense-operand SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernel spmm_dense_bucket (src/repro/kernels/drspmm.py),
// the executor of ops.spmm's per-bucket loop (backend "bucket"): the
// relations of a node type that stays dense (D-ReLU off, or k >= width) and
// the GCN / GraphSAGE baselines, forward over the buckets of A and backward
// over the buckets of Aᵀ with gY as the operand.  One launch per degree
// bucket, straight over the bucket's ELL slab (nbr, w), both (R, E):
//
//   Y[r, :] = sum_e w[r,e] * x[nbr[r,e], :]                     Y: (R, D)
//
// Rows are bucket-local; the caller adds them into the relation's output at
// the bucket's row ids (index_add_, since the padding rows repeat row 0).
//
// One warp per slab row, eight rows a block.  Lane l owns columns l, l+32,
// ... (at D = 64 a lane reads two floats of each neighbour's contiguous
// 256-byte row), so the sum is fp32, has no atomics and is deterministic.
// The row's E slots are walked 32 at a time (any E): lane s loads slot s's
// neighbour and weight once, and the warp broadcasts them with shuffles.
//
// Bound on the H100: memory.  Each real slot reads one dense row of x (D
// floats, mostly L2 hits at Table-1 size) and each output row is written
// once.  What the design does about it:
//  * the loads of up to eight slots are issued together (at most 32 floats
//    a lane in flight), so eight slots cost about one memory round trip;
//  * padding slots (weight 0) issue no load, and a group of 32 slots that
//    is all padding is skipped warp-uniformly.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRows = 8;   // slab rows (warps) per block

template <int DPL>
__global__ void __launch_bounds__(256) spmm_bucket_kernel(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const float* __restrict__ x, float* __restrict__ out, int n_rows,
    int e_width, int dim) {
  // slots in flight together: a power of two (divides 32), <= 32 floats a lane
  constexpr int SB = DPL <= 4 ? 8 : 4;
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.y;
  if (row >= n_rows) return;  // warp-uniform; the kernel has no block sync
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int* nr = nbr + row * e_width;
  const float* wr = w + row * e_width;
  for (int e0 = 0; e0 < e_width; e0 += 32) {
    int my_n = 0;
    float my_w = 0.f;
    if (e0 + lane < e_width) {
      my_n = nr[e0 + lane];
      my_w = wr[e0 + lane];
    }
    if (!__any_sync(kFullMask, my_w != 0.f)) continue;  // all padding
    const int ne = min(32, e_width - e0);
    // s0 + i < 32: lanes past the slab's end hold weight 0 and load nothing
    for (int s0 = 0; s0 < ne; s0 += SB) {
      float wt[SB], v[SB][DPL];
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        wt[i] = __shfl_sync(kFullMask, my_w, s0 + i);
        const int src = __shfl_sync(kFullMask, my_n, s0 + i);
        const float* xr = x + (long long)src * dim;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int col = lane + 32 * j;
          v[i][j] = (wt[i] != 0.f && col < dim) ? xr[col] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < SB; ++i)
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[j] += wt[i] * v[i][j];
    }
  }
  float* o = out + row * dim;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < dim) o[col] = acc[j];
  }
}

template <int DPL>
void launch(const int* nbr, const float* w, const float* x, float* out,
            int n_rows, int e_width, int dim, cudaStream_t stream) {
  const int grid = (n_rows + kRows - 1) / kRows;
  spmm_bucket_kernel<DPL><<<grid, dim3(32, kRows), 0, stream>>>(
      nbr, w, x, out, n_rows, e_width, dim);
}

}  // namespace

// Y (n_rows, dim) of one bucket slab; any e_width >= 1, 1 <= dim <= 256.
// Returns a CUDA error code (cudaGetLastError right after the launch).
extern "C" int spmm_bucket(const int* nbr, const float* w, const float* x,
                           float* out, int n_rows, int e_width, int dim,
                           cudaStream_t stream) {
  if (e_width < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  switch ((dim + 31) / 32) {
    case 1: launch<1>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 2: launch<2>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 3: launch<3>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 4: launch<4>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 5: launch<5>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 6: launch<6>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 7: launch<7>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 8: launch<8>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
