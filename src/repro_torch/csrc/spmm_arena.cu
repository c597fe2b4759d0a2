// Dense-operand SpMM over the fused arena for Hopper (sm_90a).
//
// Replaces the TPU kernel spmm_dense_fused (src/repro/kernels/drspmm.py),
// the executor of ops.spmm: the D-ReLU-off DR-CircuitGNN (the paper's
// dense-SpMM baseline) and the GCN / GraphSAGE baselines, forward over the
// arena of A and backward over the arena of Aᵀ with gY as the operand:
//
//   Y[blk*BR + r, :] = sum over the block's chunks c, slots e of
//                      w[c,r,e] * x[nbr[c,r,e], :]
//
// One thread block per output row-block (the trailing all-zero sentinel
// included), one warp per row of the block.  The block walks its chunk run
// blk_ptr[b]..blk_ptr[b+1] and keeps the row in registers (lane l owns
// columns l, l+32, ...: at dim 64 a lane reads two floats of each
// neighbour's contiguous 256-byte row), so the sum is fp32, has no atomics
// and is deterministic; a block with no chunk writes zeros.
//
// Bound on the H100: memory.  Each real slot reads one dense row of x
// (dim floats, mostly L2 hits at Table-1 size) and each output row is
// written once.  What the design does about it:
//  * the loads of a chunk row's slots are issued together (up to 32
//    floats a lane in flight), so a chunk row costs about one memory round
//    trip instead of one per neighbour;
//  * a chunk row whose slots are all padding (w == 0) is skipped
//    warp-uniformly, and padding slots issue no load;
//  * row-blocks run heaviest first: the arena stores degree buckets in
//    ascending degree, so block b = n_blocks-1-blockIdx.x puts the long
//    chunk runs at the front of the schedule.
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxRows = 8;   // rows (warps) per block

template <int DPL, int EC>
__global__ void __launch_bounds__(256) spmm_arena_kernel(
    const int* __restrict__ blk_ptr, const int* __restrict__ nbr,
    const float* __restrict__ w, const float* __restrict__ x,
    float* __restrict__ out, int n_blocks, int dim) {
  // slots whose loads are in flight together: at most 32 floats a lane
  constexpr int SB = (32 / DPL < EC) ? 32 / DPL : EC;
  const int b = n_blocks - 1 - blockIdx.x;
  const int br = blockDim.y;
  const int r = threadIdx.y;
  const int lane = threadIdx.x;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int c1 = blk_ptr[b + 1];
  for (int c = blk_ptr[b]; c < c1; ++c) {
    const long long slot0 = ((long long)c * br + r) * EC;
    int my_n = 0;
    float my_w = 0.f;
    if (lane < EC) {
      my_n = nbr[slot0 + lane];
      my_w = w[slot0 + lane];
    }
    if (!__any_sync(kFullMask, my_w != 0.f)) continue;   // all padding
#pragma unroll
    for (int e0 = 0; e0 < EC; e0 += SB) {
      float wt[SB], v[SB][DPL];
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        wt[i] = __shfl_sync(kFullMask, my_w, e0 + i);
        const int src = __shfl_sync(kFullMask, my_n, e0 + i);
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
  float* o = out + ((long long)b * br + r) * dim;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < dim) o[col] = acc[j];
  }
}

template <int DPL>
static int launch_ec(const int* blk_ptr, const int* nbr, const float* w,
                     const float* x, float* out, int n_blocks, int row_block,
                     int ec, int dim, cudaStream_t stream) {
  const dim3 block(32, row_block);
  switch (ec) {
    case 4: spmm_arena_kernel<DPL, 4><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, w, x, out, n_blocks, dim); break;
    case 8: spmm_arena_kernel<DPL, 8><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, w, x, out, n_blocks, dim); break;
    case 16: spmm_arena_kernel<DPL, 16><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, w, x, out, n_blocks, dim); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

extern "C" int spmm_arena(const int* blk_ptr, const int* nbr, const float* w,
                          const float* x, float* out, int n_blocks,
                          int row_block, int ec, int dim,
                          cudaStream_t stream) {
  if (row_block > kMaxRows) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  int rc;
  switch ((dim + 31) / 32) {
    case 1: rc = launch_ec<1>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    case 2: rc = launch_ec<2>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    case 3: rc = launch_ec<3>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    case 4: rc = launch_ec<4>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    case 5: rc = launch_ec<5>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    case 6: rc = launch_ec<6>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    case 7: rc = launch_ec<7>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    case 8: rc = launch_ec<8>(blk_ptr, nbr, w, x, out, n_blocks, row_block, ec, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
