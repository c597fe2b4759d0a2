// Row walk of the DR-SpMM arena forward, shared by the fixed-weight kernel
// (drspmm_arena_fwd.cu) and the learnable-edge kernel
// (drspmm_learnable_fwd.cu), which differ only in where a slot's weight
// comes from (arena_weights.cuh):
//
//   Y[blk*BR + r] = sum over the block's chunks c, slots e of
//                   w(c,r,e) * densify(x_vals[nbr[c,r,e]], x_idx[nbr[c,r,e]])
//
// One thread block per output row-block (every block of the arena, the
// trailing all-zero sentinel included), one warp per row of the block.  The
// block walks its chunk run blk_ptr[b]..blk_ptr[b+1] and keeps the row in
// registers (lane l owns columns l, l+32, ...), so the sum is fp32, has no
// atomics, and is deterministic; a block with no chunk writes zeros.
//
// Bound on the H100: memory.  Each real slot gathers one CBSR row (k values
// + k indices, 8k bytes, mostly L2 hits: the operand slab is a few MB), and
// each output row is written once.  What the design does about it:
//  * all Ec slots of a chunk row issue their CBSR loads together (lane t
//    holds pair t of every slot), so a chunk costs one memory round trip;
//  * the scatter of a slot's k pairs into the lane-owned columns is a
//    permutation, not a broadcast (scatter_row_pairs in cbsr_densify.cuh):
//    a few shared-memory operations per group of 32 pairs instead of 32
//    broadcast shuffles.  Zero-valued pairs (the k padding of the type
//    concat, CBSR filler) add nothing and are skipped; a group whose
//    non-zero pairs repeat a column (outside the CBSR contract, but legal
//    input) falls back to the broadcast scatter, which adds every pair in
//    order.  Rows wider than k = 32 (the learnable path's dense operand has
//    k = dim) scatter slot by slot, 32 pairs at a time, with every group's
//    loads issued first;
//  * padding slots (weight 0) are skipped warp-uniformly;
//  * row-blocks run heaviest first: the arena stores degree buckets in
//    ascending degree, so block b = n_blocks-1-blockIdx.x puts the evil
//    rows' long chunk runs at the front of the schedule instead of its tail.
#pragma once

#include <cuda_runtime.h>

#include "arena_weights.cuh"
#include "cbsr_densify.cuh"

constexpr int kFwdMaxRows = 8;    // rows (warps) per block
constexpr int kFwdMaxGroups = 8;  // groups of 32 pairs per CBSR row (k <= 256)

template <int DPL, int EC, class W>
__global__ void __launch_bounds__(256) arena_fwd_kernel(
    const int* __restrict__ blk_ptr, const int* __restrict__ nbr, W wsrc,
    const float* __restrict__ xv, const int* __restrict__ xi,
    float* __restrict__ out, int n_blocks, int k, int dim) {
  __shared__ int owner_tab[kFwdMaxRows][32 * DPL];
  const int b = n_blocks - 1 - blockIdx.x;
  const int br = blockDim.y;
  const int r = threadIdx.y;
  const int lane = threadIdx.x;
  int* owner = owner_tab[r];
#pragma unroll
  for (int j = 0; j < DPL; ++j) owner[lane + 32 * j] = -1;
  __syncwarp();
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
      my_w = wsrc(slot0 + lane);
    }
    if (k > 32) {  // wide CBSR rows: slot by slot, 32 pairs at a time
      for (int e = 0; e < EC; ++e) {
        const float wt = __shfl_sync(kFullMask, my_w, e);
        const int src = __shfl_sync(kFullMask, my_n, e);
        if (wt == 0.f) continue;  // warp-uniform
        float pv[kFwdMaxGroups];
        int pc[kFwdMaxGroups];
#pragma unroll
        for (int g = 0; g < kFwdMaxGroups; ++g) {
          const int t = 32 * g + lane;
          pv[g] = 0.f;
          pc[g] = 0;
          if (t < k) {
            pv[g] = wt * xv[(long long)src * k + t];
            pc[g] = xi[(long long)src * k + t];
          }
        }
#pragma unroll
        for (int g = 0; g < kFwdMaxGroups; ++g)
          if (32 * g < k)  // warp-uniform
            scatter_row_pairs<DPL>(acc, owner, pv[g], pc[g], dim, lane);
      }
      continue;
    }
    // issue every slot's loads first: lane t holds pair t of slot e
    float pv[EC];
    int pc[EC];
#pragma unroll
    for (int e = 0; e < EC; ++e) {
      const float wt = __shfl_sync(kFullMask, my_w, e);
      const int src = __shfl_sync(kFullMask, my_n, e);
      pv[e] = 0.f;
      pc[e] = 0;
      if (wt != 0.f && lane < k) {
        pv[e] = wt * xv[(long long)src * k + lane];
        pc[e] = xi[(long long)src * k + lane];
      }
    }
#pragma unroll
    for (int e = 0; e < EC; ++e)
      scatter_row_pairs<DPL>(acc, owner, pv[e], pc[e], dim, lane);
  }
  float* o = out + ((long long)b * br + r) * dim;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < dim) o[col] = acc[j];
  }
}

template <int DPL, class W>
static int arena_fwd_launch_ec(const int* blk_ptr, const int* nbr, W wsrc,
                               const float* xv, const int* xi, float* out,
                               int n_blocks, int row_block, int ec, int k,
                               int dim, cudaStream_t stream) {
  const dim3 block(32, row_block);
  switch (ec) {
    case 4: arena_fwd_kernel<DPL, 4, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, k, dim); break;
    case 8: arena_fwd_kernel<DPL, 8, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, k, dim); break;
    case 16: arena_fwd_kernel<DPL, 16, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, k, dim); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Launch the walk for any dim <= 256 and Ec in {4, 8, 16}; returns a CUDA
// error code (cudaGetLastError right after the launch).
template <class W>
static int arena_fwd_dispatch(const int* blk_ptr, const int* nbr, W wsrc,
                              const float* xv, const int* xi, float* out,
                              int n_blocks, int row_block, int ec, int k,
                              int dim, cudaStream_t stream) {
  if (row_block > kFwdMaxRows || k < 1 || k > 32 * kFwdMaxGroups)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  int rc;
  switch ((dim + 31) / 32) {
    case 1: rc = arena_fwd_launch_ec<1>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 2: rc = arena_fwd_launch_ec<2>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 3: rc = arena_fwd_launch_ec<3>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 4: rc = arena_fwd_launch_ec<4>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 5: rc = arena_fwd_launch_ec<5>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 6: rc = arena_fwd_launch_ec<6>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 7: rc = arena_fwd_launch_ec<7>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 8: rc = arena_fwd_launch_ec<8>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
