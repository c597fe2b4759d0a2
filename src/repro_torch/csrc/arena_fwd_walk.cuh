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
//    order;
//  * padding slots (weight 0) are skipped warp-uniformly;
//  * row-blocks run heaviest first: the arena stores degree buckets in
//    ascending degree, so block b = n_blocks-1-blockIdx.x puts the evil
//    rows' long chunk runs at the front of the schedule instead of its tail.
//
// Rows wider than k = 32 (the learnable path's dense operand has k = dim)
// run arena_fwd_wide, which the launch picks by k.  There the time is set
// by the longest rows, not by bytes: a skewed arena's widest rows walk some
// 270 slots of 8k bytes each, and one warp's gathers are served at a
// roughly fixed rate however many of them it has in flight, so a row's time
// is its slots over that rate.  The wide walk therefore
//  * gives each row kWideParts warps, each adding a contiguous part of the
//    row's slots; the parts' sums meet in shared memory and are added in a
//    fixed order (deterministic, no atomics, one block owns its row-block);
//  * reads a part's slots 32 at a time (lane l: slot s0 + l), the
//    neighbour and edge id two windows ahead and the weight gather at that
//    id one window ahead, so neither is on the row's chain;
//  * issues the CBSR loads of S = kWidePairs / NG slots before it adds any
//    (NG groups of 32 pairs a slot), into registers;
//  * takes one __all_sync over those loaded columns: when every active pair
//    sits at column 32g + lane (a dense operand written as CBSR), each lane
//    adds its own pairs to acc[g], slot by slot, with no shared memory and
//    no barrier, which is the sum scatter_row_pairs gives in the same
//    order.  Otherwise each group of 32 pairs is asked the same question
//    and, if it fails, goes through scatter_row_pairs.  Every slot's
//    x_idx is read and no host code looks at it;
//  * issues no load for a padding slot and skips S slots of padding (all
//    weights 0) warp-uniformly.
// tools/arena_fwd_probe.py times the walk at other kWideParts and
// kWidePairs.
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

// A pair that adds something: a non-zero value at a column of the row.
__device__ __forceinline__ bool pair_active(float p, int c, int dim) {
  return p != 0.f && (unsigned)c < (unsigned)dim;
}

// One group of 32 pairs (lane t: value p, column c) into the lane-owned row.
// If every active pair sits at column 32*g + lane, each lane adds its own
// pair to acc[g]: what scatter_row_pairs adds, in the same order, without
// its owner table and barriers.  Otherwise the group goes through
// scatter_row_pairs (repeated columns: its broadcast fallback).  Every lane
// must call it, with the same g.
template <int DPL>
__device__ __forceinline__ void add_pair_group(float (&acc)[DPL], int* owner,
                                               float p, int c, int g, int dim,
                                               int lane) {
  const bool act = pair_active(p, c, dim);
  if (__all_sync(kFullMask, !act || c == 32 * g + lane)) {
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (j == g && act) acc[j] += p;
    return;
  }
  scatter_row_pairs<DPL>(acc, owner, p, c, dim, lane);
}

constexpr int kWideParts = 2;   // warps that share a row's chunk run
constexpr int kWidePairs = 8;   // pairs a lane has in flight

// The walk for 32 < k <= 32 * NG (design in the note at the top).  Warp
// (r, p) of the block, p < kWideParts, adds part p of row r's slots; the
// loads of S = kWidePairs / NG slots of a part are in flight together.
// The parts' sums are added in the order p = 0, 1, ... at the end.
template <int DPL, int NG, class W>
__global__ void __launch_bounds__(32 * kFwdMaxRows * kWideParts)
    arena_fwd_wide(const int* __restrict__ blk_ptr,
                   const int* __restrict__ nbr, W wsrc,
                   const float* __restrict__ xv, const int* __restrict__ xi,
                   float* __restrict__ out, int n_blocks, int ec, int k,
                   int dim) {
  constexpr int S = kWidePairs / NG;
  using WS = WeightStages<W>;
  // one owner table a warp; after the walk, the parts' partial rows
  __shared__ int owner_tab[kFwdMaxRows * kWideParts][32 * DPL];
  const int b = n_blocks - 1 - blockIdx.x;
  const int br = blockDim.y / kWideParts;
  const int r = threadIdx.y % br;
  const int p = threadIdx.y / br;
  const int lane = threadIdx.x;
  int* owner = owner_tab[threadIdx.y];
#pragma unroll
  for (int j = 0; j < DPL; ++j) owner[lane + 32 * j] = -1;
  __syncwarp();
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int c0 = blk_ptr[b];
  const int n = (blk_ptr[b + 1] - c0) * ec;  // the row's slots
  const int lo = n * p / kWideParts;         // this part: slots [lo, hi)
  const int hi = n * (p + 1) / kWideParts;
  const int sh = __ffs(ec) - 1;              // ec is 4, 8 or 16
  // lane l holds slot s0 + l of the current window (src_cur, w_cur) and of
  // the next one (src_nxt, its weight's first stage raw_nxt)
  typename WS::Raw raw_cur, raw_nxt;
  int src_cur = run_slot(nbr, wsrc, lo + lane, hi, c0, br, r, sh, raw_cur);
  int src_nxt =
      run_slot(nbr, wsrc, lo + 32 + lane, hi, c0, br, r, sh, raw_nxt);
  float w_cur = WS::second(wsrc, raw_cur);
  for (int s0 = lo; s0 < hi; s0 += 32) {
    // in flight while this window is added: the next window's weights and
    // the slots of the window after it
    const float w_nxt = WS::second(wsrc, raw_nxt);
    typename WS::Raw raw_nn;
    const int src_nn =
        run_slot(nbr, wsrc, s0 + 64 + lane, hi, c0, br, r, sh, raw_nn);
#pragma unroll 1
    for (int i0 = 0; i0 < 32; i0 += S) {
      if (!__any_sync(kFullMask, w_cur != 0.f &&
                                     (unsigned)(lane - i0) < (unsigned)S))
        continue;  // S slots of padding
      // issue the S slots' loads first: lane t holds pair 32g + t
      float v[S][NG];
      int col[S][NG];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float wt = __shfl_sync(kFullMask, w_cur, i0 + i);
        const long long row =
            (long long)__shfl_sync(kFullMask, src_cur, i0 + i) * k;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int t = 32 * g + lane;
          const bool ld = wt != 0.f && t < k;
          v[i][g] = ld ? xv[row + t] : 0.f;
          col[i][g] = ld ? xi[row + t] : 0;
        }
      }
      // the pairs' products, and one vote for the whole batch: does every
      // active pair sit at column 32g + lane?
      bool aligned = true;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float wt = __shfl_sync(kFullMask, w_cur, i0 + i);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          v[i][g] *= wt;
          aligned = aligned && (!pair_active(v[i][g], col[i][g], dim) ||
                                col[i][g] == 32 * g + lane);
        }
      }
      if (__all_sync(kFullMask, aligned)) {
        // each lane adds its own pairs, slot by slot: what the scatter
        // adds, in the same order, with no dependence between slots
#pragma unroll
        for (int i = 0; i < S; ++i)
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int j = 0; j < DPL; ++j)
              if (j == g && pair_active(v[i][g], col[i][g], dim))
                acc[j] += v[i][g];
        continue;
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (__shfl_sync(kFullMask, w_cur, i0 + i) == 0.f)
          continue;  // warp-uniform
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (32 * g < k)  // warp-uniform
            add_pair_group<DPL>(acc, owner, v[i][g], col[i][g], g, dim, lane);
      }
    }
    src_cur = src_nxt;
    w_cur = w_nxt;
    src_nxt = src_nn;
    raw_nxt = raw_nn;
  }
  // parts 1.. park their sums in the (now idle) owner tables; part 0 adds
  // them in order and writes the row
  float* parked = reinterpret_cast<float*>(&owner_tab[0][0]);
  __syncthreads();
  if (p > 0) {
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      parked[((p - 1) * br + r) * 32 * DPL + lane + 32 * j] = acc[j];
  }
  __syncthreads();
  if (p > 0) return;
  for (int q = 1; q < kWideParts; ++q) {
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      acc[j] += parked[((q - 1) * br + r) * 32 * DPL + lane + 32 * j];
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
  if (k > 32) {  // wide CBSR rows: kWideParts warps a row
    const dim3 wide(32, row_block * kWideParts);
    if (ec != 4 && ec != 8 && ec != 16) return (int)cudaErrorInvalidValue;
    if (k <= 64)
      arena_fwd_wide<DPL, 2, W><<<n_blocks, wide, 0, stream>>>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, ec, k, dim);
    else if (k <= 128)
      arena_fwd_wide<DPL, 4, W><<<n_blocks, wide, 0, stream>>>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, ec, k, dim);
    else
      arena_fwd_wide<DPL, 8, W><<<n_blocks, wide, 0, stream>>>(blk_ptr, nbr, wsrc, xv, xi, out, n_blocks, ec, k, dim);
    return 0;
  }
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
