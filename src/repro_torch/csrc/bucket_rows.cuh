// The split slab-row walk of the per-bucket kernels that read whole rows of
// a dense operand: kernel 12 (spmm_bucket.cu, x[nbr, :]) and the k > 32
// branch of kernel 11 (drspmm_bucket_bwd.cu, gY[nbr, xi_rows]).
//
// A slab row of E slots is split over P warps (split_parts: P from E
// alone).  The row's batches of S slots are dealt to the parts in turn
// (batch b to part b mod P), not cut into contiguous runs: ELL rows put
// their real slots first and end early (a 1696 x 256 bucket's rows hold 96
// real slots on average), so contiguous runs of E / P slots left most
// parts of such a row idle at the barrier; dealt in turn, every part gets
// a share of the real slots.  Each part adds its batches into its own
// registers; the P partial rows then meet in shared memory after the
// block's one barrier and are added in the fixed order p = 0..P-1
// (combine_parts), so every output element has one writer: fp32, no
// atomics, the same bits from run to run.  Within a part (walk_batches):
//  * a window of 32 lanes holds the part's next 32 / S batches, and the
//    neighbours and weights of the window after the next are loaded while
//    this one is added, so no row gather waits on an index load and a
//    window of padding costs no round trip on the chain;
//  * one ballot a window finds its real slots (weight != 0): only they
//    load, and a batch of padding is skipped warp-uniformly;
//  * the row loads of a batch of S slots are issued before any is added,
//    then added in slot order, each slot's weight shuffled at its add (no
//    register holds a weight from its load to its add); the window's
//    batches are unrolled, which took the dim-64 walk from 56 registers to
//    48 (five blocks an SM instead of four).
#pragma once

#include <cuda_runtime.h>

namespace bucket_rows {

constexpr unsigned kFullMask = 0xffffffffu;

// Warps a slab row of e_width slots is split over: 1 up to 32 slots, p64
// up to 64, then one warp per `slots` slots, at most max_parts.  The
// launch is a grid of (32, P, rows) blocks, rows = block_warps / P, so no
// thread divides by P.
inline int split_parts(int e_width, int p64, int slots, int max_parts) {
  if (e_width <= 32) return 1;
  if (e_width <= 64) return p64;
  const int p = (e_width + slots - 1) / slots;
  return p < max_parts ? p : max_parts;
}

// Slots a batch: the largest power of two (at most a 32-slot window) whose
// loads keep at most `loads` floats a lane in flight.
__host__ __device__ constexpr int batch_of(int floats_a_slot, int loads) {
  int s = 1;
  while (2 * s <= 32 && 2 * s * floats_a_slot <= loads) s *= 2;
  return s;
}

// Adds w[base + e] * src[nbr[base + e] * stride + cols.col(j)] into acc[j]
// (j < NC, where cols.ok(j) holds) for the slots e of part p of one slab
// row of e_width slots split over `parts` warps: the row's batches of S
// slots (batch b: slots S b .. S b + S - 1) go to the parts in turn, b = p,
// p + P, p + 2P, ..., added in that order.  A window of 32 lanes holds the
// part's next 32 / S batches.  Every lane of the warp must call it.
template <int NC, int S, class Cols>
__device__ __forceinline__ void walk_batches(const int* __restrict__ nbr,
                                             const float* __restrict__ w,
                                             long long base, int e_width,
                                             int p, int parts,
                                             const float* __restrict__ src,
                                             int stride, const Cols& cols,
                                             float (&acc)[NC], int lane) {
  constexpr unsigned kBatchMask = S == 32 ? kFullMask : (1u << S) - 1u;
  constexpr int BW = 32 / S;                    // batches a window
  // lane l's slot in window v: e0 + v step (batch p + P (BW v + l / S));
  // a slot at or past e_width is padding (weight 0)
  const int e0 = S * (p + parts * (lane / S)) + lane % S;
  const int step = S * parts * BW;
  float w_cur = 0.f, w_nxt = 0.f;
  int n_cur = 0, n_nxt = 0;
  if (e0 < e_width) {
    w_cur = w[base + e0];
    n_cur = nbr[base + e0];
  }
  if (e0 + step < e_width) {
    w_nxt = w[base + e0 + step];
    n_nxt = nbr[base + e0 + step];
  }
  // a window holds a batch of the row while its first slot, S p + v step,
  // is inside it (no division by P on the chain)
  for (int first = S * p; first < e_width; first += step) {
    // in flight while this window is added: the window after the next
    float w_nn = 0.f;
    int n_nn = 0;
    const int e_nn = e0 - S * p + first + 2 * step;
    if (e_nn < e_width) {
      w_nn = w[base + e_nn];
      n_nn = nbr[base + e_nn];
    }
    const unsigned real = __ballot_sync(kFullMask, w_cur != 0.f);
#pragma unroll
    for (int i0 = 0; i0 < 32; i0 += S) {
      const unsigned live = (real >> i0) & kBatchMask;
      if (!live) continue;  // S slots of padding
      // issue the S slots' row loads first, then add them in slot order
      float v_[S][NC];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float* xr =
            src + (long long)__shfl_sync(kFullMask, n_cur, i0 + i) * stride;
#pragma unroll
        for (int j = 0; j < NC; ++j)
          v_[i][j] = ((live >> i) & 1u) && cols.ok(j) ? xr[cols.col(j)] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float wt = __shfl_sync(kFullMask, w_cur, i0 + i);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] += wt * v_[i][j];
      }
    }
    n_cur = n_nxt;
    w_cur = w_nxt;
    n_nxt = n_nn;
    w_nxt = w_nn;
  }
}

// The block's parts meet: the block is (32, P, rows), warp (p, r) part p
// of its row r.  Each warp parks its partial row acc (lane l holding
// entries l + 32 j) in part[r][p]; after the block's one barrier, part p
// writes the row's entries 32 p + l, 32 (p + P) + l, ... below n_out, each
// the sum over q = 0..P-1 in that order.  Every thread of the block must
// call it.
template <int NC, int W>
__device__ __forceinline__ void combine_parts(float (&part)[W][32 * NC],
                                              const float (&acc)[NC],
                                              bool live,
                                              float* __restrict__ o,
                                              int n_out, int lane) {
  const int p = threadIdx.y, parts = blockDim.y;
  const float(*mine)[32 * NC] = part + threadIdx.z * parts;
#pragma unroll
  for (int j = 0; j < NC; ++j) part[threadIdx.z * parts + p][lane + 32 * j] =
      acc[j];
  __syncthreads();
  if (!live) return;
  for (int c = 32 * p + lane; c < n_out; c += 32 * parts) {
    float s = mine[0][c];
    for (int q = 1; q < parts; ++q) s += mine[q][c];
    o[c] = s;
  }
}

}  // namespace bucket_rows
