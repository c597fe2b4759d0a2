// Row walk of the DR-SpMM arena sampled backward (Alg. 2, SSpMM), shared by
// the fixed-weight kernel (drspmm_arena_bwd.cu) and the learnable-edge
// kernel (drspmm_learnable_bwd.cu), which differ only in where a slot's
// weight comes from (arena_weights.cuh):
//
//   dV[j, t] = sum over the block's chunks c, slots e of
//              w(c,r,e) * gY[nbr[c,r,e], xi[src_rows[j], t]]   j = blk*BR + r
//
// Only the k sampled columns of each gY row are ever read, so the dense
// (N, dim) cotangent Aᵀ·gY is never formed.  Each arena row reads its CBSR
// indices straight from xi at src_rows[j]; no arena-ordered copy of xi is
// built.
//
// One thread block per output row-block (the trailing all-zero sentinel
// included), one warp per row of the block.  The block walks its chunk run
// blk_ptr[b]..blk_ptr[b+1] and keeps the row's k sums in registers, so the
// result is fp32, has no atomics and is deterministic; a block with no chunk
// writes zeros.
//
// Bound on the H100: memory.  Each real slot gathers k scattered floats of
// one gY row (a 256-byte row at dim 64, mostly L2 hits) and each output row
// is written once.  What the design does about it:
//  * for k <= 32 the warp splits into G = 32/KP slot groups of KP lanes
//    (KP = k rounded up to a power of two, at least 4): lane (s, t) samples
//    position t of slots s, s+G, ...  At k = 16 two slots are read per warp
//    instruction and all of a chunk row's loads are issued before any is
//    added, so a chunk row costs one memory round trip.  The groups' partial
//    sums are folded by shuffles at the end, in a fixed order;
//  * a chunk row whose slots are all padding (weight 0) is skipped
//    warp-uniformly, and padding slots issue no load;
//  * row-blocks run heaviest first: the arena stores degree buckets in
//    ascending degree, so block b = n_blocks-1-blockIdx.x puts the long
//    chunk runs at the front of the schedule.
// Columns outside [0, dim) sample nothing (they contribute 0).
//
// Rows wider than k = 32 (the learnable path's GAT shape has k = dim = 64)
// run arena_bwd_wide, which the launch picks by k.  There each lane owns
// the NG = k/32 positions lane, lane+32, ... of its row, so a slot costs
// each lane NG loads of one gY row.  A transposed arena's rows are short
// (the homogenized Table-1 partition: at most 80 slots, ~37 on average),
// so what sets the time is not one long row's gather rate but the chain of
// dependent loads a chunk needs: its neighbour and edge id, then the
// w_canon gather at that id, then the gY rows behind that weight.  The
// wide walk therefore
//  * reads the row's chunk run as one flat run of slots, 32 at a time
//    (lane l: slot s0 + l), the neighbour and edge id two windows ahead and
//    the w_canon gather one window ahead (run_slot, WeightStages in
//    arena_weights.cuh), so neither is on the row's chain;
//  * issues the gY loads of S = 2 * kBwdWideSlots / NG slots (a compile-time
//    batch, fully unrolled) before it adds any, into registers;
//  * issues no load for a padding slot (past the run's end, or weight 0)
//    and skips S slots of padding warp-uniformly;
//  * keeps one warp a row, as the narrow walk does: the slots are added in
//    run order, each lane's sum one FMA a slot;
//  * asks ptxas for kBwdWideMinBlocks blocks an SM: left free, it keeps a
//    whole k = 64 batch in registers (123 of them, 2 blocks an SM), which
//    the probe timed slower on the card than 3 blocks at 80 registers.
// tools/arena_bwd_probe.py times the walk at other kBwdWideSlots and
// kBwdWideMinBlocks.
#pragma once

#include <cuda_runtime.h>

#include "arena_weights.cuh"
#include "cbsr_densify.cuh"   // kFullMask

constexpr int kBwdMaxRows = 8;   // rows (warps) per block
constexpr int kBwdMaxWide = 8;   // positions per lane for k > 32 (k <= 256)
constexpr int kBwdWideSlots = 16;  // slots a warp issues together at k <= 64
constexpr int kBwdWideMinBlocks = 3;  // blocks an SM must hold (<= 80 registers)

template <int KP, int EC, class W>
__global__ void __launch_bounds__(256) arena_bwd_narrow(
    const int* __restrict__ blk_ptr, const int* __restrict__ nbr, W wsrc,
    const int* __restrict__ src_rows, const float* __restrict__ gy,
    const int* __restrict__ xi, float* __restrict__ out, int n_blocks, int k,
    int dim) {
  constexpr int G = 32 / KP;               // slot groups per warp
  constexpr int NI = (EC + G - 1) / G;     // slot iterations per chunk row
  const int b = n_blocks - 1 - blockIdx.x;
  const int br = blockDim.y;
  const int lane = threadIdx.x;
  const int t = lane % KP;
  const int s = lane / KP;
  const long long row = (long long)b * br + threadIdx.y;
  int col = -1;
  if (t < k) {
    const int c = xi[(long long)src_rows[row] * k + t];
    if ((unsigned)c < (unsigned)dim) col = c;
  }
  float acc = 0.f;
  const int c1 = blk_ptr[b + 1];
  for (int ch = blk_ptr[b]; ch < c1; ++ch) {
    const long long slot0 = ((long long)ch * br + threadIdx.y) * EC;
    int my_n = 0;
    float my_w = 0.f;
    if (lane < EC) {
      my_n = nbr[slot0 + lane];
      my_w = wsrc(slot0 + lane);
    }
    if (!__any_sync(kFullMask, my_w != 0.f)) continue;   // all padding
    float wt[NI], g[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int e = s + G * i;             // < 32; lanes >= EC hold w = 0
      wt[i] = __shfl_sync(kFullMask, my_w, e);
      const int tgt = __shfl_sync(kFullMask, my_n, e);
      g[i] = 0.f;
      if (e < EC && wt[i] != 0.f && col >= 0)
        g[i] = gy[(long long)tgt * dim + col];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) acc += wt[i] * g[i];
  }
#pragma unroll
  for (int off = 16; off >= KP; off >>= 1)
    acc += __shfl_down_sync(kFullMask, acc, off);
  if (s == 0 && t < k) out[row * k + t] = acc;
}

// The walk for 32 < k <= 32 * NG (design in the note at the top).  Warp r
// of the block adds row r's slots; the gY loads of S slots are issued
// together.
template <int NG, class W>
__global__ void __launch_bounds__(32 * kBwdMaxRows, kBwdWideMinBlocks)
    arena_bwd_wide(const int* __restrict__ blk_ptr,
                   const int* __restrict__ nbr, W wsrc,
                   const int* __restrict__ src_rows,
                   const float* __restrict__ gy, const int* __restrict__ xi,
                   float* __restrict__ out, int n_blocks, int ec, int k,
                   int dim) {
  constexpr int S = 2 * kBwdWideSlots / NG;
  static_assert(S >= 1 && S <= 32 && 32 % S == 0,
                "a batch of slots must divide a 32-slot window");
  using WS = WeightStages<W>;
  const int b = n_blocks - 1 - blockIdx.x;
  const int br = blockDim.y;
  const int r = threadIdx.y;
  const int lane = threadIdx.x;
  const long long row = (long long)b * br + r;
  const int* xr = xi + (long long)src_rows[row] * k;
  int col[NG];
  float acc[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int t = lane + 32 * j;
    col[j] = -1;
    acc[j] = 0.f;
    if (t < k && (unsigned)xr[t] < (unsigned)dim) col[j] = xr[t];
  }

  const int c0 = blk_ptr[b];
  const int n = (blk_ptr[b + 1] - c0) * ec;   // the row's slots
  const int sh = __ffs(ec) - 1;               // ec is 4, 8 or 16
  // lane l holds slot s0 + l of the current window (tgt_cur, w_cur) and of
  // the next one (tgt_nxt, its weight's first stage raw_nxt)
  typename WS::Raw raw_cur, raw_nxt;
  int tgt_cur = run_slot(nbr, wsrc, lane, n, c0, br, r, sh, raw_cur);
  int tgt_nxt = run_slot(nbr, wsrc, 32 + lane, n, c0, br, r, sh, raw_nxt);
  float w_cur = WS::second(wsrc, raw_cur);
  for (int s0 = 0; s0 < n; s0 += 32) {
    // in flight while this window is added: the next window's weights and
    // the slots of the window after it
    const float w_nxt = WS::second(wsrc, raw_nxt);
    typename WS::Raw raw_nn;
    const int tgt_nn =
        run_slot(nbr, wsrc, s0 + 64 + lane, n, c0, br, r, sh, raw_nn);
#pragma unroll 1
    for (int i0 = 0; i0 < 32; i0 += S) {
      if (!__any_sync(kFullMask, w_cur != 0.f &&
                                     (unsigned)(lane - i0) < (unsigned)S))
        continue;  // S slots of padding
      // issue the S slots' loads first: lane l samples positions l + 32j
      float wt[S], g[S][NG];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        wt[i] = __shfl_sync(kFullMask, w_cur, i0 + i);
        const float* gr =
            gy + (long long)__shfl_sync(kFullMask, tgt_cur, i0 + i) * dim;
#pragma unroll
        for (int j = 0; j < NG; ++j)
          g[i][j] = wt[i] != 0.f && col[j] >= 0 ? gr[col[j]] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < NG; ++j) acc[j] += wt[i] * g[i][j];
    }
    tgt_cur = tgt_nxt;
    w_cur = w_nxt;
    tgt_nxt = tgt_nn;
    raw_nxt = raw_nn;
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int t = lane + 32 * j;
    if (t < k) out[row * k + t] = acc[j];
  }
}

template <int KP, class W>
static int arena_bwd_launch_ec(const int* blk_ptr, const int* nbr, W wsrc,
                               const int* src_rows, const float* gy,
                               const int* xi, float* out, int n_blocks,
                               int row_block, int ec, int k, int dim,
                               cudaStream_t stream) {
  const dim3 block(32, row_block);
  switch (ec) {
    case 4: arena_bwd_narrow<KP, 4, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, k, dim); break;
    case 8: arena_bwd_narrow<KP, 8, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, k, dim); break;
    case 16: arena_bwd_narrow<KP, 16, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, k, dim); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Launch the walk for any k <= 256 and Ec in {4, 8, 16}; returns a CUDA
// error code (cudaGetLastError right after the launch).
template <class W>
static int arena_bwd_dispatch(const int* blk_ptr, const int* nbr, W wsrc,
                              const int* src_rows, const float* gy,
                              const int* xi, float* out, int n_blocks,
                              int row_block, int ec, int k, int dim,
                              cudaStream_t stream) {
  if (row_block > kBwdMaxRows || k < 1 || k > 32 * kBwdMaxWide)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  int rc = 0;
  if (k <= 4)
    rc = arena_bwd_launch_ec<4>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (k <= 8)
    rc = arena_bwd_launch_ec<8>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (k <= 16)
    rc = arena_bwd_launch_ec<16>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (k <= 32)
    rc = arena_bwd_launch_ec<32>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (ec == 4 || ec == 8 || ec == 16) {
    const dim3 block(32, row_block);
    if (k <= 64)
      arena_bwd_wide<2, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, ec, k, dim);
    else if (k <= 128)
      arena_bwd_wide<4, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, ec, k, dim);
    else
      arena_bwd_wide<8, W><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, wsrc, src_rows, gy, xi, out, n_blocks, ec, k, dim);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
