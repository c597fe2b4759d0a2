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
// included).  A block walks its chunk run (its schedule entry) and keeps
// each output row's sums in registers, so the result is fp32, has no
// atomics and is deterministic; a block with no chunk writes zeros.
//
// Bound on the H100: memory.  Each real slot gathers k scattered floats of
// one gY row (a 256-byte row at dim 64, mostly L2 hits) and each output row
// is written once.  Sampling 16 of 64 floats touches ~7.3 of the row's
// eight 32-byte sectors, so the L2 serves nearly what full-row gathers of
// the same slots would: ~194 MB on the first Table-1 batch, against the
// 21 MB the byte bound counts.
//
// Rows of k <= 32 sampled columns (arena_bwd_narrow: kernel 4's operands,
// kernel 8's at k <= 32).  A relation plan concatenates its relations'
// transposed arenas, each in ascending degree, so the row-blocks of long
// chunk runs (10-20 chunks on the Table-1 batch, 87 % of the chunks) sit
// mid-arena; taken in arena order they start after half the grid and, a
// chunk after another with two dependent round trips each (the chunk's
// neighbours and weights, then its gY samples), end long after the rest.
// So the narrow walk
//  * takes its row-blocks in the order of a schedule computed once per
//    arena on the device (drspmm.py, _arena_sched: longest chunk run
//    first, each entry the block and its chunk range, one 16-byte load),
//    the forward walk's schedule;
//  * gives a row KP lanes, KP the power of two that holds its k columns,
//    so a warp walks RPW = 32 / KP rows of its block side by side (two at
//    k <= 16): lane t of a row owns column t, samples it from every slot
//    of the row and adds it in registers, so no shared-memory scatter or
//    end-of-row fold is needed;
//  * reads a row's chunk run as one flat run of slots, KP at a time (lane
//    t: slot s0 + t), the neighbour and weight (or edge id) two windows
//    ahead and the weight gather one window ahead (run_slot in
//    arena_weights.cuh), so no gY sample waits on an index load;
//  * issues the gY samples of a batch of kBwdNarrowLoads slots a row
//    before it adds any, one FMA a slot in run order;
//  * skips a batch of padding slots warp-uniformly and issues no load for
//    a padding slot.
// Its long runs then move their sectors at ~8 TB/s on the card, and more
// samples in flight did not raise that: a row's run split over two warps,
// a batch carried while the next loads, several partial sums a lane and a
// cp.async ring that holds a whole batch in flight were each timed slower
// (tools/arena_bwd_probe.py --kernel 4; PERF.md).
// Columns outside [0, dim) sample nothing (they contribute 0).
// tools/arena_bwd_probe.py --kernel 4 times the walk at other batches.
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
//  * keeps one warp a row: the slots are added in run order, each lane's
//    sum one FMA a slot;
//  * asks ptxas for kBwdWideMinBlocks blocks an SM: left free, it keeps a
//    whole k = 64 batch in registers (123 of them, 2 blocks an SM), which
//    the probe timed slower on the card than 3 blocks at 80 registers.
// tools/arena_bwd_probe.py times the walk at other kBwdWideSlots and
// kBwdWideMinBlocks.
#pragma once

#include <cuda_runtime.h>

#include "arena_weights.cuh"
#include "cbsr_densify.cuh"   // kFullMask

constexpr int kBwdMaxRows = 8;   // rows per block
constexpr int kBwdMaxWide = 8;   // positions per lane for k > 32 (k <= 256)
constexpr int kBwdWideSlots = 16;  // slots a warp issues together at k <= 64
constexpr int kBwdWideMinBlocks = 3;  // blocks an SM must hold (<= 80 registers)

constexpr int kBwdNarrowLoads = 8;   // gY samples a lane issues at once

// The walk for k <= KP (design in the note at the top).  Block i walks
// row-block sched[i].x, whose chunks are sched[i].y .. sched[i].z; its warp
// w adds rows w*RPW .. w*RPW + RPW - 1, KP lanes a row, lane t the row's
// column t.
template <int KP, class W>
__global__ void __launch_bounds__(32 * kBwdMaxRows)
    arena_bwd_narrow(const int4* __restrict__ sched,
                     const int* __restrict__ nbr, W wsrc,
                     const int* __restrict__ src_rows,
                     const float* __restrict__ gy,
                     const int* __restrict__ xi, float* __restrict__ out,
                     int br, int ec, int k, int dim) {
  constexpr int RPW = 32 / KP;                         // rows a warp
  constexpr int L = kBwdNarrowLoads < KP ? kBwdNarrowLoads : KP;
  static_assert(KP % L == 0, "a batch of slots must divide a window");
  using WS = WeightStages<W>;
  const int4 blk = sched[blockIdx.x];
  const int lane = threadIdx.x;
  const int t = lane % KP;                             // this lane's column
  const int r = threadIdx.y * RPW + lane / KP;         // and its row
  const int c0 = blk.y;
  const int n = (blk.z - c0) * ec;                     // a row's slots
  const int lim = r < br ? n : 0;  // the last warp may hold a row too many
  const int sh = __ffs(ec) - 1;    // ec is 4, 8 or 16
  const long long row = (long long)blk.x * br + r;
  int col = -1;
  if (r < br && t < k && n > 0) {
    const int c = xi[(long long)src_rows[row] * k + t];
    if ((unsigned)c < (unsigned)dim) col = c;
  }
  // lane t of a row holds slot s0 + t of the current window of KP slots
  // (tgt_cur, w_cur) and of the next one (tgt_nxt, its weight's first
  // stage raw_nxt)
  typename WS::Raw raw_cur, raw_nxt;
  int tgt_cur = run_slot(nbr, wsrc, t, lim, c0, br, r, sh, raw_cur);
  int tgt_nxt = run_slot(nbr, wsrc, KP + t, lim, c0, br, r, sh, raw_nxt);
  float w_cur = WS::second(wsrc, raw_cur);
  float acc = 0.f;
  for (int s0 = 0; s0 < n; s0 += KP) {
    // in flight while this window is added: the next window's weights and
    // the slots of the window after it
    const float w_nxt = WS::second(wsrc, raw_nxt);
    typename WS::Raw raw_nn;
    const int tgt_nn =
        run_slot(nbr, wsrc, s0 + 2 * KP + t, lim, c0, br, r, sh, raw_nn);
    const int len = min(KP, n - s0);
#pragma unroll 1
    for (int i0 = 0; i0 < len; i0 += L) {
      if (!__any_sync(kFullMask, w_cur != 0.f &&
                                     (unsigned)(t - i0) < (unsigned)L))
        continue;  // L slots of padding in every row of the warp
      // issue the batch's samples (sample j: slot i0 + j of each row),
      // then add them in slot order
      float wt[L], g[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        wt[j] = __shfl_sync(kFullMask, w_cur, i0 + j, KP);
        const int tgt = __shfl_sync(kFullMask, tgt_cur, i0 + j, KP);
        g[j] = wt[j] != 0.f && col >= 0 ? gy[(long long)tgt * dim + col]
                                        : 0.f;
      }
#pragma unroll
      for (int j = 0; j < L; ++j) acc += wt[j] * g[j];
    }
    tgt_cur = tgt_nxt;
    w_cur = w_nxt;
    tgt_nxt = tgt_nn;
    raw_nxt = raw_nn;
  }
  if (r < br && t < k) out[row * k + t] = acc;
}

// The walk for 32 < k <= 32 * NG (design in the note at the top).  Warp r
// of the block adds row r's slots; the gY loads of S slots are issued
// together.
template <int NG, class W>
__global__ void __launch_bounds__(32 * kBwdMaxRows, kBwdWideMinBlocks)
    arena_bwd_wide(const int4* __restrict__ sched,
                   const int* __restrict__ nbr, W wsrc,
                   const int* __restrict__ src_rows,
                   const float* __restrict__ gy, const int* __restrict__ xi,
                   float* __restrict__ out, int ec, int k, int dim) {
  constexpr int S = 2 * kBwdWideSlots / NG;
  static_assert(S >= 1 && S <= 32 && 32 % S == 0,
                "a batch of slots must divide a 32-slot window");
  using WS = WeightStages<W>;
  const int4 blk = sched[blockIdx.x];
  const int b = blk.x;
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

  const int c0 = blk.y;
  const int n = (blk.z - c0) * ec;            // the row's slots
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
static void arena_bwd_launch_narrow(const int* sched, const int* nbr, W wsrc,
                                    const int* src_rows, const float* gy,
                                    const int* xi, float* out, int n_blocks,
                                    int row_block, int ec, int k, int dim,
                                    cudaStream_t stream) {
  constexpr int RPW = 32 / KP;
  const dim3 block(32, (row_block + RPW - 1) / RPW);
  arena_bwd_narrow<KP, W><<<n_blocks, block, 0, stream>>>(
      reinterpret_cast<const int4*>(sched), nbr, wsrc, src_rows, gy, xi,
      out, row_block, ec, k, dim);
}

// Launch the walk for any k <= 256 and Ec in {4, 8, 16}; returns a CUDA
// error code (cudaGetLastError right after the launch).  ``sched`` is the
// launch order of both walks, (n_blocks, 4) int32 rows (row-block, its
// first chunk, its end chunk, 0), longest chunk run first.
template <class W>
static int arena_bwd_dispatch(const int* sched,
                              const int* nbr, W wsrc, const int* src_rows,
                              const float* gy, const int* xi, float* out,
                              int n_blocks, int row_block, int ec, int k,
                              int dim, cudaStream_t stream) {
  if (row_block > kBwdMaxRows || k < 1 || k > 32 * kBwdMaxWide ||
      (ec != 4 && ec != 8 && ec != 16))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const dim3 wide(32, row_block);
  const int4* blocks = reinterpret_cast<const int4*>(sched);
  if (k <= 4)
    arena_bwd_launch_narrow<4>(sched, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (k <= 8)
    arena_bwd_launch_narrow<8>(sched, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (k <= 16)
    arena_bwd_launch_narrow<16>(sched, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (k <= 32)
    arena_bwd_launch_narrow<32>(sched, nbr, wsrc, src_rows, gy, xi, out, n_blocks, row_block, ec, k, dim, stream);
  else if (k <= 64)
    arena_bwd_wide<2, W><<<n_blocks, wide, 0, stream>>>(blocks, nbr, wsrc, src_rows, gy, xi, out, ec, k, dim);
  else if (k <= 128)
    arena_bwd_wide<4, W><<<n_blocks, wide, 0, stream>>>(blocks, nbr, wsrc, src_rows, gy, xi, out, ec, k, dim);
  else
    arena_bwd_wide<8, W><<<n_blocks, wide, 0, stream>>>(blocks, nbr, wsrc, src_rows, gy, xi, out, ec, k, dim);
  return (int)cudaGetLastError();
}
