// Row walk of the DR-SpMM arena forward, shared by the fixed-weight kernel
// (drspmm_arena_fwd.cu) and the learnable-edge kernel
// (drspmm_learnable_fwd.cu), which differ only in where a slot's weight
// comes from (arena_weights.cuh):
//
//   Y[blk*BR + r] = sum over the block's chunks c, slots e of
//                   w(c,r,e) * densify(x_vals[nbr[c,r,e]], x_idx[nbr[c,r,e]])
//
// One thread block per output row-block (every block of the arena, the
// trailing all-zero sentinel included), each row of the block walked by one
// or more warps.  A block with no chunk writes zeros; there are no atomics
// and the sum is fp32 and deterministic.
//
// Bound on the H100: memory.  Each real slot gathers one CBSR row (k values
// + k indices, 8k bytes, mostly L2 hits: the operand slab is a few MB), and
// each output row is written once.
//
// Rows of k <= 32 pairs (arena_fwd_narrow: kernel 1's operands, kernel 7's
// at k <= 32).  A Table-1 super-arena has row-blocks of 65 chunks (260
// slots a row) among thousands of one or two, and a relation plan
// concatenates its relations' arenas, each in ascending degree, so the
// longest runs sit in the middle of the arena, not at either end.  Taken
// in arena order, such a run starts after half the grid and ends long
// after everything else.  Once they start first, the time is the rate of
// the walk: a slot costs a few tens of warp instructions, and the arena
// has 830k of them.  So the narrow walk
//  * takes its row-blocks in the order of a schedule computed once per
//    arena on the device (drspmm.py, _arena_sched): longest chunk run
//    first, each entry the block and its chunk range, one 16-byte load;
//  * gives a row KP lanes, KP the power of two that holds its k pairs, so
//    a warp walks RPW = 32 / KP rows of its block side by side (two at
//    k <= 16, four at k <= 8): every warp-wide load and add serves RPW
//    slots at once, and the rows of a block share one chunk run;
//  * reads a row's chunk run as one flat run of slots, KP at a time (lane
//    t: the part's slot v0 + t), the neighbour and weight (or edge id) two
//    windows ahead and the weight gather one window ahead (run_slot in
//    arena_weights.cuh), so no CBSR load waits on an index load;
//  * issues a batch of kNarrowLoads slots' CBSR loads a row, then adds the
//    batch before it while they are in flight;
//  * adds a slot into its row in shared memory, one read-add-write per pair
//    (add_batch): a slot's columns are distinct under the CBSR contract,
//    so its pairs add at once, each column summing its pairs in slot
//    order, and the rows of a warp never share a column.  A slot that
//    repeats a column (legal input outside the contract) shows in a byte
//    tag table a slot, written and read back once a batch, and that batch
//    adds its pairs one at a time; zero-valued pairs and columns outside
//    [0, dim) add nothing;
//  * splits a run over kNarrowParts warps a row, which take its slots in
//    turns of kNarrowSplit (part p the turns p, p + kNarrowParts, ...: one
//    chunk of 8 slots a turn at Ec 8, so the parts' shares differ by one
//    turn at most); the parts' rows are added in the order p = 0, 1, ...
//    after the block's one barrier, so a long run's chain is cut and the
//    output stays deterministic.  Which part adds a slot depends on the
//    slot's position alone, never on the run's length: a block's run is
//    as long as its longest row, and in a collated batch that row may be
//    another member's, so a member's rows come out bit for bit the same
//    whatever graphs share its batch;
//  * skips a batch of padding slots warp-uniformly and issues no load for
//    a padding slot.
// tools/arena_fwd_probe.py --kernel 1 times the walk at other constants.
//
// Rows wider than k = 32 (the learnable path's dense operand has k = dim)
// run arena_fwd_wide, which the launch picks by k.  There the time is set
// by the longest rows, not by bytes: a skewed arena's widest rows walk some
// 270 slots of 8k bytes each, and one warp's gathers are served at a
// roughly fixed rate however many of them it has in flight, so a row's time
// is its slots over that rate.  The wide walk therefore
//  * gives each row kWideParts warps, which take the row's slots in turns
//    of kWideSplit (by position, so a member's rows do not depend on its
//    batch's other members); the parts' sums meet in shared memory and are
//    added in a fixed order (deterministic, no atomics, one block owns its
//    row-block);
//  * reads a part's slots 32 at a time (lane l: its slot v0 + l), the
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
//    weights 0) warp-uniformly;
//  * takes its row-blocks in the narrow walk's schedule order (longest
//    chunk run first), each entry the block and its chunk range.
// tools/arena_fwd_probe.py times the walk at other kWideParts and
// kWidePairs.
#pragma once

#include <cuda_runtime.h>

#include "arena_weights.cuh"
#include "cbsr_densify.cuh"

constexpr int kFwdMaxRows = 8;    // rows per block
constexpr int kFwdMaxGroups = 8;  // groups of 32 pairs per CBSR row (k <= 256)

constexpr int kNarrowParts = 2;      // warps that share a row's run
constexpr int kNarrowSplit = 8;      // slots of a run a part takes a turn

// P parts that take a run's slots in turns of G: the run slot of part p's
// v-th slot (turn j of part p holds slots (j*P + p)*G .. (j*P + p)*G + G-1)
// and how many of a run of n slots part p takes.  part_slot is increasing
// in v, and part_slot(v, p) >= n for every v >= part_slots(n, p).
template <int P, int G>
__device__ __forceinline__ int part_slot(int v, int p) {
  return (v / G) * (P * G) + p * G + v % G;
}
template <int P, int G>
__device__ __forceinline__ int part_slots(int n, int p) {
  return (n / (P * G)) * G + min(max(n % (P * G) - p * G, 0), G);
}
constexpr int kNarrowLoads = 4;      // CBSR loads a lane issues at once

// A pair that adds something: a non-zero value at a column of the row.
__device__ __forceinline__ bool pair_active(float p, int c, int dim) {
  return p != 0.f && (unsigned)c < (unsigned)dim;
}

// A batch of L slots of one row added into the row, in shared memory, slot
// after slot.  The KP lanes of the row's group call it together, lane t
// holding pair t of slot j of the batch: value v[j] with the slot's weight
// applied, column c[j].  Every active pair first writes its lane into its
// slot's tag table (L tables of 32*DPL bytes in ``tag``) at its column; a
// lane that reads back another lane's tag shares its column with a pair
// of its own slot (outside the CBSR contract, but legal input), and then
// the warp adds the batch's pairs one at a time, in pair order.
// Otherwise each slot's pairs add at once, one read-add-write each.  Every
// lane of the warp must call it (each group with its own row and tags).
template <int DPL, int L>
__device__ __forceinline__ void add_batch(float* row, unsigned char* tag,
                                          const float (&v)[L],
                                          const int (&c)[L], int dim,
                                          int lane) {
  constexpr int TAB = 32 * DPL;
  __syncwarp();  // the previous batch's tags are read
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (pair_active(v[j], c[j], dim)) tag[j * TAB + c[j]] = (unsigned char)lane;
  __syncwarp();
  bool lost = false;
#pragma unroll
  for (int j = 0; j < L; ++j)
    lost = lost || (pair_active(v[j], c[j], dim) && tag[j * TAB + c[j]] != lane);
  if (__any_sync(kFullMask, lost)) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      for (int s = 0; s < 32; ++s) {
        if (lane == s && pair_active(v[j], c[j], dim)) row[c[j]] += v[j];
        __syncwarp();
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (pair_active(v[j], c[j], dim)) row[c[j]] += v[j];
    __syncwarp();
  }
}

// Slots a batch of a row of KP lanes and DPL columns a lane: at most
// kNarrowLoads and KP, halved until the block's rows and tag tables
// (kNarrowParts * 8 rows of 32*DPL floats and L * 32*DPL bytes) fit in
// 48 KB of static shared memory.
__host__ __device__ constexpr int narrow_batch(int dpl, int kp) {
  int l = kNarrowLoads < kp ? kNarrowLoads : kp;
  while (l > 1 && kNarrowParts * kFwdMaxRows * 32 * dpl * (4 + l) > 49152)
    l /= 2;
  return l;
}

// The walk for k <= KP (design in the note at the top).  Block i walks
// row-block sched[i].x, whose chunks are sched[i].y .. sched[i].z; its warp
// (p, w), p < kNarrowParts, adds part p of the slots of rows w*RPW ..
// w*RPW + RPW - 1, KP lanes a row.
template <int DPL, int KP, class W>
__global__ void __launch_bounds__(32 * kFwdMaxRows * kNarrowParts)
    arena_fwd_narrow(const int4* __restrict__ sched,
                     const int* __restrict__ nbr, W wsrc,
                     const float* __restrict__ xv, const int* __restrict__ xi,
                     float* __restrict__ out, int br, int ec, int k,
                     int dim) {
  constexpr int RPW = 32 / KP;                     // rows a warp
  constexpr int L = narrow_batch(DPL, KP);          // slots a batch
  static_assert(KP % L == 0, "a batch of slots must divide a window");
  using WS = WeightStages<W>;
  // each part's rows, and their tag tables
  __shared__ float row_tab[kNarrowParts * kFwdMaxRows][32 * DPL];
  __shared__ unsigned char
      tag_tab[kNarrowParts * kFwdMaxRows][L * 32 * DPL];
  const int4 blk = sched[blockIdx.x];
  const int lane = threadIdx.x;
  const int wpp = blockDim.y / kNarrowParts;       // warps a part
  const int p = threadIdx.y / wpp;
  const int t = lane % KP;                         // this lane's pair
  const int r = (threadIdx.y % wpp) * RPW + lane / KP;  // and its row
  const int c0 = blk.y;
  const int n = (blk.z - c0) * ec;                 // a row's slots
  // this part's share of them, its v-th at run slot at(v)
  const int m = part_slots<kNarrowParts, kNarrowSplit>(n, p);
  const auto at = [p](int v) {
    return part_slot<kNarrowParts, kNarrowSplit>(v, p);
  };
  const int lim = r < br ? n : 0;   // the last warp may hold a row too many
  const int sh = __ffs(ec) - 1;     // ec is 4, 8 or 16
  float* row = row_tab[p * kFwdMaxRows + r];
  unsigned char* tag = tag_tab[p * kFwdMaxRows + r];
  for (int e = t; e < 32 * DPL; e += KP) row[e] = 0.f;
  // lane t of a row holds the part's slot v0 + t of the current window of
  // KP slots (src_cur, w_cur) and of the next one (src_nxt, its weight's
  // first stage raw_nxt)
  typename WS::Raw raw_cur, raw_nxt;
  int src_cur = run_slot(nbr, wsrc, at(t), lim, c0, br, r, sh, raw_cur);
  int src_nxt = run_slot(nbr, wsrc, at(KP + t), lim, c0, br, r, sh, raw_nxt);
  float w_cur = WS::second(wsrc, raw_cur);
  // the batch before the one whose loads are in flight, added meanwhile
  float pv[L];
  int pc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    pv[j] = 0.f;
    pc[j] = 0;
  }
  bool pending = false;
  for (int v0 = 0; v0 < m; v0 += KP) {
    // in flight while this window is added: the next window's weights and
    // the slots of the window after it
    const float w_nxt = WS::second(wsrc, raw_nxt);
    typename WS::Raw raw_nn;
    const int src_nn =
        run_slot(nbr, wsrc, at(v0 + 2 * KP + t), lim, c0, br, r, sh, raw_nn);
    const int len = min(KP, m - v0);
#pragma unroll 1
    for (int i0 = 0; i0 < len; i0 += L) {
      if (!__any_sync(kFullMask, w_cur != 0.f &&
                                     (unsigned)(t - i0) < (unsigned)L))
        continue;  // L slots of padding in every row of the warp
      // issue the batch's loads (load j: slot i0 + j of each row), then add
      // the batch before it
      float v[L];
      int col[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float wt = __shfl_sync(kFullMask, w_cur, i0 + j, KP);
        const long long base =
            (long long)__shfl_sync(kFullMask, src_cur, i0 + j, KP) * k + t;
        const bool ld = wt != 0.f && t < k;
        v[j] = ld ? wt * xv[base] : 0.f;
        col[j] = ld ? xi[base] : 0;
      }
      if (pending) add_batch<DPL, L>(row, tag, pv, pc, dim, lane);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        pv[j] = v[j];
        pc[j] = col[j];
      }
      pending = true;
    }
    src_cur = src_nxt;
    w_cur = w_nxt;
    src_nxt = src_nn;
    raw_nxt = raw_nn;
  }
  if (pending) add_batch<DPL, L>(row, tag, pv, pc, dim, lane);
  __syncthreads();
  if (p > 0 || r >= br) return;
  // part 0 adds the other parts' rows in order and writes the row
  for (int o = 1; o < kNarrowParts; ++o)
    for (int e = t; e < 32 * DPL; e += KP)
      row[e] += row_tab[o * kFwdMaxRows + r][e];
  float* y = out + ((long long)blk.x * br + r) * dim;
  for (int e = t; e < dim; e += KP) y[e] = row[e];
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
constexpr int kWideSplit = 8;   // slots of a run a part takes a turn
constexpr int kWidePairs = 8;   // pairs a lane has in flight

// The walk for 32 < k <= 32 * NG (design in the note at the top).  Warp
// (r, p) of the block, p < kWideParts, adds part p of row r's slots; the
// loads of S = kWidePairs / NG slots of a part are in flight together.
// The parts' sums are added in the order p = 0, 1, ... at the end.
template <int DPL, int NG, class W>
__global__ void __launch_bounds__(32 * kFwdMaxRows * kWideParts)
    arena_fwd_wide(const int4* __restrict__ sched,
                   const int* __restrict__ nbr, W wsrc,
                   const float* __restrict__ xv, const int* __restrict__ xi,
                   float* __restrict__ out, int ec, int k, int dim) {
  constexpr int S = kWidePairs / NG;
  using WS = WeightStages<W>;
  // one owner table a warp; after the walk, the parts' partial rows
  __shared__ int owner_tab[kFwdMaxRows * kWideParts][32 * DPL];
  const int4 blk = sched[blockIdx.x];
  const int b = blk.x;
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

  const int c0 = blk.y;
  const int n = (blk.z - c0) * ec;           // the row's slots
  // part p takes the row's slots in turns of kWideSplit (by position, as
  // the narrow walk); its v-th slot is run slot at(v)
  const int m = part_slots<kWideParts, kWideSplit>(n, p);
  const auto at = [p](int v) {
    return part_slot<kWideParts, kWideSplit>(v, p);
  };
  const int sh = __ffs(ec) - 1;              // ec is 4, 8 or 16
  // lane l holds the part's slot v0 + l of the current window (src_cur,
  // w_cur) and of the next one (src_nxt, its weight's first stage raw_nxt)
  typename WS::Raw raw_cur, raw_nxt;
  int src_cur = run_slot(nbr, wsrc, at(lane), n, c0, br, r, sh, raw_cur);
  int src_nxt = run_slot(nbr, wsrc, at(32 + lane), n, c0, br, r, sh, raw_nxt);
  float w_cur = WS::second(wsrc, raw_cur);
  for (int v0 = 0; v0 < m; v0 += 32) {
    // in flight while this window is added: the next window's weights and
    // the slots of the window after it
    const float w_nxt = WS::second(wsrc, raw_nxt);
    typename WS::Raw raw_nn;
    const int src_nn =
        run_slot(nbr, wsrc, at(v0 + 64 + lane), n, c0, br, r, sh, raw_nn);
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
static int arena_fwd_launch_ec(const int* sched,
                               const int* nbr, W wsrc,
                               const float* xv, const int* xi, float* out,
                               int n_blocks, int row_block, int ec, int k,
                               int dim, cudaStream_t stream) {
  if (ec != 4 && ec != 8 && ec != 16) return (int)cudaErrorInvalidValue;
  const int4* blocks = reinterpret_cast<const int4*>(sched);
  if (k > 32) {  // wide CBSR rows: kWideParts warps a row
    const dim3 wide(32, row_block * kWideParts);
    if (k <= 64)
      arena_fwd_wide<DPL, 2, W><<<n_blocks, wide, 0, stream>>>(blocks, nbr, wsrc, xv, xi, out, ec, k, dim);
    else if (k <= 128)
      arena_fwd_wide<DPL, 4, W><<<n_blocks, wide, 0, stream>>>(blocks, nbr, wsrc, xv, xi, out, ec, k, dim);
    else
      arena_fwd_wide<DPL, 8, W><<<n_blocks, wide, 0, stream>>>(blocks, nbr, wsrc, xv, xi, out, ec, k, dim);
    return 0;
  }
  // KP lanes a row: four rows a warp at k <= 8, two at k <= 16
  if (k <= 8)
    arena_fwd_narrow<DPL, 8, W><<<n_blocks, dim3(32, (row_block + 3) / 4 * kNarrowParts), 0, stream>>>(blocks, nbr, wsrc, xv, xi, out, row_block, ec, k, dim);
  else if (k <= 16)
    arena_fwd_narrow<DPL, 16, W><<<n_blocks, dim3(32, (row_block + 1) / 2 * kNarrowParts), 0, stream>>>(blocks, nbr, wsrc, xv, xi, out, row_block, ec, k, dim);
  else
    arena_fwd_narrow<DPL, 32, W><<<n_blocks, dim3(32, row_block * kNarrowParts), 0, stream>>>(blocks, nbr, wsrc, xv, xi, out, row_block, ec, k, dim);
  return 0;
}

// Launch the walk for any dim <= 256 and Ec in {4, 8, 16}; returns a CUDA
// error code (cudaGetLastError right after the launch).  ``sched`` is the
// launch order of both walks, (n_blocks, 4) int32 rows (row-block, its
// first chunk, its end chunk, 0), longest chunk run first.
template <class W>
static int arena_fwd_dispatch(const int* sched,
                              const int* nbr, W wsrc,
                              const float* xv, const int* xi, float* out,
                              int n_blocks, int row_block, int ec, int k,
                              int dim, cudaStream_t stream) {
  if (row_block > kFwdMaxRows || k < 1 || k > 32 * kFwdMaxGroups)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  int rc;
  switch ((dim + 31) / 32) {
    case 1: rc = arena_fwd_launch_ec<1>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 2: rc = arena_fwd_launch_ec<2>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 3: rc = arena_fwd_launch_ec<3>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 4: rc = arena_fwd_launch_ec<4>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 5: rc = arena_fwd_launch_ec<5>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 6: rc = arena_fwd_launch_ec<6>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 7: rc = arena_fwd_launch_ec<7>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    case 8: rc = arena_fwd_launch_ec<8>(sched, nbr, wsrc, xv, xi, out, n_blocks, row_block, ec, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
