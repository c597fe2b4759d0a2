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
// included), one warp per row of the block.  The warp keeps the row in
// registers (lane l owns columns l, l+32, ...: at dim 64 a lane reads two
// floats of each neighbour's contiguous 256-byte row), adding the row's
// slots in run order (chunk by chunk, slot by slot), so the sum is fp32,
// has no atomics, is deterministic and is bit for bit the chunk-at-a-time
// walk's; a block with no chunk writes zeros.
//
// Bound on the H100: memory.  Each real slot reads one whole dense row of
// x (dim floats, mostly L2 hits at Table-1 size: x fits in the 50 MB L2)
// and each output row is written once.  The rows of a row-block are almost
// all distinct (97 % on the Table-1 `near` arena), so nothing is worth
// staging; the floor is the L2's rate for the 32-byte sectors of those
// rows (768,846 slots x 8 sectors = 197 MB a call on the Table-1 batch),
// not the 14 MB the byte bound counts.  The chunk runs are long (up to 65
// chunks of 4 slots a row on that batch) and, walked a chunk at a time,
// each chunk cost two dependent round trips (its ids, then its rows).  So
// the walk
//  * takes its row-blocks in the order of a schedule computed once per
//    arena on the device (drspmm.py, _arena_sched: longest chunk run
//    first, each entry the block and its chunk range, one 16-byte load),
//    so the long runs start first;
//  * reads a row's chunk run as one flat run of slots, 32 at a time (lane
//    l: slot s0 + l), the neighbour and weight two windows ahead (run_slot
//    in arena_weights.cuh), so no row gather waits on an index load;
//  * issues the row loads of a batch of S slots (kSpmmLoads floats a lane)
//    before it adds any, then adds them in slot order;
//  * issues no load for a padding slot (past the run's end, or weight 0)
//    and skips a batch of padding warp-uniformly, both read from one
//    ballot of the window's real slots, and shuffles a slot's weight only
//    at its add, so no register holds a weight from its load to its add;
//  * keeps 16 floats a lane in flight (8 slots at dim 64) at 40 registers,
//    six blocks an SM (kSpmmMinBlocks): the Table-1 transposed arena's
//    rows hold 40-80 slots, so a row's chain start (its schedule entry,
//    then its ids) is a large share of its life, and more warps an SM
//    hide it better than more loads a warp; the forward's 260-slot rows
//    lost nothing to the smaller batches.
// On the Table-1 batch it then reads its sectors at ~7.0 (forward) and
// ~8.3 TB/s (transposed).  Float2 loads, 32 floats a lane at four blocks
// an SM and other register caps were no faster
// (tools/arena_fwd_probe.py --kernel 6 times the walk at other kSpmmLoads
// and kSpmmMinBlocks; PERF.md).
#include <cuda_runtime.h>

#include "arena_weights.cuh"

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxRows = 8;        // rows (warps) per block
constexpr int kSpmmLoads = 16;     // floats a lane has in flight a batch
constexpr int kSpmmMinBlocks = 6;  // blocks an SM must hold

// Slots a batch: the largest power of two (at most a 32-slot window) whose
// loads keep at most kSpmmLoads floats a lane in flight.
__host__ __device__ constexpr int batch_of(int floats_a_slot) {
  int s = 1;
  while (2 * s <= 32 && 2 * s * floats_a_slot <= kSpmmLoads) s *= 2;
  return s;
}

// Block i walks row-block sched[i].x, whose chunks are sched[i].y ..
// sched[i].z; warp r adds its row r, lane l its columns l + 32 j (j < DPL).
template <int DPL>
__global__ void __launch_bounds__(32 * kMaxRows, kSpmmMinBlocks)
    spmm_arena_kernel(const int4* __restrict__ sched,
                      const int* __restrict__ nbr, FixedWeights wsrc,
                      const float* __restrict__ x, float* __restrict__ out,
                      int ec, int dim) {
  constexpr int S = batch_of(DPL);
  constexpr unsigned kBatchMask = S == 32 ? kFullMask : (1u << S) - 1u;
  const int4 blk = sched[blockIdx.x];
  const int br = blockDim.y;
  const int r = threadIdx.y;
  const int lane = threadIdx.x;
  const int c0 = blk.y;
  const int n = (blk.z - c0) * ec;            // the row's slots
  const int sh = __ffs(ec) - 1;               // ec is 4, 8 or 16
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  // lane l holds slot s0 + l of the current window (src_cur, w_cur) and of
  // the next one (src_nxt, w_nxt)
  float w_cur, w_nxt;
  int src_cur = run_slot(nbr, wsrc, lane, n, c0, br, r, sh, w_cur);
  int src_nxt = run_slot(nbr, wsrc, 32 + lane, n, c0, br, r, sh, w_nxt);
  for (int s0 = 0; s0 < n; s0 += 32) {
    // in flight while this window is added: the slots of the window after
    // the next
    float w_nn;
    const int src_nn =
        run_slot(nbr, wsrc, s0 + 64 + lane, n, c0, br, r, sh, w_nn);
    const int len = min(32, n - s0);
    const unsigned real = __ballot_sync(kFullMask, w_cur != 0.f);
#pragma unroll 1
    for (int i0 = 0; i0 < len; i0 += S) {
      const unsigned live = (real >> i0) & kBatchMask;
      if (!live) continue;  // S slots of padding
      // issue the S slots' row loads first, then add them in slot order
      float v[S][DPL];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float* xr =
            x + (long long)__shfl_sync(kFullMask, src_cur, i0 + i) * dim;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int col = lane + 32 * j;
          v[i][j] = ((live >> i) & 1u) && col < dim ? xr[col] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float wt = __shfl_sync(kFullMask, w_cur, i0 + i);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[j] += wt * v[i][j];
      }
    }
    src_cur = src_nxt;
    w_cur = w_nxt;
    src_nxt = src_nn;
    w_nxt = w_nn;
  }
  float* o = out + ((long long)blk.x * br + r) * dim;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < dim) o[col] = acc[j];
  }
}

// The launch for any dim <= 256 and Ec in {4, 8, 16}; returns a CUDA error
// code (cudaGetLastError right after the launch).  ``sched`` is the launch
// order, (n_blocks, 4) int32 rows (row-block, its first chunk, its end
// chunk, 0), longest chunk run first.
extern "C" int spmm_arena(const int* sched, const int* nbr, const float* w,
                          const float* x, float* out, int n_blocks,
                          int row_block, int ec, int dim,
                          cudaStream_t stream) {
  if (row_block > kMaxRows || dim < 1 || dim > 256 ||
      (ec != 4 && ec != 8 && ec != 16))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const int4* s = reinterpret_cast<const int4*>(sched);
  const dim3 block(32, row_block);
  const FixedWeights fw{w};
  switch ((dim + 31) / 32) {
    case 1: spmm_arena_kernel<1><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
    case 2: spmm_arena_kernel<2><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
    case 3: spmm_arena_kernel<3><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
    case 4: spmm_arena_kernel<4><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
    case 5: spmm_arena_kernel<5><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
    case 6: spmm_arena_kernel<6><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
    case 7: spmm_arena_kernel<7><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
    default: spmm_arena_kernel<8><<<n_blocks, block, 0, stream>>>(s, nbr, fw, x, out, ec, dim); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
