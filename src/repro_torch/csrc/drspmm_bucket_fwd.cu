// Per-degree-bucket DR-SpMM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_fwd_bucket (src/repro/kernels/drspmm.py),
// the executor of ops.drspmm's per-bucket loop (backend "bucket"): one
// launch per degree bucket of a relation, straight over the bucket's ELL
// slab (nbr, w), both (R, E):
//
//   Y[r, x_idx[nbr[r,e], t]] += w[r,e] * x_vals[nbr[r,e], t]    Y: (R, dim)
//
// Rows are bucket-local; the caller adds them into the relation's output at
// the bucket's row ids (index_add_, since the padding rows repeat row 0).
//
// Bound on the H100: memory by bytes (each real slot gathers one CBSR row
// of the operand, k values + k indices, 8k bytes, mostly L2 hits; each
// output row is written once), but the time is set by how fast warps walk
// slots.  One warp's slots follow each other at a near-fixed rate (~0.2 us
// a slot at k 16: the batch's loads, then each slot's owner-table scatter),
// so a row walked by one warp costs its slots over that rate: the widest
// buckets (256-260 slots a row) took ~0.053 ms however few rows they had.
// What the design does about it:
//  * a slab row is split over P warps, each adding one contiguous run of
//    ceil(E / P) slots.  P comes from the slab's width alone (parts_of):
//    1 up to 32 slots, kParts64 up to 64, then one warp per kWarpSlots
//    slots up to kMaxParts.  Every P computes the same function and reads
//    every slot (and its x_idx) once;
//  * each warp has its own owner table in shared memory; after the walk it
//    holds the warp's partial row.  After the block's one barrier the P
//    partial rows are added in the fixed order p = 0..P-1, column c by the
//    part that owns it, so every output element has one writer: fp32, no
//    atomics, deterministic from run to run.  At P = 1 the row is the
//    warp's own sum, as before the split;
//  * a warp reads its run 32 slots at a time (lane l: slot e0 + l), and the
//    next window's neighbours and weights are loaded while this one is
//    added, so the index load is off the gather chain;
//  * for k <= 32 the CBSR loads of kInFlight slots are issued together
//    (lane t holds pair t of each), then each slot's k pairs go into the
//    lane-owned columns by the owner-table permutation of cbsr_densify.cuh
//    (a broadcast fallback keeps repeated columns exact); rows wider than
//    32 pairs scatter slot by slot, 32 pairs at a time;
//  * padding slots (weight 0) issue no load; a window of 32 slots, or a
//    batch, that is all padding is skipped warp-uniformly, and a run goes
//    on past a padding window (real slots need not come first).
// Once the rows are split, a bucket with thousands of rows (1696 x 256,
// 5440 x 64 on Table-1 partition 0) is held by the card's rate of scatters
// (~0.025 ms for its 163k-201k real slots at k 16, whatever P or the
// rows a block), not by one row: there registers, which set the warps an
// SM holds, are what moves the time.
//
// Shape, chosen by the sweep of tools/bucket_fwd_probe.py on the H100 at the
// main path's shape (partition 0's near buckets, k 16, dim 64; profiler
// device time):
//  * kWarpSlots 32, kMaxParts 8: the 256-260-slot rows walk 32-33 slots a
//    warp (16-slot parts cut 40 x 260 by a third but cost the bigger
//    buckets more; 64-slot parts doubled the chain);
//  * kParts64 2: the 64-slot bucket (5,440 rows) at two warps a row beat
//    one (its longest rows' chain halves) and matched four;
//  * kBlockWarps 8, kMinBlocks 5: 256-thread blocks, 5 an SM, which caps
//    the walk at 48 registers (40 warps an SM); left free, ptxas took
//    64-96 and the big buckets slowed by a fifth or more;
//  * kInFlight 4: with 8 slots' loads in flight the 48-register walk
//    spilled more and every bucket was slower.
#include <cuda_runtime.h>

#include "cbsr_densify.cuh"

namespace {

constexpr int kBlockWarps = 8;   // warps a block
constexpr int kWarpSlots = 32;   // past 64 slots, one warp per kWarpSlots ...
constexpr int kMaxParts = 8;     // ... up to kMaxParts warps a row
constexpr int kParts64 = 2;      // warps a row for 32 < E <= 64
constexpr int kMinBlocks = 5;    // blocks an SM must hold (caps registers)
constexpr int kInFlight = 4;     // slots whose CBSR loads are issued together
constexpr int kMaxGroups = 8;    // groups of 32 pairs per CBSR row (k <= 256)
static_assert(kMaxParts <= kBlockWarps && kParts64 <= kBlockWarps,
              "a block holds at least one whole row");

// Warps a slab row of e_width slots is split over.
int parts_of(int e_width) {
  if (e_width <= 32) return 1;
  if (e_width <= 64) return kParts64;
  const int p = (e_width + kWarpSlots - 1) / kWarpSlots;
  return p < kMaxParts ? p : kMaxParts;
}

// Adds slots [e_lo, e_hi) of one slab row (nr, wr) into the lane-owned
// columns acc.  Every lane of the warp must call it.
template <int DPL>
__device__ __forceinline__ void walk_run(
    const int* __restrict__ nr, const float* __restrict__ wr,
    const float* __restrict__ xv, const int* __restrict__ xi,
    float (&acc)[DPL], int* owner, int e_lo, int e_hi, int k, int dim,
    int lane) {
  // lane l holds slot e0 + l of the current window
  int n_cur = 0;
  float w_cur = 0.f;
  if (e_lo + lane < e_hi) {
    n_cur = nr[e_lo + lane];
    w_cur = wr[e_lo + lane];
  }
  for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
    // in flight while this window is added: the next window's slots
    int n_nxt = 0;
    float w_nxt = 0.f;
    if (e0 + 32 + lane < e_hi) {
      n_nxt = nr[e0 + 32 + lane];
      w_nxt = wr[e0 + 32 + lane];
    }
    // lanes past the run's end hold weight 0 and load nothing
    if (__any_sync(kFullMask, w_cur != 0.f)) {
      const int ne = min(32, e_hi - e0);
      if (k > 32) {  // wide CBSR rows: slot by slot, 32 pairs at a time
        for (int s = 0; s < ne; ++s) {
          const float wt = __shfl_sync(kFullMask, w_cur, s);
          const int src = __shfl_sync(kFullMask, n_cur, s);
          if (wt == 0.f) continue;  // warp-uniform
          float pv[kMaxGroups];
          int pc[kMaxGroups];
#pragma unroll
          for (int g = 0; g < kMaxGroups; ++g) {
            const int t = 32 * g + lane;
            pv[g] = 0.f;
            pc[g] = 0;
            if (t < k) {
              pv[g] = wt * xv[(long long)src * k + t];
              pc[g] = xi[(long long)src * k + t];
            }
          }
#pragma unroll
          for (int g = 0; g < kMaxGroups; ++g)
            if (32 * g < k)  // warp-uniform
              scatter_row_pairs<DPL>(acc, owner, pv[g], pc[g], dim, lane);
        }
      } else {
        // s0 + i < 32
        for (int s0 = 0; s0 < ne; s0 += kInFlight) {
          if (!__any_sync(kFullMask,
                          w_cur != 0.f &&
                              (unsigned)(lane - s0) < (unsigned)kInFlight))
            continue;  // a batch of padding
          float pv[kInFlight];
          int pc[kInFlight];
#pragma unroll
          for (int i = 0; i < kInFlight; ++i) {
            const float wt = __shfl_sync(kFullMask, w_cur, s0 + i);
            const int src = __shfl_sync(kFullMask, n_cur, s0 + i);
            pv[i] = 0.f;
            pc[i] = 0;
            if (wt != 0.f && lane < k) {
              pv[i] = wt * xv[(long long)src * k + lane];
              pc[i] = xi[(long long)src * k + lane];
            }
          }
#pragma unroll
          for (int i = 0; i < kInFlight; ++i)
            scatter_row_pairs<DPL>(acc, owner, pv[i], pc[i], dim, lane);
        }
      }
    }
    n_cur = n_nxt;
    w_cur = w_nxt;
  }
}

// Warp y of the block adds part y % P of the block's row y / P.
template <int DPL>
__global__ void __launch_bounds__(32 * kBlockWarps, kMinBlocks)
    bucket_fwd_kernel(const int* __restrict__ nbr,
                      const float* __restrict__ w,
                      const float* __restrict__ xv,
                      const int* __restrict__ xi, float* __restrict__ out,
                      int n_rows, int e_width, int k, int dim, int parts) {
  // one owner table a warp; after the walk, the warp's partial row
  __shared__ int tab[kBlockWarps][32 * DPL];
  const int lane = threadIdx.x;
  const int p = threadIdx.y % parts;
  const long long row =
      (long long)blockIdx.x * (blockDim.y / parts) + threadIdx.y / parts;
  const bool live = row < n_rows;  // warp-uniform
  int* owner = tab[threadIdx.y];
#pragma unroll
  for (int j = 0; j < DPL; ++j) owner[lane + 32 * j] = -1;
  __syncwarp();
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  if (live) {
    const int run = (e_width + parts - 1) / parts;
    const int e_lo = min(e_width, p * run);
    const int e_hi = min(e_width, e_lo + run);
    walk_run<DPL>(nbr + row * e_width, w + row * e_width, xv, xi, acc, owner,
                  e_lo, e_hi, k, dim, lane);
  }
  // the walk leaves the table at -1; park the partial row there
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DPL; ++j) owner[lane + 32 * j] = __float_as_int(acc[j]);
  __syncthreads();  // every warp of the block reaches it
  if (!live) return;
  // the row's parts sit in tab[y - p .. y - p + P); part p writes columns
  // 32p + lane, 32(p + P) + lane, ..., each the sum over q = 0..P-1
  const int(*part)[32 * DPL] = tab + (threadIdx.y - p);
  float* o = out + row * dim;
  for (int c = 32 * p + lane; c < dim; c += 32 * parts) {
    float s = __int_as_float(part[0][c]);
    for (int q = 1; q < parts; ++q) s += __int_as_float(part[q][c]);
    o[c] = s;
  }
}

template <int DPL>
void launch(const int* nbr, const float* w, const float* xv, const int* xi,
            float* out, int n_rows, int e_width, int k, int dim,
            cudaStream_t stream) {
  const int parts = parts_of(e_width);
  const int rows = kBlockWarps / parts;
  const int grid = (n_rows + rows - 1) / rows;
  bucket_fwd_kernel<DPL><<<grid, dim3(32, rows * parts), 0, stream>>>(
      nbr, w, xv, xi, out, n_rows, e_width, k, dim, parts);
}

}  // namespace

// Y (n_rows, dim) of one bucket slab; any e_width >= 1, 1 <= k <= 256,
// 1 <= dim <= 256.  Returns a CUDA error code (cudaGetLastError right after
// the launch).
extern "C" int drspmm_bucket_fwd(const int* nbr, const float* w,
                                 const float* xv, const int* xi, float* out,
                                 int n_rows, int e_width, int k, int dim,
                                 cudaStream_t stream) {
  if (e_width < 1 || k < 1 || k > 32 * kMaxGroups) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  switch ((dim + 31) / 32) {
    case 1: launch<1>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 2: launch<2>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 3: launch<3>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 4: launch<4>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 5: launch<5>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 6: launch<6>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 7: launch<7>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 8: launch<8>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
