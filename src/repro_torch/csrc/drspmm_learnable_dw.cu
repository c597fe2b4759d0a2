// Learnable-edge DR-SpMM weight gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_dw_learnable_fused
// (src/repro/kernels/drspmm.py) and the scatter to canonical order that
// follows it (_dw_contrib_to_canon, src/repro/kernels/ops.py):
//
//   gw[eid[c,r,e]] = sum_t gY[rows[block_of[c]*BR + r], xi[nbr, t]]
//                    * x_vals[nbr, t]
//
// for every real slot (eid >= 0) of the forward edge-id arena: the same
// sampled gather as the dx backward with the roles of weight and value
// swapped.  Each canonical edge id occupies exactly one slot of the arena
// (checked at pack time), so the reduction to canonical order is a
// permutation: the kernel writes gw[eid] directly, once per id, with no
// atomics, and the result is deterministic.
//
// Bound on the H100: memory.  Each real slot reads one CBSR row of its
// source (k values + k indices, 8k bytes, mostly L2 hits: the operand is a
// few MB) and samples k floats of its destination's gY row; it writes one
// float.  Unlike the forward, no slot's result depends on another's, so
// nothing has to be walked in order: a row-block's chunk run is not a
// chain here.  What the design does about it:
//  * the grid covers the slots flat, as the TPU kernel's grid covers its
//    chunks: a work list built once per arena (kernels/drspmm.py::
//    _dw_sched: id, source, destination row, one 16-byte load a slot)
//    names each slot, so no warp walks a chunk run and a long run costs
//    no more than as many short ones; padding slots sit at its end;
//  * the list runs in destination order, so the slots of one gY row are
//    neighbours and their samples L1 hits (in source order a warp
//    instruction would sample four rows and the L1 requests cost more
//    than the CBSR rows' L2 reads they save);
//  * a slot gets a group of L lanes (L = kDwLanes = 8 at k 64), each
//    taking V consecutive CBSR positions with 16-byte loads where V and k
//    are multiples of 4, so one warp instruction serves 32/L slots and a
//    slot's sum takes a log2(L)-step xor butterfly inside its group;
//  * a lane group loads its slot's CBSR row and samples before any add;
//    one slot a group and 8 blocks an SM (more warps in flight, not more
//    loads a warp) measured fastest;
//  * a slot's sum has a fixed order (its lane's positions in turn, then
//    the butterfly), so repeated calls give the same bits.
// Columns outside [0, dim) sample nothing (they contribute 0).
#include <cstdint>
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDwWarps = 8;        // warps a block
constexpr int kDwLanes = 8;        // lanes a slot at k 33..64
constexpr int kDwMinBlocks = 8;    // blocks an SM must hold (caps registers)

// The lane group of a slot at k <= K (K a power of two): V positions a lane
// (at most 8, so a slot's values stay in registers), L = K / V lanes.
template <int K>
struct Group {
  static constexpr int V0 = K / kDwLanes;
  static constexpr int V = V0 < 1 ? 1 : (V0 > 8 ? 8 : V0);
  static constexpr int L = K / V;
};

// L lanes a slot, V CBSR positions a lane (L * V >= k).
template <int L, int V>
__global__ void __launch_bounds__(32 * kDwWarps, kDwMinBlocks) dw_kernel(
    const int4* __restrict__ sched, const float* __restrict__ gy,
    const float* __restrict__ xv, const int* __restrict__ xi,
    float* __restrict__ gw, long long n, int k, int dim, bool vec) {
  constexpr int G = 32 / L;                  // slots a warp instruction
  const int lane = threadIdx.x & 31;
  const int t0 = (lane % L) * V;             // the lane's first position
  const long long warp =
      (long long)blockIdx.x * kDwWarps + (threadIdx.x >> 5);
  const long long s = warp * G + lane / L;   // the lane group's slot

  // the slot's canonical id, source and destination row
  const int4 e = s < n ? __ldg(sched + s) : make_int4(-1, 0, 0, 0);
  const int id = e.x;
  const long long grow = (long long)e.z * dim;   // its gY row offset
  float v[V];
  int col[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = 0.f;
    col[j] = -1;
  }
  if (id >= 0) {
    const long long o = (long long)e.y * k + t0;
    if (V % 4 == 0 && vec) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        if (t0 + 4 * q < k) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(xv + o) + q);
          const int4 b = __ldg(reinterpret_cast<const int4*>(xi + o) + q);
          v[4 * q] = a.x; v[4 * q + 1] = a.y;
          v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
          col[4 * q] = b.x; col[4 * q + 1] = b.y;
          col[4 * q + 2] = b.z; col[4 * q + 3] = b.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (t0 + j < k) {
          v[j] = __ldg(xv + o + j);
          col[j] = __ldg(xi + o + j);
        }
      }
    }
  }
  // every sample is loaded before any is added; a position past k or at
  // a column outside [0, dim) adds 0 * 0
  float g[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool in = (unsigned)col[j] < (unsigned)dim;
    g[j] = in ? __ldg(gy + grow + col[j]) : 0.f;
    v[j] = in ? v[j] : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) acc += v[j] * g[j];
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  if (lane % L == 0 && id >= 0) gw[id] = acc;
}

template <int K>
static void launch(const int4* sched, const float* gy, const float* xv,
                   const int* xi, float* gw, long long n, int k, int dim,
                   bool vec, cudaStream_t stream) {
  constexpr int L = Group<K>::L, V = Group<K>::V;
  static_assert(L >= 1 && L <= 32 && L * V == K, "lane group");
  constexpr long long per_block = (long long)kDwWarps * (32 / L);
  const long long blocks = (n + per_block - 1) / per_block;
  dw_kernel<L, V><<<(unsigned)blocks, 32 * kDwWarps, 0, stream>>>(
      sched, gy, xv, xi, gw, n, k, dim, vec);
}

// sched: n rows (canonical id, source, destination gY row, 0), int32, the
// slots in the order the wrapper chose (kernels/drspmm.py::_dw_sched);
// rows with id -1 are padding.
extern "C" int drspmm_learnable_dw(const int* sched, const float* gy,
                                   const float* xv, const int* xi, float* gw,
                                   int n, int k, int dim,
                                   cudaStream_t stream) {
  if (dim < 1 || dim > 256 || k < 1 || k > 256 || n < 0 ||
      ((uintptr_t)sched & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int4* s = reinterpret_cast<const int4*>(sched);
  const bool vec = k % 4 == 0 &&
                   (((uintptr_t)xv | (uintptr_t)xi) & 15) == 0;
  if (k <= 4) launch<4>(s, gy, xv, xi, gw, n, k, dim, vec, stream);
  else if (k <= 8) launch<8>(s, gy, xv, xi, gw, n, k, dim, vec, stream);
  else if (k <= 16) launch<16>(s, gy, xv, xi, gw, n, k, dim, vec, stream);
  else if (k <= 32) launch<32>(s, gy, xv, xi, gw, n, k, dim, vec, stream);
  else if (k <= 64) launch<64>(s, gy, xv, xi, gw, n, k, dim, vec, stream);
  else if (k <= 128) launch<128>(s, gy, xv, xi, gw, n, k, dim, vec, stream);
  else launch<256>(s, gy, xv, xi, gw, n, k, dim, vec, stream);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
