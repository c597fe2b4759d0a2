// Learnable-edge DR-SpMM sampled backward (dL/dx_vals) for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_bwd_learnable_fused
// (src/repro/kernels/drspmm.py): the transposed edge-id arena's sampled
// backward with its weights gathered from the canonical vector,
//
//   dV[j, t] = sum over the block's chunks c, slots e of
//              w_canon[teid[c,r,e]] * gY[nbr[c,r,e], xi[rows[j], t]]
//
// with teid -1 (padding) weighing 0 and rows the arena's own row map, so
// each arena row reads its CBSR indices straight from x_idx (no arena-
// ordered copy of xi).  It is kernel drspmm_arena_bwd.cu with the weight
// gathered in the kernel (CanonWeights, arena_weights.cuh): the row walk,
// its bound and its design are in arena_bwd_walk.cuh.  The homogeneous GAT
// baselines call it with k = dim = 64, which takes the walk's wide variant;
// ``sched`` (drspmm.py, _arena_sched) orders the narrow walk's row-blocks.
#include "arena_bwd_walk.cuh"

extern "C" int drspmm_learnable_bwd(const int* sched,
                                    const int* nbr, const int* eid,
                                    const float* w_canon, const int* rows,
                                    const float* gy, const int* xi,
                                    float* out, int n_blocks, int row_block,
                                    int ec, int k, int dim,
                                    cudaStream_t stream) {
  return arena_bwd_dispatch(sched, nbr, CanonWeights{eid, w_canon},
                            rows, gy, xi, out, n_blocks, row_block, ec, k,
                            dim, stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
