// DR-SpMM arena sampled backward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_bwd_fused (src/repro/kernels/drspmm.py),
// entered through drspmm_bwd_multi for a relation plan's transposed
// super-arena (Alg. 2, SSpMM):
//
//   dV[j, t] = sum over the block's chunks c, slots e of
//              w[c,r,e] * gY[nbr[c,r,e], xi[src_rows[j], t]]     j = blk*BR + r
//
// with src_rows the plan's bwd_src_rows (arena row -> type-concat xi row).
// The row walk, its bound on the H100 and what its design does about it
// are in arena_bwd_walk.cuh; here the weights are the arena's own table.
// ``sched`` is the arena's launch order (drspmm.py, _arena_sched).
#include "arena_bwd_walk.cuh"

extern "C" int drspmm_arena_bwd(const int* sched,
                                const int* nbr, const float* w,
                                const int* src_rows, const float* gy,
                                const int* xi, float* out, int n_blocks,
                                int row_block, int ec, int k, int dim,
                                cudaStream_t stream) {
  return arena_bwd_dispatch(sched, nbr, FixedWeights{w}, src_rows,
                            gy, xi, out, n_blocks, row_block, ec, k, dim,
                            stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
