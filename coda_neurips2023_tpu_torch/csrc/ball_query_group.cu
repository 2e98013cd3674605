// Kernel F: fused ball query and coordinate gather, on kernel B's cell grid.
// (B, N, 3) points x (B, M, 3) centres -> idx (B, M, k) int32 and
// grouped (B, M, k, 3) f32, grouped[b, m, s] = xyz[b, idx[b, m, s]].
//
// Replaces coda_neurips2023_tpu/ops/pallas_ball_query_sorted.py ::
// ball_query_and_group_sorted.  Semantics are kernel B's followed by kernel
// C's: the first k point indices, in index order, with squared distance
// < r^2; trailing slots repeat the first hit and its coordinates; a row with
// no hit is index 0 with the coordinates of point 0.
//
// The grid and its build are kernel B's (ball_query.cu, launched by the
// wrapper before this query), and so is the query (ball_query_grid.cuh):
// the same candidates, the same distance, the same selection of the k
// smallest original indices, so the indices are bit-equal to B's.  Its
// epilogue writes each slot's coordinates beside the index, copied from the
// scene at that index (an L2 read of 12 bytes), so they are bit-equal to
// kernel C's gather.

#include "ball_query_grid.cuh"

extern "C" int coda_ball_query_group(const float* pts, const int32_t* starts,
                                     const float* fparams, const int32_t* iparams,
                                     const float* centres, const float* xyz, int32_t* idx,
                                     float* grouped, int b, int n, int m, int k, int stride,
                                     float r2, float rw, cudaStream_t stream) {
  return bq_grid::launch_query<true>(pts, starts, fparams, iparams, centres, xyz, idx, grouped,
                                     b, n, m, k, stride, r2, rw, stream);
}
