// Wall pressures (p1, p2) of B packed envs: one C entry, two phases.
//
// Replaces: pde_policylearning_tpu/envs/rk3_pallas.py:_boundary_fwd_kernel
// (phase 1) and :_boundary_solve_kernel (phase 2).
//
// Phase 1 (phases & 1): the pressure RHS of the state (momentum RHS, then
// its cell divergence) and the forward x/z transform -> t (B, n, 2F).
// Phase 2 (phases & 2): the bordered eigen-solve restricted to the rows
// [0, 1, n-2, n-1] (B1 . t / denom1, then the 3 block rows A13 and the
// Schur last row), the (0,0) mode through Pinv00_eq with its imaginary
// column zeroed, and the inverse synthesis -> p (2, B*C) =
// (-(P0 + P1)/2 ; -(P3 + P2)/2).  The two wall combinations are formed
// before the synthesis (the synthesis is linear), so it transforms 2 rows.
//
// Bound: phase 1 bytes (the state read, the spectrum written: 2.2 MB per
// env, 0.65 us), phase 2 operations (B1 . t, 2*128*128*1088 = 36 MFLOP per
// env).  With the transforms as dense DFT products (the TPU's choice, kept
// for grids that are no power of two) the forward transform alone was
// 0.29 GFLOP per env; on a power-of-two grid it is one block's FFT per
// plane (common.cuh, "x/z transforms").  The state and its RHS fields
// (~1.6 MB per env each) stay in L2 between the launches.
#include "common.cuh"

extern "C" int pde_boundary_pressures(const Dims* d, const Ops* o,
                                      const Work* w, int phases,
                                      const float* U, const float* V,
                                      const float* W, const float* dPdx,
                                      float* t, float* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phases & 1) PDE_TRY(boundary_fwd(s, *d, *o, *w, U, V, W, dPdx, t));
  if (phases & 2) PDE_TRY(boundary_solve(s, *d, *o, *w, t, p));
  return cudaSuccess;
}
