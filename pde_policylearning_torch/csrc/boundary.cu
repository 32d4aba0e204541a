// Wall pressures (p1, p2) of B packed envs: one C entry, two phases.
//
// Replaces: pde_policylearning_tpu/envs/rk3_pallas.py:_boundary_fwd_kernel
// (phase 1) and :_boundary_solve_kernel (phase 2).
//
// Phase 1 (phases & 1): the pressure RHS of the state (momentum RHS, then
// its cell divergence) and the forward Kronecker DFT -> t (B, n, 2F).
// Phase 2 (phases & 2): the bordered eigen-solve restricted to the rows
// [0, 1, n-2, n-1] (B1 . t / denom1, then the 3 block rows A13 and the
// Schur last row), the (0,0) mode through Pinv00_eq with its imaginary
// column zeroed, and the synthesis with Ti2 -> p (2, B*C) =
// (-(P0 + P1)/2 ; -(P3 + P2)/2).  The two wall combinations are formed
// before the synthesis (the synthesis is linear), so it is a 2-row product.
//
// Bound: the forward transform (2*129*1024*1088 = 0.29 GFLOP per env) in
// fp32 FMA; the rest is small.  The state and its RHS fields (~1.6 MB per
// env each) stay in L2 between the launches.
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
