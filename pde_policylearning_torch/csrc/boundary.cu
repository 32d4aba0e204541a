// Wall pressures (p1, p2) of B packed envs: one C entry, two phases.
//
// Replaces: pde_policylearning_tpu/envs/rk3_pallas.py:_boundary_fwd_kernel
// (phase 1) and :_boundary_solve_kernel (phase 2).
//
// Phase 1 (phases & 1): the pressure RHS of the state (momentum RHS, then
// its cell divergence) and the forward x/z transform -> t (B, n, 2F).  On
// the FFT route one launch of a plane pass in shared memory that runs kernel
// A's stencils and hands each divergence plane to the transform's routine
// (common.cuh, "Phase 1 of the wall pressures"); on any other grid the RHS
// fields, their divergence and the DFT product, three launches.
// Phase 2 (phases & 2): rows [0, 1, n-2, n-1] of the bordered eigen-solve
// (the 3 block rows through the operator G = A13 diag(1/denom1) B1 that the
// host folds in float64, and the Schur last row), the (0,0) mode through
// four rows of Pinv00_eq with its imaginary column zeroed, and the inverse
// synthesis -> p (2, B*C) = (-(P0 + P1)/2 ; -(P3 + P2)/2).  The two wall
// combinations are formed before the synthesis (the synthesis is linear),
// so it transforms 2 rows.  Two launches (common.cuh, "Phase 2 of the wall
// pressures").
//
// Bound: phase 1 bytes (the state read, the spectrum written: 2.2 MB per
// env, 0.65 us at 32x130x32), as built instructions (~175 operations and
// ~25 correctly rounded quotients a point, as kernel A); phase 2 bytes (t
// and G: 2.2 MB at B = 1, 0.84 MFLOP per env where the two products
// through the eigenbasis took 36.5).
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
