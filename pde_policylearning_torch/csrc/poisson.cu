// Full-field channel Poisson solve (d_yy + kxx + kzz) p = rhs on one field
// in the (y, x*z) layout.
//
// Replaces: pde_policylearning_tpu/envs/poisson_pallas.py:_kernel.
//
// Computes what that kernel computes: the forward Kronecker DFT
// Y . [TR | TI], the full n = Ny-1 eigen-solve A [(B r) / (lam + kk)], the
// regularized and equilibrated (0,0) mode through Pinv00_eq (re and im
// columns), refine_steps refinement passes with the tridiagonal operator,
// and the inverse synthesis P . [TiR ; -TiI] with the conjugate-pair
// doubling and 1/(Nx*Nz) folded into Ti2.
//
// Bound: at 32x130x32 the two transform products are 2 * 2*129*1024*1088
// = 0.57 GFLOP and the eigen products 4 * 2*129*129*1088 = 0.14 GFLOP (one
// refinement pass doubles the latter): fp32 FMA throughput, since the
// operands (T2/Ti2 4.5 MB each) sit in the 50 MB L2.  The TPU kept the
// whole chain in one VMEM-resident program; here each stage is one launch
// of the shared tiled GEMM or of a small elementwise kernel, all on the
// caller's stream, with the spectra in device memory and L2.  The solve
// runs twice per env construction (re-projection and cal_pressure), off
// the per-step path.
#include "common.cuh"

extern "C" int pde_poisson_solve(const Dims* d, const Ops* o, const Work* w,
                                 const float* Y, float* out, void* stream) {
  return spectral_solve(static_cast<cudaStream_t>(stream), *d, *o, *w, Y, out,
                        /*bordered=*/false);
}

extern "C" const char* pde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
