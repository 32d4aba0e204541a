// Full-field channel Poisson solve (d_yy + kxx + kzz) p = rhs on one field
// in the (y, x*z) layout.
//
// Replaces: pde_policylearning_tpu/envs/poisson_pallas.py:_kernel.
//
// Computes what that kernel computes: the forward x/z transform of every
// row (what Y . [TR | TI] gives), the full n = Ny-1 eigen-solve
// A [(B r) / (lam + kk)], the regularized and equilibrated (0,0) mode
// through Pinv00_eq (re and im columns), refine_steps refinement passes
// with the tridiagonal operator, and the real-part inverse synthesis (what
// P . [TiR ; -TiI] gives, the conjugate-pair doubling and 1/(Nx*Nz) in it).
//
// Bound: operations, 0.15 GFLOP at 32x130x32: the eigen products
// 4 * 2*129*129*1088 = 0.14 GFLOP with one refinement pass, and 7 MFLOP of
// transforms as FFTs; 2.3 us of fp32 FMA.  As dense Kronecker-DFT products
// (the TPU's choice, kept for grids that are no power of two) the two
// transforms alone were 0.57 GFLOP.  On a power-of-two grid each plane is
// one block's FFT in shared memory (common.cuh, "x/z transforms").  The
// TPU kept the whole chain in one VMEM-resident program; here it is three
// launches on the caller's stream (FFT, the column-tiled eigen-solve with
// its refinement passes, inverse FFT), with the spectra in device memory
// and L2.  The
// solve runs twice per env construction (re-projection and cal_pressure),
// off the per-step path.
#include "common.cuh"

extern "C" int pde_poisson_solve(const Dims* d, const Ops* o, const Work* w,
                                 const float* Y, float* out, void* stream) {
  return spectral_solve(static_cast<cudaStream_t>(stream), *d, *o, *w, Y, out,
                        /*bordered=*/false);
}

extern "C" const char* pde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
