// The x/z transforms of the channel-flow solves on their own: the forward
// transform of the rows of a packed field into per-env spectra, and the
// real-part inverse synthesis back (common.cuh, "x/z transforms").
//
// Replaces: the `Y . [TR | TI]` and `P . [TiR ; -TiI]` products inside
// pde_policylearning_tpu/envs/poisson_pallas.py:_kernel and the kernels of
// envs/rk3_pallas.py, which ran the transforms as dense Kronecker-DFT
// products because the TPU's matrix unit was idle and its FFT slow.
//
// Bound: bytes, one plane (Nx Nz floats) read and one spectrum
// (2 Nx (Nz/2+1) floats) written per (row, env).  On this card the dense
// products were three quarters of the solves' operations; on a power-of-two
// grid each plane is now one block's FFT in shared memory, and any other
// grid keeps the products through the hand-written GEMM.  These entries
// exist so that the transforms can be held against the products and against
// float64 alone; the solves call the same routines.
#include "common.cuh"

// Y (rows, B*C) -> t (B, rows, F2).
extern "C" int pde_xz_forward(const Dims* d, const Ops* o, const Work* w,
                              const float* Y, int rows, float* t,
                              void* stream) {
  return xz_forward(static_cast<cudaStream_t>(stream), *d, *o, *w, Y, rows,
                    t);
}

// P (B, rows, F2) -> out (rows, B*C).
extern "C" int pde_xz_inverse(const Dims* d, const Ops* o, const Work* w,
                              const float* P, int rows, float* out,
                              void* stream) {
  return xz_inverse(static_cast<cudaStream_t>(stream), *d, *o, *w, P, rows,
                    out);
}
