// The staged RK3 step for B packed envs: one C entry per TPU kernel, plus
// the mass-flow correction that follows the third substage.
//
// Replaces: pde_policylearning_tpu/envs/rk3_pallas.py:_substage_kernel
// ("kernel A", entry pde_rk3_substage) and :_solve_correct_kernel ("kernel
// B", entry pde_rk3_solve_correct).  The mass-flow correction
// (pde_rk3_massflow) is XLA glue in the JAX step (rk3_pallas.rk3_step_k);
// here it is the float64 fixed-order reduction kernel D uses.
//
// Kernel A computes what _substage_kernel computes: the momentum RHS of the
// current stage's fields, the RK update from the step's initial fields with
// (c_cur, c_prev) on (current, first-stage) RHS, the no-slip/actuation BCs,
// and the cell divergence of the result; on stage 1 it also writes the RHS
// (F1).  All of it is one launch on whole x-z planes in shared memory
// (common.cuh, "Kernel A on whole x-z planes"): a block brings the rows it
// owns and one row each side by bulk copies, reads every stencil neighbour
// from shared memory, keeps its rows of the new fields there and writes
// their divergence itself.  Bound: bytes by the count of what it must move
// (~2 x 1.6 MB of state per env), instructions as built (~25 correctly
// rounded quotients per point).  A plane that does not fit shared memory
// keeps the point-by-point pass and the divergence as a second launch.
//
// Kernel B computes what _solve_correct_kernel computes: the bordered
// eigen-solve of the divergence (forward x/z transform, m = n-1 eigenbasis
// with the Schur last row, the (0,0) mode through Pinv00_eq, refine_steps
// refinement passes, synthesis), the pressure-gradient correction and the
// BCs.  Bound: operations, the 4 x 0.035 GFLOP of eigen-basis products per
// env and substage (fp32 FMA; no TF32, no tensor cores), all in one launch
// per solve (common.cuh, "The eigen-solve, one launch per solve": the
// warp-owned kernel with the eigenbasis resident in shared memory at B = 1,
// the row-owned kernel from B = 2 on at 32x130x32); the two transforms are
// FFTs in shared memory on a power-of-two grid (7 MFLOP) and dense DFT
// products (2 x 0.29 GFLOP) on any other (common.cuh, "x/z transforms").
//
// On the TPU each kernel was one VMEM-resident program per env; an env's
// state (~1.6 MB) exceeds an SM's shared memory, so here each is a short
// fixed sequence of launches on the caller's stream with the fields in
// device memory (L2-resident at small B).  Nothing allocates or
// synchronizes; scratch comes from the caller's Work.
#include "common.cuh"

extern "C" int pde_rk3_substage(const Dims* d, const Ops* o, const Work* w,
                                const float* U, const float* V,
                                const float* W, const float* U0,
                                const float* V0, const float* W0,
                                const float* F1u, const float* F1v,
                                const float* F1w, const float* op1,
                                const float* op2, const float* dPdx, float a,
                                float bp, int out_f, float* Un, float* Vn,
                                float* Wn, float* div, float* Fu, float* Fv,
                                float* Fw, void* stream) {
  (void)w;
  return substage(static_cast<cudaStream_t>(stream), *d, *o, U, V, W, U0, V0,
                  W0, F1u, F1v, F1w, op1, op2, dPdx, a, bp, out_f != 0, Fu,
                  Fv, Fw, Un, Vn, Wn, div);
}

extern "C" int pde_rk3_solve_correct(const Dims* d, const Ops* o,
                                     const Work* w, const float* div,
                                     const float* Un, const float* Vn,
                                     const float* Wn, const float* op1,
                                     const float* op2, float* Uo, float* Vo,
                                     float* Wo, void* stream) {
  return solve_correct(static_cast<cudaStream_t>(stream), *d, *o, *w, div, Un,
                       Vn, Wn, op1, op2, Uo, Vo, Wo);
}

extern "C" int pde_rk3_massflow(const Dims* d, const Ops* o, const Work* w,
                                float* U, const float* meanU0,
                                const float* dPdx, float* dPdx_out,
                                void* stream) {
  return mass_flow(static_cast<cudaStream_t>(stream), *d, *o, *w, U, meanU0,
                   dPdx, dPdx_out);
}
