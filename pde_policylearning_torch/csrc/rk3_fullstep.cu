// One closed-loop env step for B packed envs ("kernel D").
//
// Replaces: pde_policylearning_tpu/envs/rk3_pallas.py:_rk3_full_kernel.
//
// Computes what that kernel computes, per env: three RK3 substages, each
// the momentum RHS, the RK update (coefficients (8/15, 0), (5/12, 1/4),
// (3/4, 1/4) on (current, first-stage) RHS), the no-slip/actuation BCs, the
// cell divergence and the projection (forward x/z transform, the bordered
// 128-row eigen-solve with the Schur last row and the guards, refine_steps
// refinement passes, synthesis, pressure-gradient correction, BCs); then
// the mass-flow correction in the fixed trapezoid term order, the new
// dPdx, and the wall pressures of the new state.
//
// Bound: operations.  At 32x130x32 the function needs 0.596 GFLOP per env
// step: 0.46 GFLOP of eigen-basis products (per substage four products of
// 2 * 128 * 128 * 1088, plus the wall rows), 0.1 GFLOP of stencils, and only
// 0.02 GFLOP of x/z transforms when these are FFTs (2.5 N log2 N per 32x32
// plane, seven 129-plane transforms and one of 2 planes); 8.9 us at the
// card's 67 TFLOP/s of fp32 FMA, against 9 MB of state, RHS and constants
// read or written (2.7 us).  The TPU ran the transforms as dense
// Kronecker-DFT products on its idle matrix unit; carried over, they were
// 2.0 of 2.59 GFLOP per step and three quarters of the GEMM's time.  Here
// they are FFTs in shared memory, one block per plane (common.cuh, "x/z
// transforms"), so the kernel does 0.60 GFLOP as built.  The eigen-basis
// products stay fp32 FMA (no TF32: the solve NaNs the DNS at reduced
// precision); everything between the two transforms of a solve is local
// to a spectrum column, so one launch per solve runs both products, the
// Schur finish, the (0,0) mode, the residual and the refinement pass out
// of shared memory (common.cuh, "The eigen-solve, one launch per solve"):
// no split-K, no partial sums in device memory.  A grid that is no power
// of two keeps the DFT products.
//
// One env's U, V, W take ~1.6 MB, more than an SM's 227 KB of shared
// memory, so the TPU plan of one VMEM-resident program per env has no
// single-block equivalent: this entry enqueues 20 launches per step on a
// power-of-two grid (per substage the stencil pass, the transform, the
// eigen-solve, the synthesis and the correction; two for the mass flow;
// three for the wall pressures) with the state, the RHS fields and the
// spectra in device memory, resident in the 50 MB L2 at B = 1.  What is left above
// the bound is launch latency at B = 1 and the eigen products' rate at
// large B (a persistent step and CUDA graphs are later work).
//
// The three substages are kernel A and kernel B of the staged step
// (`substage` and `solve_correct` of common.cuh, the launches of
// rk3_staged.cu), and the mass-flow correction is the staged step's too, in
// float64 in one fixed order (common.cuh `mass_flow`).
#include "common.cuh"

namespace {

constexpr float kStages[3][2] = {
    {8.f / 15.f, 0.f}, {5.f / 12.f, 1.f / 4.f}, {3.f / 4.f, 1.f / 4.f}};

}  // namespace

extern "C" int pde_rk3_fullstep(const Dims* dp, const Ops* op, const Work* wp,
                                const float* U, const float* V,
                                const float* W, const float* op1,
                                const float* op2, const float* dPdx,
                                const float* meanU0, float* Uo, float* Vo,
                                float* Wo, float* dPdx_out, float* p,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims& d = *dp;
  const Ops& o = *op;
  const Work& w = *wp;
  for (int st = 0; st < 3; ++st) {
    const float *Uc = st ? Uo : U, *Vc = st ? Vo : V, *Wc = st ? Wo : W;
    // the first stage's RHS is kept (F1) for the later stages
    const float c_cur = kStages[st][0], c_prev = kStages[st][1];
    PDE_TRY(substage(s, d, o, Uc, Vc, Wc, U, V, W, w.F1u, w.F1v, w.F1w, op1,
                     op2, dPdx, d.dt * c_cur, d.dt * c_prev, st == 0, w.F1u,
                     w.F1v, w.F1w, w.Un, w.Vn, w.Wn, w.Y));
    PDE_TRY(solve_correct(s, d, o, w, w.Y, w.Un, w.Vn, w.Wn, op1, op2, Uo, Vo,
                          Wo));
  }
  PDE_TRY(mass_flow(s, d, o, w, Uo, meanU0, dPdx, dPdx_out));
  PDE_TRY(boundary_fwd(s, d, o, w, Uo, Vo, Wo, dPdx_out, w.t));
  return boundary_solve(s, d, o, w, w.t, p);
}
