// One closed-loop env step for B packed envs ("kernel D").
//
// Replaces: pde_policylearning_tpu/envs/rk3_pallas.py:_rk3_full_kernel.
//
// Computes what that kernel computes, per env: three RK3 substages, each
// the momentum RHS, the RK update (coefficients (8/15, 0), (5/12, 1/4),
// (3/4, 1/4) on (current, first-stage) RHS), the no-slip/actuation BCs, the
// cell divergence and the projection (Kronecker DFT, the bordered 128-row
// eigen-solve with the Schur last row and the guards, refine_steps
// refinement passes, synthesis, pressure-gradient correction, BCs); then
// the mass-flow correction in the fixed trapezoid term order, the new
// dPdx, and the wall pressures of the new state.
//
// Bound: about 2.6 GFLOP per env step, nearly all in the solve products
// (per substage 2 * 0.29 GFLOP of transforms and 4 * 0.035 GFLOP of
// eigen-basis products, plus the wall-pressure transform), run as fp32 FMA
// in the shared tiled GEMM; the stencils are memory-bound and small.  One
// env's U, V, W take ~1.6 MB, more than an SM's 227 KB of shared memory, so
// the TPU plan of one VMEM-resident program per env has no single-block
// equivalent: this entry enqueues ~55 launches per step with the state,
// the RHS fields and the spectra in device memory, resident in the 50 MB
// L2 at B = 1.  Persistent, cluster and CUDA-graph designs are later work.
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
