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
// The mass-flow update d_new = 2 (meanU0 - meanU_now) is a small difference
// amplified by 1/dt: one float32 ulp of the bulk velocity moves dPdx by
// several percent.  So the row means, the trapezoid and d_new are taken in
// float64 in one fixed order (row sums by warp, then the trapezoid summed in
// index order by one thread; no atomics, no split reduction), as the plain
// version does (rk3_cuda._mass_flow).
#include "common.cuh"

namespace {

// meanU_now of each env in float64 (one block per env, one warp per row),
// then d_new / 2 and the new dPdx.
__global__ void massflow_kernel(Grid g, const float* U, const float* meanU0,
                                const float* dPdx, const float* trapw,
                                double dt, float* half_dnew,
                                float* dPdx_out) {
  extern __shared__ double prof[];  // Ny + 1 values: 0, row means, 0
  const int b = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const float* Ub = U + (long long)b * g.C;
  for (int row = 1 + warp; row <= g.Ny - 1; row += nwarps) {
    double s = 0.0;
    for (int c = lane; c < g.C; c += 32) s += Ub[(long long)row * g.ld + c];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) prof[row] = s / g.C;
  }
  if (threadIdx.x == 0) {
    prof[0] = 0.0;
    prof[g.Ny] = 0.0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int k = 0; k < g.Ny; ++k)
      sum += (prof[k + 1] + prof[k]) * 0.5 * (double)trapw[k];
    const double d_new = 2.0 * ((double)meanU0[b] - sum * 0.5);
    half_dnew[b] = (float)(0.5 * d_new);
    dPdx_out[b] = (float)(0.5 * ((double)dPdx[b] + d_new / dt));
  }
}

// U += d_new / 2 on the interior rows (the ghost rows stay as they are).
__global__ void add_massflow_kernel(Grid g, const float* half_dnew, float* U) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, i = blockIdx.y + 1;
  if (c >= g.ld) return;
  U[(long long)i * g.ld + c] += half_dnew[c / g.C];
}

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
  const Grid g = make_grid(d, o);
  const dim3 cols(cdiv(g.ld, kThreads));
  for (int st = 0; st < 3; ++st) {
    const float *Uc = st ? Uo : U, *Vc = st ? Vo : V, *Wc = st ? Wo : W;
    // the first stage's RHS is kept (F1) for the later stages
    float *Fu = st ? w.Fu : w.F1u, *Fv = st ? w.Fv : w.F1v,
          *Fw = st ? w.Fw : w.F1w;
    rhs_fields_kernel<<<dim3(cols.x, d.Ny + 1), kThreads, 0, s>>>(
        g, Uc, Vc, Wc, dPdx, Fu, Fv, Fw);
    PDE_TRY(cudaGetLastError());
    const float c_cur = kStages[st][0], c_prev = kStages[st][1];
    rk_update_kernel<<<dim3(cols.x, d.Ny + 1), kThreads, 0, s>>>(
        g, U, V, W, Fu, Fv, Fw, w.F1u, w.F1v, w.F1w, op1, op2, d.dt * c_cur,
        d.dt * c_prev, c_prev != 0.f, w.Un, w.Vn, w.Wn);
    PDE_TRY(cudaGetLastError());
    divergence_kernel<<<dim3(cols.x, d.Ny - 1), kThreads, 0, s>>>(
        g, w.Un, w.Vn, w.Wn, w.Y);
    PDE_TRY(cudaGetLastError());
    PDE_TRY(spectral_solve(s, d, o, w, w.Y, w.p, /*bordered=*/true));
    correct_kernel<<<dim3(cols.x, d.Ny + 1), kThreads, 0, s>>>(
        g, w.Un, w.Vn, w.Wn, w.p, op1, op2, Uo, Vo, Wo);
    PDE_TRY(cudaGetLastError());
  }
  massflow_kernel<<<d.B, 1024, (d.Ny + 1) * sizeof(double), s>>>(
      g, Uo, meanU0, dPdx, o.trapw, (double)d.dt, w.dnew, dPdx_out);
  PDE_TRY(cudaGetLastError());
  add_massflow_kernel<<<dim3(cols.x, d.Ny - 1), kThreads, 0, s>>>(g, w.dnew,
                                                                   Uo);
  PDE_TRY(cudaGetLastError());
  PDE_TRY(boundary_fwd(s, d, o, w, Uo, Vo, Wo, dPdx_out, w.t));
  return boundary_solve(s, d, o, w, w.t, p);
}
