// Corner contraction of the 2-D spectral convolution: for every retained
// mode (r, j) the complex product (B, I) x (I, O), real and imaginary parts
// as separate float32 arrays,
//   or[r,b,j,o] = sum_i xr[r,b,j,i] wr[r,j,i,o] - xi[r,b,j,i] wi[r,j,i,o]
//   oi[r,b,j,o] = sum_i xr[r,b,j,i] wi[r,j,i,o] + xi[r,b,j,i] wr[r,j,i,o]
// with xr, xi (R, B, M2, I), wr, wi (R, M2, I, O), or, oi (R, B, M2, O).
//
// Replaces: pde_policylearning_tpu/ops/pallas_kernels.py:
// _corner_contract_kernel (one grid program per mode row r, a loop over the
// M2 columns in VMEM, four MXU products per column).
//
// Here a block owns one mode (r, j), a tile of min(B, 8) batch rows and a
// tile of 32 output channels; a thread owns one (b, o) output pair.  The
// block stages its x rows in shared memory one 32-deep slab of I at a time
// and walks the slab with wr, wi read along O, the contiguous axis of the
// stored weights, so a warp reads consecutive addresses.  The four partial
// sums (xr wr, xi wi, xr wi, xi wr) stay in registers, accumulate with
// explicit fmaf in increasing i, and are combined once at the end: fp32
// FMA only (no TF32, no tensor cores), no atomics, one fixed order, so the
// result is deterministic and rounds as four fp32 dot products do.
//
// Operands come with element strides, and the imaginary parts with a sign,
// so that the two transposed products of the gradient,
//   dx = dout conj(w)^T   (w read with I and O swapped, wi negated),
//   dw = conj(x)^T dout   (the channel axis in the batch role, B the
//                          contraction length, xi negated),
// launch on views of the saved tensors with no copy.  The price is on the
// dx product: its "O" axis is the weights' I axis, 32 floats apart, so those
// reads are not coalesced.  Nothing is assumed to be a multiple of a tile:
// every edge (B, I, O) is masked, and any B, M2, I, O >= 1 is taken.
//
// Bound: bytes.  8 R M2 B I O operations against 4 (2 R B M2 I +
// 2 R M2 I O + 2 R B M2 O) bytes is at most B/2 operations per byte of
// weights, far below the card's ~20 fp32 operations per byte for any batch
// the observer sees (B = 1 when it serves, 20 when it trains).  At the
// serving shape (R 12, B 1, M2 6, I = O = 32) the whole call moves 0.63 MB,
// 94% of it weights, less than a launch costs: see PERF.md.
#include <cuda_runtime.h>

struct CornerDims {
  int R, B, M2, I, O;
  long long xs[4];  // element strides of xr, xi over (r, b, j, i)
  long long ws[4];  // element strides of wr, wi over (r, j, i, o)
  float sgn_xi, sgn_wi;  // +1, or -1 to conjugate that operand
};

namespace {

constexpr int kTileO = 32, kTileB = 8, kSlabI = 32;

// No __launch_bounds__: under a 256-thread bound ptxas holds the kernel to 32
// registers and spills; left alone it takes 40 and spills nothing.
__global__ void corner_contract_kernel(
    CornerDims d, const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ wr, const float* __restrict__ wi,
    float* __restrict__ outr, float* __restrict__ outi) {
  __shared__ float sxr[kTileB][kSlabI];
  __shared__ float sxi[kTileB][kSlabI];
  const int r = blockIdx.x / d.M2, j = blockIdx.x % d.M2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.y * blockDim.y + ty, o = blockIdx.z * kTileO + tx;
  const bool live_b = b < d.B, live = live_b && o < d.O;
  const float* xrow_r = xr + r * d.xs[0] + b * d.xs[1] + j * d.xs[2];
  const float* xrow_i = xi + r * d.xs[0] + b * d.xs[1] + j * d.xs[2];
  const long long wbase = r * d.ws[0] + j * d.ws[1] + o * d.ws[3];
  float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
  for (int i0 = 0; i0 < d.I; i0 += kSlabI) {
    // kTileO == kSlabI: thread tx loads element i0 + tx of its row
    const int il = i0 + tx;
    const bool in = live_b && il < d.I;
    sxr[ty][tx] = in ? xrow_r[il * d.xs[3]] : 0.f;
    sxi[ty][tx] = in ? d.sgn_xi * xrow_i[il * d.xs[3]] : 0.f;
    __syncthreads();
    if (live) {
      const int n = min(kSlabI, d.I - i0);
      for (int k = 0; k < n; ++k) {
        const long long w = wbase + (i0 + k) * d.ws[2];
        const float a = sxr[ty][k], c = sxi[ty][k];
        const float wre = wr[w], wim = d.sgn_wi * wi[w];
        rr = fmaf(a, wre, rr);
        ii = fmaf(c, wim, ii);
        ri = fmaf(a, wim, ri);
        ir = fmaf(c, wre, ir);
      }
    }
    __syncthreads();
  }
  if (live) {
    const long long q = (((long long)r * d.B + b) * d.M2 + j) * d.O + o;
    outr[q] = rr - ii;
    outi[q] = ri + ir;
  }
}

}  // namespace

// outr, outi: contiguous (R, B, M2, O).  Returns the launch's cudaError_t.
extern "C" int pde_corner_contract(const CornerDims* d, const float* xr,
                                   const float* xi, const float* wr,
                                   const float* wi, float* outr, float* outi,
                                   void* stream) {
  const int tb = d->B < kTileB ? d->B : kTileB;  // no idle warps at B = 1
  const dim3 grid(d->R * d->M2, (d->B + tb - 1) / tb,
                  (d->O + kTileO - 1) / kTileO);
  corner_contract_kernel<<<grid, dim3(kTileO, tb), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      *d, xr, xi, wr, wi, outr, outi);
  return cudaGetLastError();
}
