// The corner contraction of the 2-D spectral convolution, two entries.
//
// Replaces: pde_policylearning_tpu/ops/pallas_kernels.py:
// _corner_contract_kernel (one grid program per mode row r, a loop over the
// M2 columns in VMEM, four MXU products per column), and the XLA glue of
// spectral_conv_2d_pallas around it (corner gather, weight stacking,
// re/im split and recombination, zero padding of the output spectrum).
//
// Bound: bytes, and at the observer's shapes not even those.  8 B I O
// operations per mode against 8 (B I + I O + B O) bytes is at most B
// operations per byte of weights, far below the card's ~20 fp32 operations
// per byte for any batch the observer sees (B = 1 when it serves, 20 when
// it trains).  At the serving shape (B 1, 32 x 17 spectrum, 2 x 6 x 6
// modes, I = O = 32) one conv reads 0.59 MB of weights and the 0.02 MB of
// the input spectrum's two corners (nothing else of it) and writes the
// 0.14 MB of the output spectrum: 0.22 us at the card's memory rate, a tenth
// of what a launch costs.  What the caller waits for is the host: every torch
// call around the kernel (a cat, a complex(), a zeros, a slice assignment)
// costs more than the kernel itself.
//
// So `pde_spectral_corners` does the whole step between rfftn and irfftn in
// one launch on one allocation: it reads the interleaved complex64 spectrum
// (B, H, Wh, I) where rfftn left it, reads each corner's weights where the
// module stores them (pointer + element strides per corner, real and
// imaginary leaf; mode-major or legacy layout, sliced or joint views alike),
// and writes the output spectrum (B, H, Wh, O) whole: the products in the
// two corners (rows [0, m1) and [H - m1, H), columns [0, m2)), zeros
// everywhere else.  Per product block (one mode, kTileB batch rows, up to
// 128 outputs) the contraction axis I is split over the block's threads
// instead of walked by one thread: a thread owns 4 outputs of one slab of
// I, so at I = O = 32 every one of the 256 threads starts its loads at
// once (x as one 8-byte re/im pair, weights as 16-byte rows along O when
// they are contiguous and aligned) and the serial chain is 1 deep instead
// of 32.  The slabs' partial sums go through shared memory and are added
// in slab order by the threads that write the result: fp32 FMA (no TF32,
// no tensor cores), no atomics, one fixed order, deterministic.  The
// gradient to x is the same entry on the output's gradient with the
// weights read transposed (strides swapped) and conjugated (sgn_wi = -1);
// the threads then take the contraction axis as their fast index, so that
// a warp still reads consecutive addresses.  Blocks past the products fill
// the zeros with 8-byte stores.  Every edge is masked: any B, H, Wh, m1,
// m2, I, O >= 1 with 2 m1 <= H and m2 <= Wh.
//
// `pde_corner_contract` is the earlier entry on split real and imaginary
// arrays with element strides and a sign per imaginary part.  It stays for
// the weight gradient dw = conj(x)^T dout (the channel axis in the batch
// role, B the contraction length) and behind the public
// `corner_contract(xr, xi, wr, wi)`:
//   or[r,b,j,o] = sum_i xr[r,b,j,i] wr[r,j,i,o] - xi[r,b,j,i] wi[r,j,i,o]
//   oi[r,b,j,o] = sum_i xr[r,b,j,i] wi[r,j,i,o] + xi[r,b,j,i] wr[r,j,i,o]
// with xr, xi (R, B, M2, I), wr, wi (R, M2, I, O), or, oi (R, B, M2, O).
// A block owns one mode (r, j), a tile of min(B, 8) batch rows and 32
// outputs; a thread one (b, o) pair, walking I in 32-deep slabs of x staged
// in shared memory, four partial sums in registers.
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

struct SpectralDims {
  int B, H, Wh, I, O, m1, m2;
  // element strides of corner c's weights over (kx, ky, in, out); the real
  // and the imaginary leaf share them
  long long ws[2][4];
  float sgn_wi;  // +1, or -1 to conjugate the weights
};

namespace {

constexpr int kSpecThreads = 256, kSpecTileB = 4, kSpecTileO = 128;
constexpr int kSpecZeroPerThread = 8;

// Blocks [0, n_prod) are product blocks, decoded (o tile, batch tile, mode);
// the rest fill the zeros.  groups = threads along O (4 outputs each),
// slabs = kSpecThreads / groups slabs of I.
__global__ void __launch_bounds__(kSpecThreads)
spectral_corners_kernel(SpectralDims d, int n_prod, int o_tiles, int b_tiles,
                        int groups, int vec, int fast_i,
                        const float2* __restrict__ x,
                        const float* __restrict__ wr0,
                        const float* __restrict__ wi0,
                        const float* __restrict__ wr1,
                        const float* __restrict__ wi1,
                        float2* __restrict__ out) {
  __shared__ float2 part[kSpecThreads * 4 * kSpecTileB];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= n_prod) {
    // zero fill: one complex element per store, corners skipped
    const long long total = (long long)d.B * d.H * d.Wh * d.O;
    const long long stride = (long long)(gridDim.x - n_prod) * kSpecThreads;
    long long e = (long long)(blockIdx.x - n_prod) * kSpecThreads + tid;
    for (; e < total; e += stride) {
      const long long pix = e / d.O;
      const int j = (int)(pix % d.Wh), h = (int)((pix / d.Wh) % d.H);
      if (j < d.m2 && (h < d.m1 || h >= d.H - d.m1)) continue;
      out[e] = make_float2(0.f, 0.f);
    }
    return;
  }
  int id = blockIdx.x;
  const int ot = id % o_tiles;
  id /= o_tiles;
  const int bt = id % b_tiles;
  id /= b_tiles;
  const int j = id % d.m2, r = id / d.m2;          // r in [0, 2 m1)
  const int corner = r >= d.m1, kx = corner ? r - d.m1 : r;
  const int h = corner ? d.H - d.m1 + kx : kx;
  // selected, not indexed: a run-time index would copy the struct to
  // local memory
  const long long ws[4] = {corner ? d.ws[1][0] : d.ws[0][0],
                           corner ? d.ws[1][1] : d.ws[0][1],
                           corner ? d.ws[1][2] : d.ws[0][2],
                           corner ? d.ws[1][3] : d.ws[0][3]};
  const long long wbase = kx * ws[0] + j * ws[1];
  const float* wr = (corner ? wr1 : wr0) + wbase;
  const float* wi = (corner ? wi1 : wi0) + wbase;
  const int slabs = kSpecThreads / groups;
  // the fast thread index runs along the axis the weights are contiguous in
  const int grp = fast_i ? tid / slabs : tid % groups;
  const int slab = fast_i ? tid % slabs : tid / groups;
  const int o0 = ot * kSpecTileO + grp * 4;
  const int b0 = bt * kSpecTileB;
  const int nb = min(kSpecTileB, d.B - b0);

  float2 acc[kSpecTileB][4];
#pragma unroll
  for (int t = 0; t < kSpecTileB; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = make_float2(0.f, 0.f);

  if (o0 < d.O) {
    for (int i = slab; i < d.I; i += slabs) {
      float a[4], c[4];  // weights re, im of outputs o0 .. o0 + 3
      const long long wrow = i * ws[2] + o0 * ws[3];
      if (vec && o0 + 3 < d.O) {
        const float4 va = *reinterpret_cast<const float4*>(wr + wrow);
        const float4 vc = *reinterpret_cast<const float4*>(wi + wrow);
        a[0] = va.x, a[1] = va.y, a[2] = va.z, a[3] = va.w;
        c[0] = vc.x, c[1] = vc.y, c[2] = vc.z, c[3] = vc.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = o0 + q < d.O;
          a[q] = in ? wr[wrow + q * ws[3]] : 0.f;
          c[q] = in ? wi[wrow + q * ws[3]] : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < kSpecTileB; ++t) {
        if (t >= nb) break;
        const float2 xv =
            x[(((long long)(b0 + t) * d.H + h) * d.Wh + j) * d.I + i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float wim = d.sgn_wi * c[q];
          acc[t][q].x = fmaf(xv.x, a[q], acc[t][q].x);
          acc[t][q].x = fmaf(-xv.y, wim, acc[t][q].x);
          acc[t][q].y = fmaf(xv.x, wim, acc[t][q].y);
          acc[t][q].y = fmaf(xv.y, a[q], acc[t][q].y);
        }
      }
    }
  }
  // part[slab][t][o in tile]: the tile's width is groups * 4
  const int width = groups * 4;
#pragma unroll
  for (int t = 0; t < kSpecTileB; ++t) {
    if (t >= nb) break;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      part[(slab * kSpecTileB + t) * width + grp * 4 + q] = acc[t][q];
  }
  __syncthreads();
  const int used = min(slabs, d.I);  // slabs past I hold zeros
  for (int e = tid; e < nb * width; e += kSpecThreads) {
    const int t = e / width, oc = e - t * width, o = ot * kSpecTileO + oc;
    if (o >= d.O) continue;
    float2 sum = part[t * width + oc];
    for (int sl = 1; sl < used; ++sl) {
      const float2 v = part[(sl * kSpecTileB + t) * width + oc];
      sum.x += v.x;
      sum.y += v.y;
    }
    out[(((long long)(b0 + t) * d.H + h) * d.Wh + j) * d.O + o] = sum;
  }
}

}  // namespace

// x: interleaved complex64 (B, H, Wh, I), contiguous; out: the same with O
// channels, written whole.  wr*, wi*: the real and imaginary leaves of the
// low (0) and high (1) corner's weights.  Returns the launch's cudaError_t.
extern "C" int pde_spectral_corners(const SpectralDims* d, const float* x,
                                    const float* wr0, const float* wi0,
                                    const float* wr1, const float* wi1,
                                    float* out, void* stream) {
  const int ow = d->O < kSpecTileO ? d->O : kSpecTileO;
  const int groups = (ow + 3) / 4;  // <= 32, so >= 8 slabs of I
  int pow2 = 1;                     // 256 threads split evenly
  while (pow2 < groups) pow2 *= 2;
  const int o_tiles = (d->O + kSpecTileO - 1) / kSpecTileO;
  const int b_tiles = (d->B + kSpecTileB - 1) / kSpecTileB;
  const long long n_prod =
      (long long)o_tiles * b_tiles * 2 * d->m1 * d->m2;
  const long long total = (long long)d->B * d->H * d->Wh * d->O;
  long long n_zero =
      (total + kSpecThreads * kSpecZeroPerThread - 1) /
      (kSpecThreads * kSpecZeroPerThread);
  if (n_zero > 1056) n_zero = 1056;  // 8 blocks per SM, grid-stride beyond
  if (n_prod + n_zero > 2147483647LL) return cudaErrorInvalidConfiguration;
  // 16-byte rows along O: both corners contiguous there and aligned
  int vec = 1, fast_i = 1;
  const float* ptrs[4] = {wr0, wi0, wr1, wi1};
  for (int c = 0; c < 2; ++c) {
    const long long* ws = d->ws[c];
    if (ws[3] != 1 || ws[0] % 4 || ws[1] % 4 || ws[2] % 4) vec = 0;
    if (ws[2] != 1) fast_i = 0;
  }
  for (const float* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16) vec = 0;
  if (vec) fast_i = 0;
  spectral_corners_kernel<<<(unsigned)(n_prod + n_zero), kSpecThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      *d, (int)n_prod, o_tiles, b_tiles, pow2, vec, fast_i,
      reinterpret_cast<const float2*>(x), wr0, wi0, wr1, wi1,
      reinterpret_cast<float2*>(out));
  return cudaGetLastError();
}
