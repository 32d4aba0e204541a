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
// `pde_spectral_corners_dw` is the weight gradient of that step, both
// corners in one launch, straight from the two interleaved spectra (note
// above the entry).
//
// `pde_corner_contract` is the earlier entry on split real and imaginary
// arrays with element strides and a sign per imaginary part.  It stays
// only behind the JAX-named `corner_contract(xr, xi, wr, wi)` and that
// function's own VJP:
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

// The weight gradient of `pde_spectral_corners`, both corners in one launch:
//   dw[c][kx, ky, i, o] = sum_b conj(x[b, h, ky, i]) dout[b, h, ky, o]
// with h = kx for the low corner (c = 0) and H - m1 + kx for the high one,
// written as each corner's (2, m1, m2, I, O) real and imaginary blocks (the
// shape of the weight views the autograd Function is handed); nothing else.
//
// Replaces: the dw half of the VJP of pallas_kernels.py:
// _corner_contract_kernel (:96-113), there the same kernel run with the
// channel axis in the batch role.  The strided entry above did that here
// too, reading the contraction axis B across the spectrum's batch stride.
//
// Bound: bytes.  Per mode (B I + B O) complex inputs and I O complex
// outputs against 4 B I O FMAs: at the RNO's training shape (B 32, I = O =
// 34, 288 modes) 7.68 MB and 42.6 M FMAs, 2.29 us at 3.35 TB/s against
// 1.27 us at 67 TFLOP/s.  These are per-mode products of at most 64 x 64
// over a depth of B, in fp32 FMA: no TF32 and no tensor cores, whose
// `wgmma` tiles (64 rows, fed from shared memory) these few bytes a mode
// could not keep busy.
//
// Design.  A block owns one mode of the corners asked for and one tile of
// at most kDwMaxTile x kDwMaxTile (i, o) channels.  It stages the mode's
// x[b, h, ky, i-tile] and dout[b, h, ky, o-tile] rows in shared memory by
// cp.async, kDwMaxRows batch rows a chunk at most (two buffers when B
// takes more than one chunk, the next chunk's copies in flight while this
// one is summed: any B fits).  The spectra are read through their element
// strides: a spectrum contiguous along the channels (even strides, 16-byte
// aligned) 16 bytes a thread, any other in place 8 bytes a value (rfftn
// and autograd leave spectra channels-first, channel stride H Wh; the
// Function hands this entry the contiguous copies the fused entry reads
// where there are any).  Each thread keeps a kDwRegI x kDwRegO (4 x 2)
// register tile of complex (i, o) sums over b, 32 FMAs a row for three
// 16-byte shared reads; a warp's lanes run along o, so the dout reads are
// consecutive 16-byte words, the x reads broadcasts, and the stores
// 8-byte pairs where O and the tile are even.  The tiles are balanced over
// the channels (I = 34 is one 34-wide tile, 9 x 17 threads in 5 warps, not
// two 32-wide tiles of which one is 2 wide), and split again, the wider
// axis first, while the blocks are fewer than the SMs (the FNO's 72 modes
// at I = O = 32 take 144 blocks of 32 x 16).  The batch is never split
// across blocks: every sum is taken by one thread in b order, so the
// result is the same bit for bit from run to run, for any tiling and any
// layout, with no atomics and no second pass.  Every edge is masked: any
// B, H, Wh, I, O >= 1 with 2 m1 <= H and m2 <= Wh.  On an H100 the sums,
// not the copies or the stores, take most of the time; a 2 x 2 tile, or
// commit groups of 8 rows waited for one by one, were slower (PERF.md).
struct CornerDwDims {
  int B, H, Wh, I, O, m1, m2;
  int want[2];       // nonzero: write that corner's gradient (0 low, 1 high)
  long long xs[4];   // complex element strides of x over (b, h, ky, i)
  long long ds[4];   // and of dout over (b, h, ky, o)
};

namespace {

// kDwRegI x kDwRegO: each thread's register tile of complex (i, o) sums
constexpr int kDwMaxTile = 64, kDwMaxRows = 32, kDwSmemBytes = 48 * 1024,
              kDwRegI = 4, kDwRegO = 2;
static_assert(kDwRegI % 2 == 0 && kDwRegO % 2 == 0,
              "register tiles are read 16 bytes (two complex) at a time");

// the tile padded to whole register tiles (so an even pitch: 16-byte rows)
__host__ __device__ constexpr int dw_pitch(int t, int reg) {
  return (t + reg - 1) / reg * reg;
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// rows [0, nb) of a chunk: row b of `src` starts `stride` complex values
// after row b - 1, its channels `step` apart; `width` live channels land
// at dst + b * pitch.  The copies are issued, not waited for.
__device__ __forceinline__ void stage_rows(float2* dst, const float2* src,
                                           long long stride, long long step,
                                           int nb, int width, int pitch,
                                           int vec) {
  if (vec) {                       // step 1, width even, 16-byte aligned
    const int pairs = width >> 1;
    for (int e = threadIdx.x; e < nb * pairs; e += blockDim.x) {
      const int b = e / pairs, p = 2 * (e - b * pairs);
      cp_async16(dst + b * pitch + p, src + b * stride + p);
    }
  } else {
    for (int e = threadIdx.x; e < nb * width; e += blockDim.x) {
      const int b = e / width, c = e - b * width;
      cp_async8(dst + b * pitch + c, src + b * stride + c * step);
    }
  }
}

// Blocks decode as (row of the corners asked for, ky, i tile, o tile), the
// o tile fastest, so the blocks of one mode run side by side.
__global__ void __launch_bounds__(1024)
corners_dw_kernel(CornerDwDims d, int c_first, int i_tiles, int o_tiles,
                  int tI, int tO, int kb, int vec_x, int vec_d, int vec_o,
                  const float2* __restrict__ x,
                  const float2* __restrict__ dout, float* __restrict__ out0,
                  float* __restrict__ out1) {
  extern __shared__ __align__(16) float2 smem[];
  const int pI = dw_pitch(tI, kDwRegI), pO = dw_pitch(tO, kDwRegO);
  int id = blockIdx.x;
  const int ot = id % o_tiles;
  id /= o_tiles;
  const int it = id % i_tiles;
  id /= i_tiles;
  const int ky = id % d.m2, r = id / d.m2;
  const int corner = c_first + r / d.m1, kx = r % d.m1;
  const int h = corner ? d.H - d.m1 + kx : kx;
  const int i0 = it * tI, o0 = ot * tO;
  const int wI = min(tI, d.I - i0), wO = min(tO, d.O - o0);  // live widths
  const int nchunks = (d.B + kb - 1) / kb, nbuf = nchunks > 1 ? 2 : 1;
  float2* sx = smem;                     // [nbuf][kb][pI]
  float2* sd = smem + nbuf * kb * pI;    // [nbuf][kb][pO]
  const float2* xs = x + h * d.xs[1] + ky * d.xs[2] + i0 * d.xs[3];
  const float2* ds = dout + h * d.ds[1] + ky * d.ds[2] + o0 * d.ds[3];
  const int nto = (tO + kDwRegO - 1) / kDwRegO;
  const int ti = threadIdx.x / nto, to = threadIdx.x - ti * nto;
  const int ia = kDwRegI * ti, oa = kDwRegO * to;  // the tile's first i, o
  const bool live = ia < wI && oa < wO;

  float re[kDwRegI][kDwRegO], im[kDwRegI][kDwRegO];
#pragma unroll
  for (int a = 0; a < kDwRegI; ++a)
#pragma unroll
    for (int c = 0; c < kDwRegO; ++c) re[a][c] = im[a][c] = 0.f;

  auto stage = [&](int ch) {        // chunk ch's copies, one commit group
    const int nb = min(kb, d.B - ch * kb), buf = ch & 1;
    const long long b0 = (long long)ch * kb;
    stage_rows(sx + buf * kb * pI, xs + b0 * d.xs[0], d.xs[0], d.xs[3], nb,
               wI, pI, vec_x);
    stage_rows(sd + buf * kb * pO, ds + b0 * d.ds[0], d.ds[0], d.ds[3], nb,
               wO, pO, vec_d);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      stage(ch + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk ch in
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (live) {
      const float2* cx = sx + (ch & 1) * kb * pI + ia;
      const float2* cd = sd + (ch & 1) * kb * pO + oa;
      const int nb = min(kb, d.B - ch * kb);
      for (int b = 0; b < nb; ++b) {
        float xr[kDwRegI], xi[kDwRegI], dr[kDwRegO], di[kDwRegO];
#pragma unroll
        for (int q = 0; q < kDwRegI; q += 2) {
          const float4 v = *reinterpret_cast<const float4*>(cx + b * pI + q);
          xr[q] = v.x, xi[q] = v.y, xr[q + 1] = v.z, xi[q + 1] = v.w;
        }
#pragma unroll
        for (int q = 0; q < kDwRegO; q += 2) {
          const float4 v = *reinterpret_cast<const float4*>(cd + b * pO + q);
          dr[q] = v.x, di[q] = v.y, dr[q + 1] = v.z, di[q + 1] = v.w;
        }
#pragma unroll
        for (int a = 0; a < kDwRegI; ++a)
#pragma unroll
          for (int c = 0; c < kDwRegO; ++c) {
            // conj(x) dout = (xr dr + xi di) + i (xr di - xi dr)
            re[a][c] = fmaf(xr[a], dr[c], re[a][c]);
            re[a][c] = fmaf(xi[a], di[c], re[a][c]);
            im[a][c] = fmaf(xr[a], di[c], im[a][c]);
            im[a][c] = fmaf(-xi[a], dr[c], im[a][c]);
          }
      }
    }
    __syncthreads();  // the next stage overwrites this chunk's buffer
  }
  if (!live) return;
  float* out = corner ? out1 : out0;
  const long long blk = (long long)d.m1 * d.m2 * d.I * d.O;
#pragma unroll
  for (int a = 0; a < kDwRegI; ++a) {
    if (ia + a >= wI) break;
    const long long q0 =
        (((long long)kx * d.m2 + ky) * d.I + i0 + ia + a) * d.O + o0 + oa;
#pragma unroll
    for (int c = 0; c < kDwRegO; c += 2) {
      if (oa + c >= wO) break;
      if (vec_o) {                 // q0 + c even, both outputs live
        *reinterpret_cast<float2*>(out + q0 + c) =
            make_float2(re[a][c], re[a][c + 1]);
        *reinterpret_cast<float2*>(out + blk + q0 + c) =
            make_float2(im[a][c], im[a][c + 1]);
        continue;
      }
      out[q0 + c] = re[a][c];
      out[blk + q0 + c] = im[a][c];
      if (oa + c + 1 < wO) {
        out[q0 + c + 1] = re[a][c + 1];
        out[blk + q0 + c + 1] = im[a][c + 1];
      }
    }
  }
}

// Channel tiles of at most kDwMaxTile, balanced over n channels: the tile
// width for `tiles` tiles, and the tile count that width needs
void balance(int n, int& tiles, int& width) {
  width = (n + tiles - 1) / tiles;
  tiles = (n + width - 1) / width;
}

// 16-byte copies along the channels: they are contiguous, every row and
// tile starts on an even element, and the spectrum is 16-byte aligned
int pairs_fit(const long long* st, int tile, const float* p) {
  return st[3] == 1 && st[0] % 2 == 0 && st[1] % 2 == 0 && st[2] % 2 == 0 &&
         tile % 2 == 0 && reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// x: interleaved complex64 (B, H, Wh, I), dout (B, H, Wh, O), any strides
// (d->xs, d->ds, in complex elements); out0, out1: the low and high
// corner's contiguous (2, m1, m2, I, O) float32 gradients, each written
// only where d->want asks for it (the other may be null).  Returns the
// launch's cudaError_t.
extern "C" int pde_spectral_corners_dw(const CornerDwDims* d, const float* x,
                                       const float* dout, float* out0,
                                       float* out1, void* stream) {
  const int nc = (d->want[0] != 0) + (d->want[1] != 0);
  if (nc == 0) return cudaSuccess;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int i_tiles = (d->I + kDwMaxTile - 1) / kDwMaxTile, tI;
  int o_tiles = (d->O + kDwMaxTile - 1) / kDwMaxTile, tO;
  balance(d->I, i_tiles, tI);
  balance(d->O, o_tiles, tO);
  const long long modes = (long long)nc * d->m1 * d->m2;
  // fill the card: halve the wider tile while it is 16 channels or more
  while (modes * i_tiles * o_tiles < sms && (tI >= 16 || tO >= 16)) {
    if (tO >= tI) {
      o_tiles *= 2;
      balance(d->O, o_tiles, tO);
    } else {
      i_tiles *= 2;
      balance(d->I, i_tiles, tI);
    }
  }
  const long long blocks = modes * i_tiles * o_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const int pI = dw_pitch(tI, kDwRegI), pO = dw_pitch(tO, kDwRegO);
  int kb = kDwSmemBytes / 2 / ((pI + pO) * (int)sizeof(float2));
  kb = kb < kDwMaxRows ? kb : kDwMaxRows;
  kb = kb < d->B ? kb : d->B;
  const int nbuf = d->B > kb ? 2 : 1;
  const int smem = nbuf * kb * (pI + pO) * (int)sizeof(float2);
  const int threads =
      ((pI / kDwRegI) * (pO / kDwRegO) + 31) / 32 * 32;
  corners_dw_kernel<<<(unsigned)blocks, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      *d, d->want[0] ? 0 : 1, i_tiles, o_tiles, tI, tO, kb,
      pairs_fit(d->xs, tI, x), pairs_fit(d->ds, tO, dout),
      d->O % 2 == 0 && tO % 2 == 0, reinterpret_cast<const float2*>(x),
      reinterpret_cast<const float2*>(dout), out0, out1);
  return cudaGetLastError();
}
