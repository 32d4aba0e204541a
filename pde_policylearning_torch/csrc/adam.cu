// Adam over many float32 tensors in one pass a step: the update of
// `training/optimizers.py:FusedAdam` (no weight decay, no AMSGrad).
//
// Replaces no TPU kernel.  The JAX package's inner optimizer is
// `optax.adam` (pde_policylearning_tpu/control/policies.py:45), whose
// element-wise chain XLA fuses into one loop; torch's capturable foreach
// Adam instead makes about eight parameter-sized passes a step, two of
// them unvectorised broadcast divides.  Added for the flagship policy's
// inner steps (`control/policies.py:make_optimal_policy_observer`), three
// a control step over the 226.5M parameters of the full-width
// `PolicyModel2D`.
//
// Bound: bytes.  A step reads p, g, m and v and writes p, m and v: 28 B a
// parameter, 6.3 GB a step at full width, 1.89 ms at 3.35 TB/s; its ~12
// operations a parameter are far below the card's ridge point.  The design
// streams those bytes once: the leaves are cut into 4096-element chunks, one
// block a chunk, so the large spectral leaves and the small ones share one
// launch; each thread keeps ADAM_UNROLL independent float4 loads of each of
// the four tensors in flight.  Measured on an H100 at full width: 2.12 ms a
// step, 89% of the bound; a persistent grid of two blocks an SM walking the
// chunks took 2.21, and evict-first hints (__ldcs, __stcs) on the loads
// 1.6% longer.
//
// The step count stays on the device (so a CUDA graph's replay after the
// moments and the count were zeroed is a fresh optimizer's first step):
// `adam_count_kernel`, one thread launched before the update, advances it
// and writes the step's two bias-corrected scalars, which every thread of
// the update then reads.  Nothing is skipped for its value: a zero
// gradient goes through the same arithmetic and leaves p, m and v as they
// were (0 / (0 + eps) is exactly 0).
#include <cuda_runtime.h>

#define ADAM_BLOCK 256
#define ADAM_UNROLL 4
// elements a chunk: one float4 of each tensor per thread and unroll
#define ADAM_CHUNK (ADAM_BLOCK * ADAM_UNROLL * 4)
// leaves a launch, so that the table passed by value stays within the
// classic 4 KB of kernel parameters; more leaves take more launches
#define ADAM_MAX_LEAVES 84

struct AdamLeaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;       // elements
  int chunk0;        // the leaf's first chunk of the launch
};

struct AdamTable {
  const float* scal;  // lr / (1 - b1^t) and sqrt(1 - b2^t), on the device
  float b2, a1, a2, eps;  // b2, 1 - b1, 1 - b2, eps
  int n_leaves, n_chunks;
  AdamLeaf leaf[ADAM_MAX_LEAVES];
};

static_assert(sizeof(AdamLeaf) == 48, "AdamLeaf is mirrored by ctypes");
static_assert(sizeof(AdamTable) <= 4096, "the table is a kernel parameter");

namespace {

// One element, in the order of torch's single-tensor Adam (lerp, then
// mul and addcmul, sqrt / bc2 + eps, addcdiv); the library builds with
// --fmad=false, so each operation rounds on its own.
__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float b2, float a1,
                                         float a2, float eps, float ss,
                                         float bc2s) {
  m = m + a1 * (g - m);
  v = v * b2 + a2 * g * g;
  const float d = sqrtf(v) / bc2s + eps;
  p = p + (-ss * m) / d;
}

__device__ __forceinline__ void adam_four(float4& p, const float4& g,
                                          float4& m, float4& v, float b2,
                                          float a1, float a2, float eps,
                                          float ss, float bc2s) {
  adam_one(p.x, g.x, m.x, v.x, b2, a1, a2, eps, ss, bc2s);
  adam_one(p.y, g.y, m.y, v.y, b2, a1, a2, eps, ss, bc2s);
  adam_one(p.z, g.z, m.z, v.z, b2, a1, a2, eps, ss, bc2s);
  adam_one(p.w, g.w, m.w, v.w, b2, a1, a2, eps, ss, bc2s);
}

__global__ void adam_count_kernel(float* step, float* scal, double lr,
                                  double b1, double b2) {
  const float t = step[0] + 1.0f;
  step[0] = t;
  scal[0] = static_cast<float>(lr / (1.0 - pow(b1, (double)t)));
  scal[1] = static_cast<float>(sqrt(1.0 - pow(b2, (double)t)));
}

// Block c takes chunk c of the launch, which belongs to the last leaf
// whose chunk0 <= c (a binary search of the table), and covers its
// elements [(c - chunk0) * ADAM_CHUNK, + ADAM_CHUNK) cut at the leaf's
// end.  Thread t and unroll u take the chunk's float4 t + u * ADAM_BLOCK
// (the wrapper checks that every pointer is 16-B aligned), and threads 0..2
// the leaf's last n % 4 elements.  Each element is read once, by the thread
// that then writes it, so p, m and v too may take the read-only path
// (__ldg).
__global__ void __launch_bounds__(ADAM_BLOCK)
    multi_tensor_apply_adam_kernel(const __grid_constant__ AdamTable t) {
  const int c = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  const AdamLeaf& L = t.leaf[lo];
  const float ss = __ldg(t.scal), bc2s = __ldg(t.scal + 1);
  const float b2 = t.b2, a1 = t.a1, a2 = t.a2, eps = t.eps;
  const long long start = (long long)(c - L.chunk0) * ADAM_CHUNK;
  const long long left = L.n - start;
  const int len = left < ADAM_CHUNK ? (int)left : ADAM_CHUNK;
  float* p = L.p + start;
  const float* g = L.g + start;
  float* m = L.m + start;
  float* v = L.v + start;
  const int nv = len >> 2;
  float4 rp[ADAM_UNROLL], rg[ADAM_UNROLL], rm[ADAM_UNROLL], rv[ADAM_UNROLL];
#pragma unroll
  for (int u = 0; u < ADAM_UNROLL; ++u) {
    const int i = threadIdx.x + u * ADAM_BLOCK;
    if (i < nv) {
      rp[u] = __ldg(reinterpret_cast<const float4*>(p) + i);
      rg[u] = __ldg(reinterpret_cast<const float4*>(g) + i);
      rm[u] = __ldg(reinterpret_cast<const float4*>(m) + i);
      rv[u] = __ldg(reinterpret_cast<const float4*>(v) + i);
    }
  }
#pragma unroll
  for (int u = 0; u < ADAM_UNROLL; ++u) {
    const int i = threadIdx.x + u * ADAM_BLOCK;
    if (i < nv) {
      adam_four(rp[u], rg[u], rm[u], rv[u], b2, a1, a2, eps, ss, bc2s);
      reinterpret_cast<float4*>(p)[i] = rp[u];
      reinterpret_cast<float4*>(m)[i] = rm[u];
      reinterpret_cast<float4*>(v)[i] = rv[u];
    }
  }
  const int i = (nv << 2) + threadIdx.x;
  if (i < len) {
    float pi = __ldg(p + i), mi = __ldg(m + i), vi = __ldg(v + i);
    adam_one(pi, __ldg(g + i), mi, vi, b2, a1, a2, eps, ss, bc2s);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// step: the float32 step count (0-dim, on the device), advanced by one;
// scal: two floats, the step's lr / (1 - b1^t) and sqrt(1 - b2^t).  One
// thread.  Returns the launch's cudaError_t.
extern "C" int pde_adam_count(float* step, float* scal, double lr, double b1,
                              double b2, void* stream) {
  adam_count_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      step, scal, lr, b1, b2);
  return cudaGetLastError();
}

// One update over the table's leaves (after `pde_adam_count` on the same
// stream): one block a chunk.  Returns the launch's cudaError_t.
extern "C" int pde_adam_update(const AdamTable* t, void* stream) {
  if (t->n_chunks <= 0) return cudaSuccess;
  if (t->n_leaves < 1 || t->n_leaves > ADAM_MAX_LEAVES)
    return cudaErrorInvalidValue;
  multi_tensor_apply_adam_kernel<<<t->n_chunks, ADAM_BLOCK, 0,
                                   static_cast<cudaStream_t>(stream)>>>(*t);
  return cudaGetLastError();
}
