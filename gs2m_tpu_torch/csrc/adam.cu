// Adam over every parameter group in one launch, on Hopper (sm_90a).
//
// Replaces the eager loop of train/optim.py::adam_update_plain (14
// elementwise launches a group) on CUDA tensors. It replaces no Pallas
// kernel: the JAX package leaves its Adam (gs2m_tpu/train/optim.py) to XLA.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each element reads p, g, m and v
// once and writes p, m and v once, 28 B; a row of the Gaussians holds 64
// floats at SH degree 3, so 1,792 B a row, 7.52 GB at 2^22 rows (2.24 ms).
// The eager loop's 14 passes move 33 accesses an element, 4.7x as much.
//
// Design. The group table travels by value as the kernel's argument (at most
// kMaxGroups groups, under 1 KB): nothing is copied to the card and nothing
// syncs. Each group's elements are cut into blocks of kBlockElems; block b
// belongs to the last group whose first block is <= b, picked by an unrolled
// scan so the table is read with constant offsets only. A thread updates four
// consecutive elements with 16-byte loads and stores (the wrapper refuses a
// parameter or moment that does not start on a 16-byte boundary, and copies
// such a gradient), and the ragged end of its group element by element. A
// missing gradient reads as +0.0 and goes through the same adds as any other,
// as torch.zeros_like's does.
//
// Arithmetic. Built with -fmad=false and IEEE sqrtf and division, each step
// rounds where eager CUDA PyTorch rounds the loop, in float32:
//   m = m*b1 + (1-b1)*g;  v = v*b2 + ((1-b2)*g)*g
//   p = p - (lr * (m*inv_c1)) / (sqrt(v*inv_c2) + eps)
// with every scalar rounded to float32 on the host; inv_c = 1/c in float32,
// since eager CUDA divides a tensor by a host scalar as a multiply by the
// scalar's float reciprocal. Each element is read and written by one thread
// only: no atomics, bit-reproducible. Plain C interface, loaded with ctypes
// and called as the kernel of the dispatcher operator gs2m::adam_
// (train/optim.py), so the profiler counts its time under the caller's range;
// the entry returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kBlockElems = kThreads * kVec;  // train/optim.py ADAM_BLOCK
constexpr int kMaxGroups = 16;                // train/optim.py ADAM_MAX_GROUPS

struct Group {
  float* p;
  const float* g;  // null: no gradient (zeros)
  float* m;
  float* v;
  long long n;      // elements
  float lr;
  int first_block;  // the group's blocks are [first_block, next group's)
};

// The step's scalars, each rounded to float32 on the host.
struct Coef {
  float b1, b2, omb1, omb2, inv_c1, inv_c2, eps;
};

struct Table {
  Group grp[kMaxGroups];
  int n_groups;
  Coef c;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, float lr, const Coef& c) {
  m = m * c.b1 + c.omb1 * g;
  v = v * c.b2 + (c.omb2 * g) * g;
  const float m_hat = m * c.inv_c1;
  const float den = sqrtf(v * c.inv_c2) + c.eps;
  p = p - (lr * m_hat) / den;
}

__device__ __forceinline__ void adam_at(const Group& G, long long i,
                                        const Coef& c) {
  float p = G.p[i], m = G.m[i], v = G.v[i];
  adam_elem(p, G.g ? G.g[i] : 0.f, m, v, G.lr, c);
  G.p[i] = p;
  G.m[i] = m;
  G.v[i] = v;
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const Table t) {
  const int b = blockIdx.x;
  Group G = t.grp[0];
#pragma unroll
  for (int j = 1; j < kMaxGroups; ++j)
    if (j < t.n_groups && b >= t.grp[j].first_block) G = t.grp[j];
  const Coef c = t.c;
  const long long i = static_cast<long long>(b - G.first_block) * kBlockElems
                      + static_cast<long long>(threadIdx.x) * kVec;
  if (i + kVec <= G.n) {
    float4 p = *reinterpret_cast<const float4*>(G.p + i);
    float4 m = *reinterpret_cast<const float4*>(G.m + i);
    float4 v = *reinterpret_cast<const float4*>(G.v + i);
    const float4 g = G.g ? *reinterpret_cast<const float4*>(G.g + i)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    adam_elem(p.x, g.x, m.x, v.x, G.lr, c);
    adam_elem(p.y, g.y, m.y, v.y, G.lr, c);
    adam_elem(p.z, g.z, m.z, v.z, G.lr, c);
    adam_elem(p.w, g.w, m.w, v.w, G.lr, c);
    *reinterpret_cast<float4*>(G.p + i) = p;
    *reinterpret_cast<float4*>(G.m + i) = m;
    *reinterpret_cast<float4*>(G.v + i) = v;
  } else {
    for (long long k = i; k < G.n; ++k) adam_at(G, k, c);
  }
}

}  // namespace

// ptrs: p, g, m, v of each group in turn (g null where there is none), each
// 16-byte aligned. n, lr: one per group; first_block: n_groups + 1 entries,
// the last the grid's size (train/optim.py::adam_blocks). Scalars in float32
// as train/optim.py::adam_scalars rounds them.
extern "C" int gs2m_adam(void* const* ptrs, const long long* n,
                         const float* lr, const int* first_block,
                         int n_groups, float b1, float b2,
                         float omb1, float omb2, float inv_c1, float inv_c2,
                         float eps, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  Table t = {};
  for (int k = 0; k < n_groups; ++k) {
    Group& G = t.grp[k];
    G.p = static_cast<float*>(ptrs[4 * k]);
    G.g = static_cast<const float*>(ptrs[4 * k + 1]);
    G.m = static_cast<float*>(ptrs[4 * k + 2]);
    G.v = static_cast<float*>(ptrs[4 * k + 3]);
    G.n = n[k];
    G.lr = lr[k];
    G.first_block = first_block[k];
  }
  t.n_groups = n_groups;
  t.c = Coef{b1, b2, omb1, omb2, inv_c1, inv_c2, eps};
  const int blocks = first_block[n_groups];
  if (blocks > 0)
    adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}
