// The backward's per-Gaussian reduce of K2's per-instance rows on Hopper
// (sm_90a): two kernels launched back to back.
//
// Replaces no TPU kernel: the JAX package's reduce is XLA code
// (gs2m_tpu/ops/blend_pallas.py::_segmented_reduce), and the port's plain
// version, ops/blend.py::segment_sum (a stable sort on the Gaussian id, a
// column gather of the (8+V, I) table in that order, a transposing copy,
// torch.segment_reduce), stays the CPU path and the oracle. It was added
// because that chain moved ~11 GB a render at the Tanks and Temples cell:
// its gather reads an instance's 8+V channels as 8+V scattered 4-byte
// words in 8+V rows.
//
// Bound by bytes. The design turns those scattered words into one
// whole-sector row and needs no sort, from the binning's expansion map
// (ops/binning.py: exp_slot, exp_start, exp_kept):
//   rows_kernel  one thread per aligned slot a: reads its 8+V channels from
//                K2's dvals (V, I) and dgeom (8, I), coalesced across
//                threads; where e = exp_slot[a] < I they become one row
//                rows[e] of 8+V floats (64 or 96 bytes, whole sectors), in
//                torch.cat([dvals, dgeom])'s channel order. The warp stages
//                its 32 rows in shared memory and writes them with (8+V)/4
//                consecutive lanes to a row, 16 bytes a lane, so a store
//                instruction writes whole rows (one thread writing its own
//                row in 16-byte pieces measured 3.2x slower at the TnT
//                cell's layout: 1.73 against 0.55 ms);
//   sum_kernel   (8+V)/4 lanes per Gaussian g, each owning a float4 of
//                channels (neighbouring lanes read one row together): walks
//                e over [exp_start[g], exp_start[g+1]) in ascending order
//                and adds rows[e] where exp_kept[e] into float32
//                accumulators that start at +0, then writes g's row of the
//                (C, 8+V) output.
// A Gaussian's kept expansion slots, in ascending order, are its aligned
// slots in ascending order, so the additions are segment_sum's, in its
// order and from its +0: the sums are bit-equal to it. No tree or pairwise
// sum, no atomics: two runs are bit-equal. Built with -fmad=false like the
// other kernels (nothing here multiplies). Plain C interface, loaded with
// ctypes; the entries return cudaGetLastError().
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < kMaxBlocks ? b : kMaxBlocks));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const float* __restrict__ dvals, const float* __restrict__ dgeom,
                const int* __restrict__ exp_slot, float4* __restrict__ rows,
                int I) {
  constexpr int K = V + 8, L = K / 4;
  __shared__ float4 staged[kThreads / 32][32 * L];
  __shared__ int slot[kThreads / 32][32];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * kThreads;
  // The bound is block-uniform, so every lane of a warp takes each turn.
  for (long long base = (long long)blockIdx.x * kThreads; base < I;
       base += stride) {
    const long long a = base + threadIdx.x;
    const int e = a < I ? exp_slot[a] : I;
    slot[w][lane] = e;
    if (e < I) {
      float r[K];
#pragma unroll
      for (int c = 0; c < V; ++c) r[c] = dvals[(long long)c * I + a];
#pragma unroll
      for (int c = 0; c < 8; ++c) r[V + c] = dgeom[(long long)c * I + a];
#pragma unroll
      for (int q = 0; q < L; ++q)
        staged[w][lane * L + q] =
            make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    }
    __syncwarp();
    // The warp's 32 rows, L consecutive lanes to a row.
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int idx = j * 32 + lane;
      const int dst = slot[w][idx / L];
      if (dst < I) rows[(long long)dst * L + idx % L] = staged[w][idx];
    }
    __syncwarp();
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    sum_kernel(const int* __restrict__ exp_start,
               const uint8_t* __restrict__ exp_kept,
               const float4* __restrict__ rows, float4* __restrict__ out,
               int C) {
  constexpr int L = (V + 8) / 4;  // lanes per Gaussian, a float4 each
  const long long n = (long long)C * L;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += stride) {
    const long long g = t / L;
    const int q = static_cast<int>(t - g * L);
    const int e1 = exp_start[g + 1];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = exp_start[g]; e < e1; ++e) {
      if (!exp_kept[e]) continue;
      const float4 r = rows[(long long)e * L + q];
      acc.x += r.x;
      acc.y += r.y;
      acc.z += r.z;
      acc.w += r.w;
    }
    out[t] = acc;
  }
}

}  // namespace

// Pass 1. dvals (V, I), dgeom (8, I) float32; exp_slot (I,) int32; rows
// (I, 8+V) float32, 16-byte aligned (rows of expansion slots no aligned
// slot maps to are left unwritten).
extern "C" int gs2m_instance_rows(const void* dvals, const void* dgeom,
                                  const void* exp_slot, void* rows, int I,
                                  int V, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto dv = static_cast<const float*>(dvals);
  const auto dg = static_cast<const float*>(dgeom);
  const auto es = static_cast<const int*>(exp_slot);
  const auto r = static_cast<float4*>(rows);
  const unsigned grid = blocks_for(I);
  switch (V) {
    case 8: rows_kernel<8><<<grid, kThreads, 0, s>>>(dv, dg, es, r, I); break;
    case 16: rows_kernel<16><<<grid, kThreads, 0, s>>>(dv, dg, es, r, I); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Pass 2. exp_start (C+1,) int32; exp_kept (I,) bool; rows as pass 1 wrote
// them; out (C, 8+V) float32, 16-byte aligned.
extern "C" int gs2m_instance_sum(const void* exp_start, const void* exp_kept,
                                 const void* rows, void* out, int C, int V,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto st = static_cast<const int*>(exp_start);
  const auto kept = static_cast<const uint8_t*>(exp_kept);
  const auto r = static_cast<const float4*>(rows);
  const auto o = static_cast<float4*>(out);
  switch (V) {
    case 8:
      sum_kernel<8><<<blocks_for((long long)C * 4), kThreads, 0, s>>>(
          st, kept, r, o, C);
      break;
    case 16:
      sum_kernel<16><<<blocks_for((long long)C * 6), kThreads, 0, s>>>(
          st, kept, r, o, C);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
