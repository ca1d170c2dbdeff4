// K1: forward tiled alpha blend on Hopper (sm_90a).
//
// Replaces gs2m_tpu/ops/blend_pallas.py::_fwd_kernel (launched by
// _run_forward). The design note, the bound and the plain PyTorch version
// that this kernel is held against are in gs2m_tpu_torch/ops/blend.py.
//
// One block per 16x16 tile, one thread per pixel, each warp an 8x4 pixel
// block. The block loops over its tile's contiguous chunk range
// [bounds[t], bounds[t+1]) and carries the pixel's (logT, done) and the V
// accumulators in registers. The kernel is bound by the instructions of its
// per-(instance, pixel) step (expf, log1pf, expf), not by bytes, so:
//  - exact warp cull: when a chunk is staged, every instance gets its
//    conservative pixel rectangle (blend_common.cuh::cull_rect) and each warp
//    a bit mask of the instances that may reach its block; a warp walks only
//    the set bits, in order. A skipped instance has alpha 0 at every lane of
//    the warp, so the walk, the counts and the image are unchanged;
//  - overlapped staging: the chunk's geometry and values are double-buffered
//    in shared memory and the next chunk's cp.async copies are in flight
//    while this one is walked (the double layout fits every admitted chunk
//    and V: 214 KB at chunk 1024, V=16);
//  - observe counts: a ballot and popc per walked instance into a shared
//    [8][chunk] table summed in fixed order.
// Blocks past the last tile fill the dummy tile's padding chunks. Plain C
// interface, loaded with ctypes; the entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gs2m;

template <int V>
__global__ void __launch_bounds__(kPixels, 2)
blend_fwd_kernel(const float* __restrict__ geom,      // (8, I)
                 const float* __restrict__ vals,      // (V, I)
                 const int* __restrict__ bounds,      // (T+1,) first chunk per tile
                 float* __restrict__ img,             // (T+1, V, P)
                 float* __restrict__ fT,              // (T+1, P)
                 float* __restrict__ clogT,           // (n_chunks, P)
                 float* __restrict__ cdone,           // (n_chunks, P)
                 int* __restrict__ obs,               // (n_chunks, chunk)
                 int T, int n_chunks, int chunk, int grid_x, int width,
                 int height, float log_eps, float log_half, float alpha_min) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t I = (size_t)n_chunks * chunk;

  if ((int)blockIdx.x >= T) {
    // The dummy tile T: its padding chunks hold only logT 0, done 0, obs 0,
    // which is what walking them would compute (null slots have opacity 0).
    const int b = blockIdx.x - T;
    if (b == 0) {
      for (int v = 0; v < V; ++v) img[((size_t)T * V + v) * kPixels + tid] = 0.f;
      fT[(size_t)T * kPixels + tid] = 1.f;
    }
    for (int c = bounds[T] + b; c < n_chunks; c += gridDim.x - T) {
      clogT[(size_t)c * kPixels + tid] = 0.f;
      cdone[(size_t)c * kPixels + tid] = 0.f;
      for (int k = tid; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
    }
    return;
  }

  const int stage = (kGeomRows + V) * chunk;                 // floats per buffer
  int* s_obs = reinterpret_cast<int*>(smem + 2 * stage);     // [warps][chunk]
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(s_obs + kWarps * chunk);   // [warps][kMaxWords]

  const int t = blockIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int p = pixel_of_thread(tid);
  const float tx0 = (float)((t % grid_x) * kTile);
  const float ty0 = (float)((t / grid_x) * kTile);
  const float px = tx0 + (float)(p % kTile);
  const float py = ty0 + (float)(p / kTile);
  const bool inside = px < width && py < height;
  const int words = chunk / 32;

  float logT = 0.f;
  bool done = false;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  const int c0 = bounds[t], c1 = bounds[t + 1];
  auto issue = [&](int c, float* dst) {
    const size_t base = (size_t)c * chunk;
    stage_rows_async(dst, geom, kGeomRows, I, base, chunk, tid);
    stage_rows_async(dst + kGeomRows * chunk, vals, V, I, base, chunk, tid);
  };
  if (c0 < c1) issue(c0, smem);
  async_commit();
  for (int c = c0; c < c1; ++c) {
    float* s_geom = smem + ((c - c0) & 1) * stage;
    const float* s_vals = s_geom + kGeomRows * chunk;
    clogT[(size_t)c * kPixels + p] = logT;
    cdone[(size_t)c * kPixels + p] = done ? 1.f : 0.f;
    // The other buffer was last read before the previous chunk's final
    // barrier: refill it with the next chunk while this one is walked.
    if (c + 1 < c1) issue(c + 1, smem + ((c + 1 - c0) & 1) * stage);
    async_commit();
    async_wait<1>();
    // Skip a chunk whose tile has terminated everywhere (pixels outside
    // the image never contribute, so they count as done here). The barrier
    // also makes this chunk's staged rows visible to every thread.
    if (__syncthreads_and(done || !inside)) {
      for (int k = tid; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
      continue;
    }
    build_cull_masks(s_geom, chunk, tx0, ty0, alpha_min, s_mask, tid);
    for (int i = tid; i < kWarps * chunk; i += kPixels) s_obs[i] = 0;
    __syncthreads();

    // The JAX package's recurrence, term for term (blend_common.cuh), over
    // the instances that may reach this warp's block.
    const float logT0 = logT;
    float cum = 0.f, contributed = 0.f;
    const unsigned* mask = s_mask + warp * kMaxWords;
    bool fin = false;
    for (int j = 0; j < words && !fin; ++j) {
      for (unsigned m = mask[j]; m != 0; m &= m - 1) {
        // A warp whose inside pixels are all done adds nothing more; its
        // remaining observe entries stay 0.
        if (__all_sync(kFull, done || !inside)) {
          fin = true;
          break;
        }
        const int k = 32 * j + __ffs(m) - 1;
        const Step st = walk_step(s_geom, chunk, k, px, py, inside, logT0,
                                  log_eps, alpha_min, cum, done);
        bool seen = false;
        if (st.contribute) {
          const float w = st.alpha * expf(st.logT_excl);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += s_vals[v * chunk + k] * w;
          contributed += st.log1m;
          seen = st.logT_excl > log_half;
        }
        const unsigned votes = __ballot_sync(kFull, seen);
        if (lane == 0 && votes != 0) s_obs[warp * chunk + k] = __popc(votes);
      }
    }
    logT = logT0 + contributed;
    __syncthreads();
    for (int k = tid; k < chunk; k += kPixels) {
      int n = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) n += s_obs[w * chunk + k];
      obs[(size_t)c * chunk + k] = n;
    }
    // The next chunk's barrier orders these reads before s_obs and the
    // masks are refilled.
  }
  async_wait<0>();

  fT[(size_t)t * kPixels + p] = expf(logT);
#pragma unroll
  for (int v = 0; v < V; ++v) img[((size_t)t * V + v) * kPixels + p] = acc[v];
}

template <int V>
size_t smem_bytes(int chunk) {
  return ((size_t)2 * (kGeomRows + V) * chunk + (size_t)kWarps * chunk
          + (size_t)kWarps * kMaxWords) * 4;
}

template <int V>
cudaError_t launch(const float* geom, const float* vals, const int* bounds,
                   float* img, float* fT, float* clogT, float* cdone, int* obs,
                   int T, int n_chunks, int chunk, int grid_x, int width,
                   int height, float log_eps, float log_half, float alpha_min,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<V>(chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blend_fwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  blend_fwd_kernel<V><<<T + kFillBlocks, kPixels, smem, stream>>>(
      geom, vals, bounds, img, fT, clogT, cdone, obs, T, n_chunks, chunk,
      grid_x, width, height, log_eps, log_half, alpha_min);
  return cudaGetLastError();
}

template <int V>
cudaError_t info(int chunk, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, blend_fwd_kernel<V>);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<V>(chunk);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(blend_fwd_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_fwd_kernel<V>, kPixels, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return e;
}

}  // namespace

extern "C" int gs2m_blend_fwd(const void* geom, const void* vals,
                              const void* bounds, void* img, void* fT,
                              void* clogT, void* cdone, void* obs, int T,
                              int n_chunks, int chunk, int V, int grid_x,
                              int width, int height, float log_eps,
                              float log_half, float alpha_min, void* stream) {
  const auto g = static_cast<const float*>(geom);
  const auto va = static_cast<const float*>(vals);
  const auto bo = static_cast<const int*>(bounds);
  const auto im = static_cast<float*>(img);
  const auto ft = static_cast<float*>(fT);
  const auto cl = static_cast<float*>(clogT);
  const auto cd = static_cast<float*>(cdone);
  const auto ob = static_cast<int*>(obs);
  const auto s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<size_t>(geom) | reinterpret_cast<size_t>(vals)) % 16) {
    return (int)cudaErrorMisalignedAddress;  // cp.async moves 16-byte vectors
  }
  cudaError_t e;
  if (V == 8) {
    e = launch<8>(g, va, bo, im, ft, cl, cd, ob, T, n_chunks, chunk, grid_x,
                  width, height, log_eps, log_half, alpha_min, s);
  } else if (V == 16) {
    e = launch<16>(g, va, bo, im, ft, cl, cd, ob, T, n_chunks, chunk, grid_x,
                   width, height, log_eps, log_half, alpha_min, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}

// Registers per thread, local (spill) bytes per thread, dynamic shared
// bytes and resident blocks per SM of the kernel at (V, chunk), into
// out[0..4).
extern "C" int gs2m_blend_fwd_info(int V, int chunk, int* out) {
  if (V == 8) return (int)info<8>(chunk, out);
  if (V == 16) return (int)info<16>(chunk, out);
  return (int)cudaErrorInvalidValue;
}
