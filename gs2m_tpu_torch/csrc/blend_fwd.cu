// K1: forward tiled alpha blend on Hopper (sm_90a).
//
// Replaces gs2m_tpu/ops/blend_pallas.py::_fwd_kernel (launched by
// _run_forward). The design note, the bound and the plain PyTorch version
// that this kernel is held against are in gs2m_tpu_torch/ops/blend.py.
//
// One block per 16x16 tile, one thread per pixel. The block loops over its
// tile's contiguous chunk range [bounds[t], bounds[t+1]) and carries the
// pixel's (logT, done) and the V accumulators in registers. Blocks past the
// last tile fill the dummy tile's padding chunks. Plain C interface, loaded
// with ctypes; the entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gs2m;

template <int V>
__global__ void __launch_bounds__(kPixels)
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
  const int p = threadIdx.x;
  const size_t I = (size_t)n_chunks * chunk;

  if ((int)blockIdx.x >= T) {
    // The dummy tile T: its padding chunks hold only logT 0, done 0, obs 0,
    // which is what walking them would compute (null slots have opacity 0).
    const int b = blockIdx.x - T;
    if (b == 0) {
      for (int v = 0; v < V; ++v) img[((size_t)T * V + v) * kPixels + p] = 0.f;
      fT[(size_t)T * kPixels + p] = 1.f;
    }
    for (int c = bounds[T] + b; c < n_chunks; c += gridDim.x - T) {
      clogT[(size_t)c * kPixels + p] = 0.f;
      cdone[(size_t)c * kPixels + p] = 0.f;
      for (int k = p; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
    }
    return;
  }

  float* s_geom = smem;                                    // [6][chunk]
  float* s_vals = s_geom + kGeomRows * chunk;              // [V][chunk]
  int* s_obs = reinterpret_cast<int*>(s_vals + V * chunk);  // [warps][chunk]

  const int t = blockIdx.x;
  const int warp = p / 32, lane = p % 32;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);
  const bool inside = px < width && py < height;

  float logT = 0.f;
  bool done = false;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  const int c1 = bounds[t + 1];
  for (int c = bounds[t]; c < c1; ++c) {
    clogT[(size_t)c * kPixels + p] = logT;
    cdone[(size_t)c * kPixels + p] = done ? 1.f : 0.f;
    // Skip a chunk whose tile has terminated everywhere (pixels outside
    // the image never contribute, so they count as done here).
    if (__syncthreads_and(done || !inside)) {
      for (int k = p; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
      continue;
    }
    const size_t base = (size_t)c * chunk;
    stage_rows(s_geom, geom, kGeomRows, I, base, chunk, p);
    stage_rows(s_vals, vals, V, I, base, chunk, p);
    for (int i = p; i < kWarps * chunk; i += kPixels) s_obs[i] = 0;
    __syncthreads();

    // The JAX package's recurrence, term for term (blend_common.cuh).
    const float logT0 = logT;
    float cum = 0.f, contributed = 0.f;
    for (int k = 0; k < chunk; ++k) {
      // A warp whose inside pixels are all done adds nothing more; its
      // remaining observe entries stay 0.
      if (__all_sync(0xffffffffu, done || !inside)) break;
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
      const unsigned votes = __ballot_sync(0xffffffffu, seen);
      if (lane == 0) s_obs[warp * chunk + k] = __popc(votes);
    }
    logT = logT0 + contributed;
    __syncthreads();
    for (int k = p; k < chunk; k += kPixels) {
      int n = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) n += s_obs[w * chunk + k];
      obs[(size_t)c * chunk + k] = n;
    }
    __syncthreads();  // shared tables are refilled by the next chunk
  }

  fT[(size_t)t * kPixels + p] = expf(logT);
#pragma unroll
  for (int v = 0; v < V; ++v) img[((size_t)t * V + v) * kPixels + p] = acc[v];
}

template <int V>
cudaError_t launch(const float* geom, const float* vals, const int* bounds,
                   float* img, float* fT, float* clogT, float* cdone, int* obs,
                   int T, int n_chunks, int chunk, int grid_x, int width,
                   int height, float log_eps, float log_half, float alpha_min,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(kGeomRows + V + kWarps) * chunk * sizeof(float);
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
