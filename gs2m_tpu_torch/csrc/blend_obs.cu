// K3: observe-only tiled blend sweep on Hopper (sm_90a).
//
// Replaces gs2m_tpu/ops/blend_pallas.py::_obs_kernel (launched by
// observe_tiles_pallas). The design note, the bound and the plain PyTorch
// version that this kernel is held against are in
// gs2m_tpu_torch/ops/blend.py.
//
// K1's per-instance loop (csrc/blend_fwd.cu) without values, image, final T
// or carries: one block per 16x16 tile, one thread per pixel, the tile's
// chunk range walked in order with the same step (blend_common.cuh) and the
// same build flags, so the per-instance counts of contributing pixels with
// T > 0.5 are bit-identical to K1's. Counts are a per-warp
// __ballot_sync/__popc into a shared [8][chunk] table summed in fixed order.
// Blocks past the last tile zero the dummy tile's padding chunks. Plain C
// interface, loaded with ctypes; the entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gs2m;

__global__ void __launch_bounds__(kPixels)
blend_obs_kernel(const float* __restrict__ geom,      // (8, I)
                 const int* __restrict__ bounds,      // (T+1,) first chunk per tile
                 int* __restrict__ obs,               // (n_chunks, chunk)
                 int T, int n_chunks, int chunk, int grid_x, int width,
                 int height, float log_eps, float log_half, float alpha_min) {
  extern __shared__ float smem[];
  const int p = threadIdx.x;
  const size_t I = (size_t)n_chunks * chunk;

  if ((int)blockIdx.x >= T) {
    for (int c = bounds[T] + (int)blockIdx.x - T; c < n_chunks;
         c += gridDim.x - T) {
      for (int k = p; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
    }
    return;
  }

  float* s_geom = smem;                                         // [6][chunk]
  int* s_obs = reinterpret_cast<int*>(s_geom + kGeomRows * chunk);  // [warps][chunk]

  const int t = blockIdx.x;
  const int warp = p / 32, lane = p % 32;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);
  const bool inside = px < width && py < height;

  float logT = 0.f;
  bool done = false;
  const int c1 = bounds[t + 1];
  for (int c = bounds[t]; c < c1; ++c) {
    if (__syncthreads_and(done || !inside)) {
      for (int k = p; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
      continue;
    }
    stage_rows(s_geom, geom, kGeomRows, I, (size_t)c * chunk, chunk, p);
    for (int i = p; i < kWarps * chunk; i += kPixels) s_obs[i] = 0;
    __syncthreads();

    const float logT0 = logT;
    float cum = 0.f, contributed = 0.f;
    for (int k = 0; k < chunk; ++k) {
      if (__all_sync(0xffffffffu, done || !inside)) break;
      const Step st = walk_step(s_geom, chunk, k, px, py, inside, logT0,
                                log_eps, alpha_min, cum, done);
      bool seen = false;
      if (st.contribute) {
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
}

}  // namespace

extern "C" int gs2m_blend_obs(const void* geom, const void* bounds, void* obs,
                              int T, int n_chunks, int chunk, int grid_x,
                              int width, int height, float log_eps,
                              float log_half, float alpha_min, void* stream) {
  const size_t smem = (size_t)(kGeomRows + kWarps) * chunk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blend_obs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  blend_obs_kernel<<<T + kFillBlocks, kPixels, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const int*>(bounds),
      static_cast<int*>(obs), T, n_chunks, chunk, grid_x, width, height,
      log_eps, log_half, alpha_min);
  return (int)cudaGetLastError();
}
