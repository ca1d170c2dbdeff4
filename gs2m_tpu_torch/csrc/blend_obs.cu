// K3: observe-only tiled blend sweep on Hopper (sm_90a).
//
// Replaces gs2m_tpu/ops/blend_pallas.py::_obs_kernel (launched by
// observe_tiles_pallas). The design note, the bound and the plain PyTorch
// version that this kernel is held against are in
// gs2m_tpu_torch/ops/blend.py.
//
// K3's only output is, per instance, the count of contributing pixels whose
// transmittance before the instance is above 0.5. One block per 16x16 tile,
// one thread per pixel, each warp an 8x4 pixel block; the tile's chunk range
// is walked in order with K1's step (blend_common.cuh) and build flags, so the
// counts are bit-identical to K1's obs. The kernel is bound by the
// instructions of that step, so it walks only the steps that can still
// change a count:
//  - retirement: a pixel whose running test = logT0 + cum has fallen below
//    log_retire = LOG_HALF - RETIRE_MARGIN after a walked step is retired. A
//    warp stops walking once all its pixels are retired (pixels outside the
//    image are retired from the start, and termination retires a pixel
//    too), and a tile whose pixels are all retired writes zeros for the
//    rest of its chunks and stages nothing more;
//  - exact warp cull (K1's): each warp walks only the instances whose
//    conservative rectangle meets its block (elsewhere alpha is 0 at every
//    lane and the step adds -0);
//  - staging: a chunk's 6 geometry rows are copied into one shared buffer
//    with cp.async once the tile is known to have a pixel left to count. A
//    second buffer that loads the next chunk while this one is walked
//    measured no faster (PERF.md): the next chunk is often skipped, and the
//    3 resident blocks per SM hide the copies;
//  - counts: a ballot and popc per walked instance into a shared [8][chunk]
//    table (written only where a lane votes), summed in fixed order.
//
// Why retirement is exact. log1pf(-alpha) <= 0, so within a chunk the f32
// running sum cum never rises (a rounded sum with a non-positive term is at
// most the old sum), and neither does test = fl(logT0 + cum). At a later
// step k, logT_excl_k = fl(fl(logT0 + fl(cum_{k-1} + l_k)) - l_k) is within a
// few roundings of test_{k-1}; while the pixel is not done every magnitude
// is below ~14 (test >= log 1e-4 = -9.2, l_k >= log 0.01 = -4.6), so the error
// is below 4e-6, far under the 1e-4 margin: logT_excl_k < LOG_HALF and the
// step is not counted. Across chunks the carried logT0 + contributed equals
// the last walked test exactly while the pixel is not done (its steps with
// alpha 0 add -0 to cum, and every other step contributes), so the next
// chunk's first logT_excl is again within a few roundings of it. A pixel's
// carry goes stale only when its warp stops walking, which happens only
// once every pixel of the warp is retired, so a stale carry is never walked
// again. A done pixel never contributes; termination implies test < log_eps
// < log_retire, so it is retired at the same step.
//
// Blocks past the last tile zero the dummy tile's padding chunks. Plain C
// interface, loaded with ctypes; the entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gs2m;

__global__ void __launch_bounds__(kPixels, 2)
blend_obs_kernel(const float* __restrict__ geom,      // (8, I)
                 const int* __restrict__ bounds,      // (T+1,) first chunk per tile
                 int* __restrict__ obs,               // (n_chunks, chunk)
                 int T, int n_chunks, int chunk, int grid_x, int width,
                 int height, float log_eps, float log_half, float log_retire,
                 float alpha_min) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t I = (size_t)n_chunks * chunk;

  if ((int)blockIdx.x >= T) {
    for (int c = bounds[T] + (int)blockIdx.x - T; c < n_chunks;
         c += gridDim.x - T) {
      for (int k = tid; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
    }
    return;
  }

  float* s_geom = smem;                                      // [6][chunk]
  int* s_obs = reinterpret_cast<int*>(s_geom + kGeomRows * chunk);  // [warps][chunk]
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
  bool retired = !inside;
  const int c1 = bounds[t + 1];
  int c = bounds[t];
  for (; c < c1; ++c) {
    // The barrier also orders the previous chunk's reads of the staged
    // rows, s_obs and the masks before they are refilled.
    if (__syncthreads_and(retired)) break;
    stage_rows_async(s_geom, geom, kGeomRows, I, (size_t)c * chunk, chunk,
                     tid);
    async_commit();
    async_wait<0>();
    __syncthreads();
    build_cull_masks(s_geom, chunk, tx0, ty0, alpha_min, s_mask, tid);
    for (int i = tid; i < kWarps * chunk; i += kPixels) s_obs[i] = 0;
    __syncthreads();

    const float logT0 = logT;
    float cum = 0.f, contributed = 0.f;
    const unsigned* mask = s_mask + warp * kMaxWords;
    bool fin = false;
    for (int j = 0; j < words && !fin; ++j) {
      for (unsigned m = mask[j]; m != 0; m &= m - 1) {
        if (__all_sync(kFull, retired)) {
          fin = true;
          break;
        }
        const int k = 32 * j + __ffs(m) - 1;
        const Step st = walk_step(s_geom, chunk, k, px, py, inside, logT0,
                                  log_eps, alpha_min, cum, done);
        bool seen = false;
        if (st.contribute) {
          contributed += st.log1m;
          seen = st.logT_excl > log_half;
        }
        retired = retired || st.test < log_retire;
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
  }
  // Every pixel of the tile retired: its remaining chunks count nothing.
  for (; c < c1; ++c) {
    for (int k = tid; k < chunk; k += kPixels) obs[(size_t)c * chunk + k] = 0;
  }
}

size_t smem_bytes(int chunk) {
  return ((size_t)(kGeomRows + kWarps) * chunk + (size_t)kWarps * kMaxWords)
         * 4;
}

cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(blend_obs_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int gs2m_blend_obs(const void* geom, const void* bounds, void* obs,
                              int T, int n_chunks, int chunk, int grid_x,
                              int width, int height, float log_eps,
                              float log_half, float log_retire,
                              float alpha_min, void* stream) {
  if (reinterpret_cast<size_t>(geom) % 16) {
    return (int)cudaErrorMisalignedAddress;  // cp.async moves 16-byte vectors
  }
  const size_t smem = smem_bytes(chunk);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  blend_obs_kernel<<<T + kFillBlocks, kPixels, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const int*>(bounds),
      static_cast<int*>(obs), T, n_chunks, chunk, grid_x, width, height,
      log_eps, log_half, log_retire, alpha_min);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes per thread, dynamic shared
// bytes and resident blocks per SM of the kernel at `chunk`, into out[0..4).
// V is taken for the same signature as K1's and K2's entries and ignored.
extern "C" int gs2m_blend_obs_info(int V, int chunk, int* out) {
  (void)V;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, blend_obs_kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(chunk);
  e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blend_obs_kernel,
                                                    kPixels, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)e;
}
