// K2: backward tiled alpha blend on Hopper (sm_90a).
//
// Replaces gs2m_tpu/ops/blend_pallas.py::_bwd_kernel (launched by
// _run_backward). The design note, the bound and the plain PyTorch version
// that this kernel is held against are in gs2m_tpu_torch/ops/blend.py.
//
// One block per 16x16 tile, one thread per pixel. The block walks its
// tile's contiguous chunk range [bounds[t], bounds[t+1]) BACKWARDS from K1's
// saved chunk-start carries (logT, done), carrying the pixel's suffix
// accumulator S = fT*gT + sum of later w*u and its V cotangents in
// registers. Each chunk is walked forward twice with K1's step
// (blend_common.cuh): pass 1 sums total = sum w*u, pass 2 keeps the
// inclusive prefix and emits the per-pixel gradient terms. Per-instance
// outputs are sums over
// the tile's 256 pixels: a warp-shuffle sum per channel, then a fixed-order
// sum over the 8 warps through shared memory, 32 instances at a time. No
// atomics, so two runs are bit-equal. Blocks past the last tile zero the
// dummy tile's padding chunks. Plain C interface, loaded with ctypes; the
// entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gs2m;

constexpr int kBatch = 32;              // instances reduced per shared pass
constexpr unsigned kFull = 0xffffffffu;

template <int V>
__global__ void __launch_bounds__(kPixels)
blend_bwd_kernel(const float* __restrict__ geom,      // (8, I)
                 const float* __restrict__ vals,      // (V, I)
                 const int* __restrict__ bounds,      // (T+1,) first chunk per tile
                 const float* __restrict__ clogT,     // (n_chunks, P)
                 const float* __restrict__ cdone,     // (n_chunks, P)
                 const float* __restrict__ g_img,     // (T+1, V, P)
                 const float* __restrict__ gT,        // (T+1, P)
                 const float* __restrict__ fT,        // (T+1, P)
                 float* __restrict__ dgeom,           // (8, I)
                 float* __restrict__ dvals,           // (V, I)
                 int T, int n_chunks, int chunk, int grid_x, int width,
                 int height, float log_eps, float alpha_min) {
  constexpr int K = 8 + V;  // output channels per instance
  extern __shared__ float smem[];
  const int p = threadIdx.x;
  const size_t I = (size_t)n_chunks * chunk;

  if ((int)blockIdx.x >= T) {
    // The dummy tile T: its padding chunks carry opacity 0 and a zero
    // cotangent, so every gradient there is 0.
    for (int c = bounds[T] + (int)blockIdx.x - T; c < n_chunks;
         c += gridDim.x - T) {
      const size_t base = (size_t)c * chunk;
      for (int k = p; k < chunk; k += kPixels) {
        for (int r = 0; r < 8; ++r) dgeom[r * I + base + k] = 0.f;
        for (int v = 0; v < V; ++v) dvals[v * I + base + k] = 0.f;
      }
    }
    return;
  }

  float* s_geom = smem;                       // [6][chunk]
  float* s_vals = s_geom + kGeomRows * chunk;  // [V][chunk]
  float* s_part = s_vals + V * chunk;          // [warps][K][kBatch]

  const int t = blockIdx.x;
  const int warp = p / 32, lane = p % 32;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);
  const bool inside = px < width && py < height;

  float g[V];
#pragma unroll
  for (int v = 0; v < V; ++v) g[v] = g_img[((size_t)t * V + v) * kPixels + p];
  float S = fT[(size_t)t * kPixels + p] * gT[(size_t)t * kPixels + p];

  const int c0 = bounds[t];
  for (int c = bounds[t + 1] - 1; c >= c0; --c) {
    const size_t base = (size_t)c * chunk;
    const float logT0 = clogT[(size_t)c * kPixels + p];
    const bool done0 = cdone[(size_t)c * kPixels + p] > 0.f;
    // A chunk whose tile had terminated everywhere at its start has all
    // weights 0 (pixels outside the image never contribute): zeros, and S
    // is unchanged.
    if (__syncthreads_and(done0 || !inside)) {
      for (int k = p; k < chunk; k += kPixels) {
        for (int r = 0; r < 8; ++r) dgeom[r * I + base + k] = 0.f;
        for (int v = 0; v < V; ++v) dvals[v * I + base + k] = 0.f;
      }
      continue;
    }
    stage_rows(s_geom, geom, kGeomRows, I, base, chunk, p);
    stage_rows(s_vals, vals, V, I, base, chunk, p);
    __syncthreads();

    // Pass 1: total = sum over the chunk of w*u, u = g . v.
    float cum = 0.f, total = 0.f;
    bool done = done0;
    for (int k = 0; k < chunk; ++k) {
      if (__all_sync(kFull, done || !inside)) break;
      const Step st = walk_step(s_geom, chunk, k, px, py, inside, logT0,
                                log_eps, alpha_min, cum, done);
      if (st.contribute) {
        const float w = st.alpha * expf(st.logT_excl);
        float u = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) u += s_vals[v * chunk + k] * g[v];
        total += w * u;
      }
    }

    // Pass 2: the same walk with the inclusive prefix of w*u; per-pixel
    // gradient terms, reduced per instance over the tile.
    const float S_tot = S + total;
    float prefix = 0.f;
    cum = 0.f;
    done = done0;
    for (int kb = 0; kb < chunk; kb += kBatch) {
      for (int j = 0; j < kBatch; ++j) {
        const int k = kb + j;
        float* part = s_part + (size_t)warp * K * kBatch + j;
        if (__all_sync(kFull, done || !inside)) {
          // Nothing of this warp contributes any more.
          if (lane == 0) {
#pragma unroll
            for (int i = 0; i < K; ++i) part[i * kBatch] = 0.f;
          }
          continue;
        }
        const Step st = walk_step(s_geom, chunk, k, px, py, inside, logT0,
                                  log_eps, alpha_min, cum, done);
        const float dx = st.dx, dy = st.dy, G = st.G;
        const float ca = s_geom[2 * chunk + k];
        const float cb = s_geom[3 * chunk + k];
        const float cc = s_geom[4 * chunk + k];
        float w = 0.f, dalpha = 0.f;
        if (st.contribute) {
          const float T_excl = expf(st.logT_excl);
          w = st.alpha * T_excl;
          float u = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) u += s_vals[v * chunk + k] * g[v];
          prefix += w * u;
          const float S_after = S_tot - prefix;
          dalpha = T_excl * u - S_after / (1.f - st.alpha);
          // The 0.99 clamp has no gradient.
          if (!(s_geom[5 * chunk + k] * G < 0.99f)) dalpha = 0.f;
        }
        const float dpower = st.alpha * dalpha;
        const float ddx = -(ca * dx + cb * dy) * dpower;
        const float ddy = -(cc * dy + cb * dx) * dpower;
        float ch[K];
        ch[0] = ddx;
        ch[1] = ddy;
        ch[2] = -0.5f * dx * dx * dpower;
        ch[3] = -dx * dy * dpower;
        ch[4] = -0.5f * dy * dy * dpower;
        ch[5] = G * dalpha;
        ch[6] = fabsf(ddx);
        ch[7] = fabsf(ddy);
#pragma unroll
        for (int v = 0; v < V; ++v) ch[8 + v] = w * g[v];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          float x = ch[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
          if (lane == 0) part[i * kBatch] = x;
        }
      }
      __syncthreads();
      for (int idx = p; idx < K * kBatch; idx += kPixels) {
        const int i = idx / kBatch, j = idx % kBatch;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_part[((size_t)w * K + i) * kBatch + j];
        if (i < 8) {
          dgeom[i * I + base + kb + j] = s;
        } else {
          dvals[(i - 8) * I + base + kb + j] = s;
        }
      }
      __syncthreads();  // s_part is refilled by the next batch
    }
    S = S_tot;
  }
}

template <int V>
cudaError_t launch(const float* geom, const float* vals, const int* bounds,
                   const float* clogT, const float* cdone, const float* g_img,
                   const float* gT, const float* fT, float* dgeom, float* dvals,
                   int T, int n_chunks, int chunk, int grid_x, int width,
                   int height, float log_eps, float alpha_min,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)(kGeomRows + V) * chunk
                       + (size_t)kWarps * (8 + V) * kBatch) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blend_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  blend_bwd_kernel<V><<<T + kFillBlocks, kPixels, smem, stream>>>(
      geom, vals, bounds, clogT, cdone, g_img, gT, fT, dgeom, dvals, T,
      n_chunks, chunk, grid_x, width, height, log_eps, alpha_min);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gs2m_blend_bwd(const void* geom, const void* vals,
                              const void* bounds, const void* clogT,
                              const void* cdone, const void* g_img,
                              const void* gT, const void* fT, void* dgeom,
                              void* dvals, int T, int n_chunks, int chunk,
                              int V, int grid_x, int width, int height,
                              float log_eps, float alpha_min, void* stream) {
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const auto bo = static_cast<const int*>(bounds);
  const auto dg = static_cast<float*>(dgeom);
  const auto dv = static_cast<float*>(dvals);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (V == 8) {
    e = launch<8>(f(geom), f(vals), bo, f(clogT), f(cdone), f(g_img), f(gT),
                  f(fT), dg, dv, T, n_chunks, chunk, grid_x, width, height,
                  log_eps, alpha_min, s);
  } else if (V == 16) {
    e = launch<16>(f(geom), f(vals), bo, f(clogT), f(cdone), f(g_img), f(gT),
                   f(fT), dg, dv, T, n_chunks, chunk, grid_x, width, height,
                   log_eps, alpha_min, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
