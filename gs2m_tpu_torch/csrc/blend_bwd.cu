// K2: backward tiled alpha blend on Hopper (sm_90a).
//
// Replaces gs2m_tpu/ops/blend_pallas.py::_bwd_kernel (launched by
// _run_backward). The design note, the bound and the plain PyTorch version
// that this kernel is held against are in gs2m_tpu_torch/ops/blend.py.
//
// One block per 16x16 tile, one thread per pixel, each warp an 8x4 pixel
// block. The block walks its tile's contiguous chunk range
// [bounds[t], bounds[t+1]) BACKWARDS from K1's saved chunk-start carries
// (logT, done), carrying the pixel's suffix accumulator S = fT*gT + sum of
// later w*u and its V cotangents in registers. Each chunk is walked forward
// twice with K1's step (blend_common.cuh): pass 1 sums total = sum w*u, pass
// 2 keeps the inclusive prefix and emits the per-pixel gradient terms. The
// kernel is bound by instructions (the steps' expf/log1pf and the per-
// instance sums over 256 pixels), not bytes, so:
//  - exact warp cull: pass 1 walks only the instances whose conservative
//    rectangle (cull_rect) meets the warp's block, and records in a bit mask
//    the instances where some lane of the warp had alpha > 0 before it was
//    done. Pass 2 walks only those: at every other instance each live lane
//    has alpha 0 and the step changes nothing, and a done lane never
//    contributes again;
//  - the per-instance sums: a warp whose lanes do not contribute issues no
//    shuffle and is left out of the block sum; otherwise its 8+V channels are
//    reduced in one transposed reduce-scatter (15 shuffles at V=8, 25 at V=16
//    as 16 + 8 channels, against 80 and 120 for one butterfly per channel),
//    and the 8 warps' partials are summed in fixed order through shared
//    memory, 32 instances at a time, double-buffered so one barrier per 32
//    instances suffices. No atomics: two runs are bit-equal;
//  - staging: the chunk's geometry and values go to one shared buffer with
//    16-byte cp.async copies. A second buffer, loading the next chunk while
//    this one is walked, measured no faster at chunk 256 (PERF.md): the other
//    resident blocks (3 per SM at V=8, 2 at V=16) already hide the loads.
// Blocks past the last tile zero the dummy tile's padding chunks. Plain C
// interface, loaded with ctypes; the entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gs2m;

constexpr int kBatch = 32;              // instances per block sum (one mask word)

// Reduce the warp's K = 8+V channels and store lane-held sums into
// part[channel * kBatch] (part already offset by the instance).
template <int V>
__device__ __forceinline__ void reduce_channels(float (&ch)[8 + V], int lane,
                                                float* part) {
  if constexpr (V == 8) {
    const float s = warp_reduce_scatter<16>(ch, lane);
    if ((lane & 1) == 0) part[(lane >> 1) * kBatch] = s;
  } else {
    float lo[16], hi[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) lo[i] = ch[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) hi[i] = ch[16 + i];
    const float a = warp_reduce_scatter<16>(lo, lane);
    const float b = warp_reduce_scatter<8>(hi, lane);
    if ((lane & 1) == 0) part[(lane >> 1) * kBatch] = a;
    if ((lane & 3) == 0) part[(16 + (lane >> 2)) * kBatch] = b;
  }
}

template <int V>
__global__ void __launch_bounds__(kPixels, 2)
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
  const int tid = threadIdx.x;
  const size_t I = (size_t)n_chunks * chunk;

  if ((int)blockIdx.x >= T) {
    // The dummy tile T: its padding chunks carry opacity 0 and a zero
    // cotangent, so every gradient there is 0.
    for (int c = bounds[T] + (int)blockIdx.x - T; c < n_chunks;
         c += gridDim.x - T) {
      const size_t base = (size_t)c * chunk;
      for (int k = tid; k < chunk; k += kPixels) {
        for (int r = 0; r < 8; ++r) dgeom[r * I + base + k] = 0.f;
        for (int v = 0; v < V; ++v) dvals[v * I + base + k] = 0.f;
      }
    }
    return;
  }

  float* s_geom = smem;                                       // [6][chunk]
  float* s_vals = s_geom + kGeomRows * chunk;                 // [V][chunk]
  float* s_part = s_vals + V * chunk;                         // [2][warps][K][kBatch]
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(s_part + 2 * kWarps * K * kBatch);  // [warps][kMaxWords]
  unsigned* s_act = s_mask + kWarps * kMaxWords;              // [warps][kMaxWords]
  unsigned* s_used = s_act + kWarps * kMaxWords;              // [2][warps]

  const int t = blockIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int p = pixel_of_thread(tid);
  const float tx0 = (float)((t % grid_x) * kTile);
  const float ty0 = (float)((t / grid_x) * kTile);
  const float px = tx0 + (float)(p % kTile);
  const float py = ty0 + (float)(p / kTile);
  const bool inside = px < width && py < height;
  const int words = chunk / 32;

  float g[V];
#pragma unroll
  for (int v = 0; v < V; ++v) g[v] = g_img[((size_t)t * V + v) * kPixels + p];
  float S = fT[(size_t)t * kPixels + p] * gT[(size_t)t * kPixels + p];

  const int c0 = bounds[t], c1 = bounds[t + 1];
  int half = 0;  // which half of s_part / s_used the next batch fills
  for (int c = c1 - 1; c >= c0; --c) {
    const size_t base = (size_t)c * chunk;
    const float logT0 = clogT[(size_t)c * kPixels + p];
    const bool done0 = cdone[(size_t)c * kPixels + p] > 0.f;
    // The buffer was last read before the previous chunk's final barrier.
    stage_rows_async(s_geom, geom, kGeomRows, I, base, chunk, tid);
    stage_rows_async(s_vals, vals, V, I, base, chunk, tid);
    async_commit();
    async_wait<0>();
    // A chunk whose tile had terminated everywhere at its start has all
    // weights 0 (pixels outside the image never contribute): zeros, and S
    // is unchanged. The barrier also publishes the staged rows.
    if (__syncthreads_and(done0 || !inside)) {
      for (int k = tid; k < chunk; k += kPixels) {
        for (int r = 0; r < 8; ++r) dgeom[r * I + base + k] = 0.f;
        for (int v = 0; v < V; ++v) dvals[v * I + base + k] = 0.f;
      }
      continue;
    }
    build_cull_masks(s_geom, chunk, tx0, ty0, alpha_min, s_mask, tid);
    __syncthreads();

    // Pass 1: total = sum over the chunk of w*u, u = g . v, and the mask of
    // instances that change some live lane of this warp.
    float cum = 0.f, total = 0.f;
    bool done = done0;
    bool fin = false;
    for (int j = 0; j < words; ++j) {
      unsigned act = 0;
      for (unsigned m = fin ? 0u : s_mask[warp * kMaxWords + j]; m != 0;
           m &= m - 1) {
        if (__all_sync(kFull, done || !inside)) {
          fin = true;
          break;
        }
        const int b = __ffs(m) - 1, k = 32 * j + b;
        const bool live = !done;
        const Step st = walk_step(s_geom, chunk, k, px, py, inside, logT0,
                                  log_eps, alpha_min, cum, done);
        if (__any_sync(kFull, live && st.alpha > 0.f)) act |= 1u << b;
        if (st.contribute) {
          const float w = st.alpha * expf(st.logT_excl);
          float u = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) u += s_vals[v * chunk + k] * g[v];
          total += w * u;
        }
      }
      if (lane == 0) s_act[warp * kMaxWords + j] = act;
    }
    __syncwarp();
#ifdef GS2M_BWD_PASS1_ONLY
    // A timing probe's build (chip_smoke.py): stop after pass 1 and write
    // no gradients, to weigh pass 1's share of the kernel.
    S = S + total;
    __syncthreads();
    continue;
#endif

    // Pass 2: the same walk over the marked instances with the inclusive
    // prefix of w*u; per-pixel gradient terms, summed per instance over
    // the tile, one 32-instance word at a time.
    const float S_tot = S + total;
    float prefix = 0.f;
    cum = 0.f;
    done = done0;
    for (int j = 0; j < words; ++j) {
      float* part = s_part + ((size_t)half * kWarps + warp) * K * kBatch;
      unsigned used = 0;
      for (unsigned m = s_act[warp * kMaxWords + j]; m != 0; m &= m - 1) {
        const int b = __ffs(m) - 1, k = 32 * j + b;
        const Step st = walk_step(s_geom, chunk, k, px, py, inside, logT0,
                                  log_eps, alpha_min, cum, done);
        if (!__any_sync(kFull, st.contribute)) continue;  // all terms are 0
        used |= 1u << b;
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
        reduce_channels<V>(ch, lane, part + b);
      }
      if (lane == 0) s_used[half * kWarps + warp] = used;
      __syncthreads();
      // Fixed-order sum of the warps that contributed. The other half of
      // s_part is filled by the next word meanwhile: the barrier above
      // orders this word's reads of it before that.
      const float* ps = s_part + (size_t)half * kWarps * K * kBatch;
      const unsigned* us = s_used + half * kWarps;
      for (int idx = tid; idx < K * kBatch; idx += kPixels) {
        const int i = idx / kBatch, b = idx % kBatch;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if ((us[w] >> b) & 1u) s += ps[((size_t)w * K + i) * kBatch + b];
        }
        const size_t col = base + 32 * j + b;
        if (i < 8) {
          dgeom[i * I + col] = s;
        } else {
          dvals[(i - 8) * I + col] = s;
        }
      }
      half ^= 1;
    }
    S = S_tot;
    // Every walk of this chunk's rows ended before the last word's barrier;
    // the last word's sums read only s_part's other half. One more barrier
    // so the next chunk's masks and staging do not overwrite what a slow
    // thread still reads.
    __syncthreads();
  }
}

template <int V>
size_t smem_bytes(int chunk) {
  return ((size_t)(kGeomRows + V) * chunk
          + (size_t)2 * kWarps * (8 + V) * kBatch
          + (size_t)2 * kWarps * kMaxWords + 2 * kWarps) * 4;
}

template <int V>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(blend_bwd_kernel<V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int V>
cudaError_t launch(const float* geom, const float* vals, const int* bounds,
                   const float* clogT, const float* cdone, const float* g_img,
                   const float* gT, const float* fT, float* dgeom, float* dvals,
                   int T, int n_chunks, int chunk, int grid_x, int width,
                   int height, float log_eps, float alpha_min,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<V>(chunk);
  cudaError_t e = set_smem<V>(smem);
  if (e != cudaSuccess) return e;
  blend_bwd_kernel<V><<<T + kFillBlocks, kPixels, smem, stream>>>(
      geom, vals, bounds, clogT, cdone, g_img, gT, fT, dgeom, dvals, T,
      n_chunks, chunk, grid_x, width, height, log_eps, alpha_min);
  return cudaGetLastError();
}

template <int V>
cudaError_t info(int chunk, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, blend_bwd_kernel<V>);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<V>(chunk);
  if ((e = set_smem<V>(smem)) != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_bwd_kernel<V>, kPixels, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return e;
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
  if ((reinterpret_cast<size_t>(geom) | reinterpret_cast<size_t>(vals)) % 16) {
    return (int)cudaErrorMisalignedAddress;  // cp.async moves 16-byte vectors
  }
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

// Registers per thread, local (spill) bytes per thread, dynamic shared
// bytes and resident blocks per SM of the kernel at (V, chunk), into
// out[0..4).
extern "C" int gs2m_blend_bwd_info(int V, int chunk, int* out) {
  if (V == 8) return (int)info<8>(chunk, out);
  if (V == 16) return (int)info<16>(chunk, out);
  return (int)cudaErrorInvalidValue;
}
