// The per-(instance, pixel) step shared by K1 (blend_fwd.cu), K2
// (blend_bwd.cu) and K3 (blend_obs.cu): the gated alpha and the log-space
// recurrence, term for term as the JAX package writes them
// (gs2m_tpu/ops/blend_pallas.py::_chunk_alpha_kernel and its callers).
// One copy keeps K3's observe counts bit-identical to K1's and K2's walks on
// K1's termination and gate edges. Built with expf/log1pf and -fmad=false.
#pragma once

#include <cuda_runtime.h>

namespace gs2m {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kWarps = kPixels / 32;
constexpr int kGeomRows = 6;            // mx, my, conic a, b, c, opacity
constexpr int kFillBlocks = 264;        // 2 per SM on an H100

struct Step {
  float dx, dy;     // mean minus pixel
  float G;          // exp(min(power, 0))
  float alpha;      // min(.99, op*G), 0 where gated out
  float log1m;      // log1p(-alpha)
  float test;       // logT0 + running sum of log1m
  float logT_excl;  // test - log1m: transmittance before this instance
  bool contribute;  // alpha > 0 and the pixel not done
};

// Instance k of the chunk staged in s_geom ([6][chunk]) at pixel (px, py).
// Adds log1m to the running sum `cum` and latches `done` once the
// transmittance falls below exp(log_eps).
__device__ __forceinline__ Step walk_step(const float* s_geom, int chunk,
                                          int k, float px, float py,
                                          bool inside, float logT0,
                                          float log_eps, float alpha_min,
                                          float& cum, bool& done) {
  Step s;
  s.dx = s_geom[k] - px;
  s.dy = s_geom[chunk + k] - py;
  const float ca = s_geom[2 * chunk + k];
  const float cb = s_geom[3 * chunk + k];
  const float cc = s_geom[4 * chunk + k];
  const float op = s_geom[5 * chunk + k];
  const float power_raw =
      -0.5f * (ca * s.dx * s.dx + cc * s.dy * s.dy) - cb * s.dx * s.dy;
  s.G = expf(fminf(power_raw, 0.f));
  const float alpha = fminf(0.99f, op * s.G);
  const bool gate = power_raw <= 0.f && alpha >= alpha_min && inside;
  s.alpha = gate ? alpha : 0.f;
  s.log1m = log1pf(-s.alpha);
  cum += s.log1m;
  s.test = logT0 + cum;
  done = done || s.test < log_eps;
  s.logT_excl = s.test - s.log1m;
  s.contribute = s.alpha > 0.f && !done;
  return s;
}

// Stage rows [0, rows) of chunk c of a (rows_total, I) table into shared
// [rows][chunk].
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, size_t I, size_t base,
                                           int chunk, int p) {
  for (int i = p; i < rows * chunk; i += kPixels) {
    const int r = i / chunk;
    dst[i] = src[r * I + base + (i - r * chunk)];
  }
}

}  // namespace gs2m
