// What K1 (blend_fwd.cu), K2 (blend_bwd.cu) and K3 (blend_obs.cu) share.
//
// walk_step: the per-(instance, pixel) step, the gated alpha and the
// log-space recurrence, term for term as the JAX package writes them
// (gs2m_tpu/ops/blend_pallas.py::_chunk_alpha_kernel and its callers). One
// copy keeps K3's observe counts bit-identical to K1's and K2's walks on K1's
// termination and gate edges. Built with expf/log1pf and -fmad=false.
//
// cull_rect / build_cull_masks: the exact warp cull of K1, K2 and K3. Outside an
// instance's pixel rectangle op * exp(power) < 1/255, so the gate is closed
// there, alpha is 0 and the step adds log1pf(-0) = -0 to the running sum and
// changes nothing else. A warp skips every instance whose rectangle misses
// its 8x4 pixel block. ops/blend.py::cull_rects is the PyTorch twin.
//
// stage_rows_async: cp.async copies of a chunk's rows into shared memory (K1
// loads the next chunk with them while it walks this one; K2 and K3 stage
// the chunk they are about to walk).
//
// warp_reduce_scatter: the warp sum of N channels in N - 1 shuffles: at each
// step a lane sends half of its channels to its partner and keeps the other
// half, so lane l ends with the sum of channel l / (32 / N).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gs2m {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kWarps = kPixels / 32;
constexpr int kGeomRows = 6;            // mx, my, conic a, b, c, opacity
constexpr int kFillBlocks = 264;        // 2 per SM on an H100
constexpr int kMaxWords = 1024 / 32;    // 32-instance words of the largest chunk
constexpr unsigned kFull = 0xffffffffu;

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
// [rows][chunk] as 16-byte cp.async transfers (chunk is a multiple of 32 and
// the tables are 16-byte aligned, so every row of a chunk is). The caller
// commits the group and waits for it.
__device__ __forceinline__ void stage_rows_async(float* dst, const float* src,
                                                 int rows, size_t I,
                                                 size_t base, int chunk,
                                                 int p) {
  const int q = chunk / 4;  // 16-byte vectors per row
  for (int i = p; i < rows * q; i += kPixels) {
    const int r = i / q, j = i - r * q;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r * chunk + 4 * j));
    const float* s = src + r * I + base + 4 * j;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(s));
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K1, K2 and K3 map a warp to an 8x4 pixel block (the tile's 8 warps as 2
// columns by 4 rows), a squarer block than 16x2 with a shorter perimeter for
// the cull. Pixel index p = y * 16 + x indexes every per-pixel table.
__device__ __forceinline__ int warp_block_x(int warp) { return (warp & 1) * 8; }
__device__ __forceinline__ int warp_block_y(int warp) { return (warp >> 1) * 4; }
__device__ __forceinline__ int pixel_of_thread(int tid) {
  const int warp = tid / 32, lane = tid % 32;
  return (warp_block_y(warp) + lane / 8) * kTile + warp_block_x(warp) + lane % 8;
}

struct Rect {
  float x0, x1, y0, y1;  // closed pixel-coordinate bounds
};

// The conservative pixel rectangle outside which walk_step's gate is closed
// for this instance. With Q = a dx^2 + 2b dx dy + c dy^2, the gate needs
// op * exp(-Q/2) >= alpha_min, so Q <= q = 2 ln(op / alpha_min). The f32 Q
// of walk_step is within gamma * (a dx^2 + c dy^2 + 2|b dx dy|) of the exact
// one (~6 roundings; gamma = 1e-6 is ~17 f32 ulps), so every pixel the gate
// admits lies in {a(1-g) dx^2 + c(1-g) dy^2 - 2|b|(1+g)|dx dy| <= q}, whose
// half-extents are sqrt(q c'/det') and sqrt(q a'/det'). Computed in double
// (exact products of the f32 inputs), then widened by 1e-3 on q (exp/log
// rounding) and 1 px (the cast back to f32). op < alpha_min: empty (the
// gate never opens); a non-finite input, or a form that is not positive
// definite after the widening: no cull.
__device__ __forceinline__ Rect cull_rect(float mx, float my, float a, float b,
                                          float c, float op, float alpha_min) {
  if (op < alpha_min) return Rect{INFINITY, -INFINITY, INFINITY, -INFINITY};
  const double g = 1e-6;
  const double A = (double)a * (1.0 - g), C = (double)c * (1.0 - g);
  const double B = fabs((double)b) * (1.0 + g);
  const double det = A * C - B * B;
  const double q = fmax(2.0 * log((double)op / (double)alpha_min), 0.0) + 1e-3;
  const double ex = sqrt(q * C / det) + 1.0;
  const double ey = sqrt(q * A / det) + 1.0;
  if (!(det > 0.0) || !(A > 0.0) || !isfinite(ex) || !isfinite(ey) ||
      !isfinite(mx) || !isfinite(my)) {
    return Rect{-INFINITY, INFINITY, -INFINITY, INFINITY};
  }
  return Rect{(float)(mx - ex), (float)(mx + ex), (float)(my - ey),
              (float)(my + ey)};
}

// Per-warp cull masks of the chunk staged in s_geom: bit j of
// masks[w * kMaxWords + i] is set when instance 32 i + j may reach a pixel
// of warp w's block in tile (tx0, ty0). Every thread takes instances
// p, p + 256, ...; one ballot per target warp packs 32 of them. The caller
// synchronizes the block before reading the masks.
__device__ __forceinline__ void build_cull_masks(const float* s_geom,
                                                 int chunk, float tx0,
                                                 float ty0, float alpha_min,
                                                 unsigned* masks, int tid) {
  const int lane = tid % 32;
  for (int k = tid; k < chunk; k += kPixels) {  // warp-uniform: chunk % 32 == 0
    const Rect r = cull_rect(s_geom[k], s_geom[chunk + k],
                             s_geom[2 * chunk + k], s_geom[3 * chunk + k],
                             s_geom[4 * chunk + k], s_geom[5 * chunk + k],
                             alpha_min);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x0 = tx0 + warp_block_x(w), y0 = ty0 + warp_block_y(w);
      const bool hit = r.x1 >= x0 && r.x0 <= x0 + 7.f && r.y1 >= y0 &&
                       r.y0 <= y0 + 3.f;
      const unsigned word = __ballot_sync(kFull, hit);
      if (lane == 0) masks[w * kMaxWords + k / 32] = word;
    }
  }
}

// Warp sum of x[0..N) (N a power of two, 2 <= N <= 32): halving steps over
// lane offsets 16, 8, ... then butterflies on the last value. Returns the
// sum of channel lane / (32 / N); lanes with lane % (32 / N) == 0 hold each
// channel once. The order is fixed, so reruns are bit-equal.
template <int n, int off, int N>
__device__ __forceinline__ void halve_channels(float (&x)[N], int lane) {
  if constexpr (n > 1) {
    const bool hi = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = hi ? x[i] : x[i + n / 2];
      const float keep = hi ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
    halve_channels<n / 2, off / 2, N>(x, lane);
  }
}

template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&x)[N], int lane) {
  static_assert(N >= 2 && N <= 32 && (N & (N - 1)) == 0, "N: 2, 4, ..., 32");
  halve_channels<N, 16, N>(x, lane);
#pragma unroll
  for (int off = 16 / N; off > 0; off /= 2) {
    x[0] += __shfl_xor_sync(kFull, x[0], off);
  }
  return x[0];
}

}  // namespace gs2m
