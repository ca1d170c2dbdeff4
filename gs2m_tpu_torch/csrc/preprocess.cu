// The render's per-Gaussian preprocess on Hopper (sm_90a): one forward and
// one backward kernel, one thread per Gaussian row of the capacity C.
//
// Replaces the eager chain from the raw parameters to what render() hands to
// rasterize_from_projected: Gaussians.get_opacity, get_normals and
// get_covariance, ops/rasterize.py::build_features, ops/projection.py::
// project and compute_cov2d, and core/sh.py's SH colour (the JAX package's
// XLA code in gs2m_tpu/ops/projection.py, core/gaussians.py and core/sh.py;
// it has no Pallas kernel of its own). The design note, the bound and the
// plain PyTorch versions these kernels are held against are in
// gs2m_tpu_torch/ops/preprocess.py.
//
// The forward follows the plain code's formulas and operation order (built
// with -fmad=false, so each product and sum rounds where PyTorch's ops
// round). The backward recomputes the forward of its row from the inputs
// and maps the cotangents of opacities, features, means2d, conics and
// colors to the nine leaves' gradients with autograd's conventions at ties
// (torch.maximum halves the gradient, clamp passes it at its bounds, abs
// has gradient 0 at 0, where routes it to the chosen branch). Each row
// writes only its own gradients: no atomics. Plain C interface, loaded with
// ctypes; the entries return cudaGetLastError().
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// SH constants of core/sh.py, rounded to float32 as PyTorch rounds a
// Python scalar against a float32 tensor.
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

struct Leaves {
  const float* xyz;        // (C, 3)
  const float* f_dc;       // (C, 1, 3)
  const float* f_rest;     // (C, k_rest, 3)
  const float* scaling;    // (C, 3) log-scales
  const float* rotation;   // (C, 4) unnormalised quaternion (r, x, y, z)
  const float* opacity;    // (C, 1) logit
  const float* albedo;     // (C, 3) logit
  const float* roughness;  // (C, 1) logit
  const float* metallic;   // (C, 1) logit
  const uint8_t* alive;    // (C,) bool
};

struct CamIn {  // the Camera's device tensors
  const float *wv, *fp, *cc, *fx, *fy, *tanx, *tany;
};

struct Dims {
  int C, k_rest, with_colors, z_depth, tile, width, height, grid_x, grid_y;
  float zfar;
};

struct FwdOut {
  float* opac;       // (C,)
  float* feat;       // (C, 10)
  float* means2d;    // (C, 2)
  float* depths;     // (C,)
  float* conics;     // (C, 3)
  float* colors;     // (C, 3)
  int* radii;        // (C,)
  int* rect_min;     // (C, 2)
  int* rect_max;     // (C, 2)
  int* tiles;        // (C,)
  uint8_t* valid;    // (C,)
};

// A cotangent (C, k) given by its pointer and element strides; null where
// autograd has none (it counts as zeros).
struct Cot {
  const float* p;
  long long s0, s1;
  __device__ float at(int i, int k) const {
    return p ? p[i * s0 + k * s1] : 0.f;
  }
};

struct Grads {
  float *xyz, *f_dc, *f_rest, *scaling, *rotation, *opacity, *albedo,
      *roughness, *metallic;
};

// The camera in shared memory: world_view (16), full_proj (16),
// cam_center (3), fx, fy, 1.3 tanfovx, 1.3 tanfovy.
constexpr int kCamFloats = 39;
enum { kW = 0, kF = 16, kCC = 32, kFx = 35, kFy = 36, kLimX = 37, kLimY = 38 };

__device__ __forceinline__ void load_cam(float* s, const CamIn& c) {
  const int t = threadIdx.x;
  if (t < 16) s[kW + t] = c.wv[t];
  else if (t < 32) s[t] = c.fp[t - 16];
  else if (t < 35) s[t] = c.cc[t - 32];
  else if (t == kFx) s[t] = *c.fx;
  else if (t == kFy) s[t] = *c.fy;
  else if (t == kLimX) s[t] = 1.3f * *c.tanx;
  else if (t == kLimY) s[t] = 1.3f * *c.tany;
  __syncthreads();
}

// torch.clamp_min / torch.maximum / torch.minimum / torch.clamp as PyTorch
// computes them for float32: a NaN operand gives NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float maximum(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// projection.py::_tile_index: f32 -> int32 truncating toward zero (the
// conversion saturates, as PyTorch's on the card does), clamped to [0, hi].
__device__ __forceinline__ int tile_index(float v, int tile, int hi) {
  const int i = (int)(v / (float)tile);
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// v @ M[:3, col] for a row vector v and a 4x4 row-major M as the card's
// matmul computes it (measured on an H100: bit-equal on every row): a
// fused multiply-add chain in k order; an affine map's M[3, col] (or the
// homogeneous 1 * M[3, col]) is added after.
__device__ __forceinline__ float dot3(float x, float y, float z, const float* M,
                                      int col) {
  return __fmaf_rn(z, M[8 + col], __fmaf_rn(y, M[4 + col], x * M[col]));
}

// torch.sum over a last dim of 3 and of 4 on the card: (a + c) + b and
// (a + c) + (b + d).
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return (a + c) + (b + d);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// core/gaussians.py::quat_to_rotmat_elems of the normalised quaternion.
__device__ __forceinline__ void rotmat(float r, float x, float y, float z,
                                       float* e) {
  e[0] = 1.f - 2.f * (y * y + z * z);
  e[1] = 2.f * (x * y - r * z);
  e[2] = 2.f * (x * z + r * y);
  e[3] = 2.f * (x * y + r * z);
  e[4] = 1.f - 2.f * (x * x + z * z);
  e[5] = 2.f * (y * z - r * x);
  e[6] = 2.f * (x * z - r * y);
  e[7] = 2.f * (y * z + r * x);
  e[8] = 1.f - 2.f * (x * x + y * y);
}

// Index pairs (i, j) of the six covariance entries xx xy xz yy yz zz, and
// of compute_cov2d's M00 M01 M02 M11 M12 M22. Loops over them unroll, so
// these fold to constants and the register arrays stay in registers.
__device__ __forceinline__ constexpr int pair_i(int p) {
  return p < 3 ? 0 : (p < 5 ? 1 : 2);
}
__device__ __forceinline__ constexpr int pair_j(int p) {
  return p < 3 ? p : (p < 5 ? p - 2 : 2);
}

// compute_cov2d's quad(u, v) = u^T Sigma v, with u, v rows a, b of
// R = world_view[:3, :3]^T (R[a][k] = W[4k + a]).
__device__ __forceinline__ float quad(const float* s, const float* W, int a,
                                      int b) {
  const float u0 = W[a], u1 = W[4 + a], u2 = W[8 + a];
  const float v0 = W[b], v1 = W[4 + b], v2 = W[8 + b];
  return s[0] * (u0 * v0) + s[3] * (u1 * v1) + s[5] * (u2 * v2)
         + s[1] * (u0 * v1 + u1 * v0) + s[2] * (u0 * v2 + u2 * v0)
         + s[4] * (u1 * v2 + u2 * v1);
}

// What the forward computes for one row up to the cull, kept for the
// backward's recomputation.
struct Geo {
  float x, y, z;            // xyz
  float s[3];               // exp(scaling)
  float q[4], nq, qn[4];    // raw quaternion, its norm, normalised
  float e[9];               // rotation matrix elements
  float t[3];               // view-space position
  float ph[4], pw;          // clip-space position, 1 / (w_safe + 1e-7)
  bool in_front;
  float tz, ux, uy, uxc, uyc, tx, ty, inv_z, inv_z2;
  float M[6];               // R Sigma R^T: 00 01 02 11 12 22
  float j00, j02, j11, j12;
  float cxx, cxy, cyy, det, det_inv;
  bool det_ok, valid;
  float px, py, radius, rect_radius;
};

__device__ __forceinline__ void geometry(Geo& g, const Leaves& L,
                                         const float* cam, const Dims& d,
                                         int i, float op, bool alive) {
  const float* W = cam + kW;
  const float* F = cam + kF;
  g.x = L.xyz[3 * i];
  g.y = L.xyz[3 * i + 1];
  g.z = L.xyz[3 * i + 2];
#pragma unroll
  for (int k = 0; k < 3; ++k) g.s[k] = expf(L.scaling[3 * i + k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) g.q[k] = L.rotation[4 * i + k];
  g.nq = sqrtf(sum4(g.q[0] * g.q[0], g.q[1] * g.q[1], g.q[2] * g.q[2],
                    g.q[3] * g.q[3]) + 1e-20f);
#pragma unroll
  for (int k = 0; k < 4; ++k) g.qn[k] = g.q[k] / g.nq;
  rotmat(g.qn[0], g.qn[1], g.qn[2], g.qn[3], g.e);

  // View and clip transforms (row vectors).
#pragma unroll
  for (int k = 0; k < 3; ++k) g.t[k] = dot3(g.x, g.y, g.z, W, k) + W[12 + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) g.ph[k] = dot3(g.x, g.y, g.z, F, k) + F[12 + k];
  g.in_front = g.t[2] > 0.2f;
  const float w_safe = g.in_front ? g.ph[3] : 1.f;
  g.pw = 1.f / (w_safe + 1e-7f);

  // World covariance sigma_ij = sum_k s_k^2 R_ik R_jk.
  const float s2[3] = {g.s[0] * g.s[0], g.s[1] * g.s[1], g.s[2] * g.s[2]};
  float sig[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int a = 3 * pair_i(p), b = 3 * pair_j(p);
    sig[p] = (s2[0] * g.e[a] * g.e[b] + s2[1] * g.e[a + 1] * g.e[b + 1])
             + s2[2] * g.e[a + 2] * g.e[b + 2];
  }

  // EWA with the 1.3 tanfov frustum clamp.
  g.tz = g.t[2] > 0.2f ? g.t[2] : 1.f;
  g.ux = g.t[0] / g.tz;
  g.uy = g.t[1] / g.tz;
  g.uxc = clamp(g.ux, -cam[kLimX], cam[kLimX]);
  g.uyc = clamp(g.uy, -cam[kLimY], cam[kLimY]);
  g.tx = g.uxc * g.tz;
  g.ty = g.uyc * g.tz;
  g.inv_z = 1.f / g.tz;
  g.inv_z2 = g.inv_z * g.inv_z;
#pragma unroll
  for (int m = 0; m < 6; ++m) g.M[m] = quad(sig, W, pair_i(m), pair_j(m));
  const float fx = cam[kFx], fy = cam[kFy];
  g.j00 = fx * g.inv_z;
  g.j02 = -fx * g.tx * g.inv_z2;
  g.j11 = fy * g.inv_z;
  g.j12 = -fy * g.ty * g.inv_z2;
  const float* M = g.M;
  g.cxx = g.j00 * g.j00 * M[0] + 2.f * g.j00 * g.j02 * M[2]
          + g.j02 * g.j02 * M[5];
  g.cxy = g.j00 * g.j11 * M[1] + g.j00 * g.j12 * M[2] + g.j02 * g.j11 * M[4]
          + g.j02 * g.j12 * M[5];
  g.cyy = g.j11 * g.j11 * M[3] + 2.f * g.j11 * g.j12 * M[4]
          + g.j12 * g.j12 * M[5];

  g.det = g.cxx * g.cyy - g.cxy * g.cxy;
  g.det_ok = g.det > 0.f;
  g.det_inv = 1.f / (g.det_ok ? g.det : 1.f);

  const float mid = 0.5f * (g.cxx + g.cyy);
  const float disc = sqrtf(clamp_min(mid * mid - g.det, 0.1f));
  const float lambda1 = mid + disc;
  const float sigma_max = sqrtf(maximum(lambda1, mid - disc));
  g.radius = ceilf(3.f * sigma_max);
  // The opacity-aware rect (projection.py's module note).
  const float qop = 2.f * logf(clamp_min(op, 1e-12f) * 255.f);
  const float r_op = sqrtf((clamp_min(qop, 0.f) + 1e-3f)
                           * clamp_min(lambda1, 0.f));
  g.rect_radius = minimum(g.radius, ceilf(r_op) + 1.f);

  g.px = ((g.ph[0] * g.pw + 1.f) * (float)d.width - 1.f) * 0.5f;
  g.py = ((g.ph[1] * g.pw + 1.f) * (float)d.height - 1.f) * 0.5f;
  const float T = (float)d.tile;
  const int a3x = tile_index(g.px + g.radius + T - 1.f, d.tile, d.grid_x)
                  - tile_index(g.px - g.radius, d.tile, d.grid_x);
  const int a3y = tile_index(g.py + g.radius + T - 1.f, d.tile, d.grid_y)
                  - tile_index(g.py - g.radius, d.tile, d.grid_y);
  g.valid = g.in_front && g.det_ok && a3x * a3y > 0 && alive;
}

// Gaussians.get_normals: the rotation column of the first minimal scale,
// flipped toward the camera, and its normalisation.
struct Normal {
  int col;        // the chosen column
  bool flip;
  float nf[3];    // the flipped column
  float nn;       // its norm
  float n[3];     // the normal
};

__device__ __forceinline__ void normal(Normal& o, const Geo& g,
                                       const float* cam) {
  const bool m0 = g.s[0] <= g.s[1] && g.s[0] <= g.s[2];
  const bool m1 = !m0 && g.s[1] <= g.s[2];
  o.col = m0 ? 0 : (m1 ? 1 : 2);
  const float c0 = m0 ? g.e[0] : (m1 ? g.e[1] : g.e[2]);
  const float c1 = m0 ? g.e[3] : (m1 ? g.e[4] : g.e[5]);
  const float c2 = m0 ? g.e[6] : (m1 ? g.e[7] : g.e[8]);
  const float v0 = cam[kCC] - g.x, v1 = cam[kCC + 1] - g.y,
              v2 = cam[kCC + 2] - g.z;
  o.flip = sum3(c0 * v0, c1 * v1, c2 * v2) < 0.f;
  o.nf[0] = o.flip ? -c0 : c0;
  o.nf[1] = o.flip ? -c1 : c1;
  o.nf[2] = o.flip ? -c2 : c2;
  o.nn = sqrtf(sum3(o.nf[0] * o.nf[0], o.nf[1] * o.nf[1], o.nf[2] * o.nf[2])
               + 1e-20f);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.n[k] = o.nf[k] / o.nn;
}

template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = kC0;
  if (D > 0) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC20 * xy;
    b[5] = kC21 * yz;
    b[6] = kC22 * (2.f * zz - xx - yy);
    b[7] = kC23 * xz;
    b[8] = kC24 * (xx - yy);
    if (D > 2) {
      b[9] = kC30 * y * (3.f * xx - yy);
      b[10] = kC31 * xy * z;
      b[11] = kC32 * y * (4.f * zz - xx - yy);
      b[12] = kC33 * z * (2.f * zz - 3.f * xx - 3.f * yy);
      b[13] = kC34 * x * (4.f * zz - xx - yy);
      b[14] = kC35 * z * (xx - yy);
      b[15] = kC36 * x * (xx - 3.f * yy);
    }
  }
}

// d (sum_k gb_k basis_k) / d dir.
template <int D>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z,
                                             const float* gb, float* gd) {
  gd[0] = gd[1] = gd[2] = 0.f;
  if (D > 0) {
    gd[1] += -kC1 * gb[1];
    gd[2] += kC1 * gb[2];
    gd[0] += -kC1 * gb[3];
  }
  if (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gd[0] += kC20 * y * gb[4];
    gd[1] += kC20 * x * gb[4];
    gd[1] += kC21 * z * gb[5];
    gd[2] += kC21 * y * gb[5];
    gd[0] += -2.f * kC22 * x * gb[6];
    gd[1] += -2.f * kC22 * y * gb[6];
    gd[2] += 4.f * kC22 * z * gb[6];
    gd[0] += kC23 * z * gb[7];
    gd[2] += kC23 * x * gb[7];
    gd[0] += 2.f * kC24 * x * gb[8];
    gd[1] += -2.f * kC24 * y * gb[8];
    if (D > 2) {
      gd[0] += 6.f * kC30 * x * y * gb[9];
      gd[1] += kC30 * (3.f * xx - 3.f * yy) * gb[9];
      gd[0] += kC31 * y * z * gb[10];
      gd[1] += kC31 * x * z * gb[10];
      gd[2] += kC31 * x * y * gb[10];
      gd[0] += -2.f * kC32 * x * y * gb[11];
      gd[1] += kC32 * (4.f * zz - xx - 3.f * yy) * gb[11];
      gd[2] += 8.f * kC32 * y * z * gb[11];
      gd[0] += -6.f * kC33 * x * z * gb[12];
      gd[1] += -6.f * kC33 * y * z * gb[12];
      gd[2] += kC33 * (6.f * zz - 3.f * xx - 3.f * yy) * gb[12];
      gd[0] += kC34 * (4.f * zz - 3.f * xx - yy) * gb[13];
      gd[1] += -2.f * kC34 * x * y * gb[13];
      gd[2] += 8.f * kC34 * x * z * gb[13];
      gd[0] += 2.f * kC35 * x * z * gb[14];
      gd[1] += -2.f * kC35 * y * z * gb[14];
      gd[2] += kC35 * (xx - yy) * gb[14];
      gd[0] += kC36 * (3.f * xx - 3.f * yy) * gb[15];
      gd[1] += -6.f * kC36 * x * y * gb[15];
    }
  }
}

// The SH coefficient k of row i, channel c.
__device__ __forceinline__ float sh_coef(const Leaves& L, int k_rest, int i,
                                         int k, int c) {
  return k == 0 ? L.f_dc[3 * i + c]
                : L.f_rest[((size_t)i * k_rest + (k - 1)) * 3 + c];
}

// Channel c of the SH radiance sum_k b_k sh_k as torch.sum over the (C, K,
// 3) products' K axis computes it on the card: four accumulators, k mod 4,
// then summed in order.
template <int D>
__device__ __forceinline__ float sh_radiance(const float* b, const Leaves& L,
                                             int k_rest, int i, int c) {
  constexpr int K = (D + 1) * (D + 1);
  if (K == 1) return b[0] * sh_coef(L, k_rest, i, 0, c);
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = b[k] * sh_coef(L, k_rest, i, k, c);
#pragma unroll
  for (int k = 4; k < K; ++k) a[k % 4] = a[k % 4] + b[k] * sh_coef(L, k_rest, i, k, c);
  return ((a[0] + a[1]) + a[2]) + a[3];
}

// The unit view direction (xyz - cam_center) / |.| and its norm.
__device__ __forceinline__ void view_dir(const Geo& g, const float* cam,
                                         float* v, float* dir, float& nd) {
  v[0] = g.x - cam[kCC];
  v[1] = g.y - cam[kCC + 1];
  v[2] = g.z - cam[kCC + 2];
  nd = sqrtf(sum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]) + 1e-20f);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = v[k] / nd;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
preprocess_fwd_kernel(Leaves L, CamIn ci, Dims d, FwdOut o) {
  __shared__ float cam[kCamFloats];
  load_cam(cam, ci);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d.C) return;
  const float* W = cam + kW;

  const bool alive = L.alive[i] != 0;
  const float op = sigmoid(L.opacity[i]) * (alive ? 1.f : 0.f);
  Geo g;
  geometry(g, L, cam, d, i, op, alive);

  // Features: [1, plane distance, normal, albedo, roughness, metallic].
  Normal nr;
  normal(nr, g, cam);
  float dist;
  if (d.z_depth) {
    dist = g.t[2];
  } else {
    float cn[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) cn[k] = dot3(nr.n[0], nr.n[1], nr.n[2], W, k);
    dist = fabsf(sum3(cn[0] * g.t[0], cn[1] * g.t[1], cn[2] * g.t[2]));
  }
  float* f = o.feat + (size_t)10 * i;
  f[0] = 1.f;
  f[1] = dist;
  f[2] = nr.n[0];
  f[3] = nr.n[1];
  f[4] = nr.n[2];
  f[5] = sigmoid(L.albedo[3 * i]);
  f[6] = sigmoid(L.albedo[3 * i + 1]);
  f[7] = sigmoid(L.albedo[3 * i + 2]);
  f[8] = sigmoid(L.roughness[i]);
  f[9] = sigmoid(L.metallic[i]);
  o.opac[i] = op;

  // SH colour: +0.5, then torch.maximum(x, 0).
  float rgb[3] = {0.f, 0.f, 0.f};
  if (d.with_colors) {
    float v[3], dir[3], nd;
    view_dir(g, cam, v, dir, nd);
    float b[16];
    sh_basis<D>(dir[0], dir[1], dir[2], b);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = maximum(sh_radiance<D>(b, L, d.k_rest, i, c) + 0.5f, 0.f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) o.colors[3 * i + c] = rgb[c];

  // The tile rect (opacity-aware) and the culled rows' safe values.
  const float T = (float)d.tile;
  const int rminx = tile_index(g.px - g.rect_radius, d.tile, d.grid_x);
  const int rminy = tile_index(g.py - g.rect_radius, d.tile, d.grid_y);
  const int rmaxx = tile_index(g.px + g.rect_radius + T - 1.f, d.tile,
                               d.grid_x);
  const int rmaxy = tile_index(g.py + g.rect_radius + T - 1.f, d.tile,
                               d.grid_y);
  o.rect_min[2 * i] = rminx;
  o.rect_min[2 * i + 1] = rminy;
  o.rect_max[2 * i] = rmaxx;
  o.rect_max[2 * i + 1] = rmaxy;
  o.tiles[i] = g.valid ? (rmaxx - rminx) * (rmaxy - rminy) : 0;
  o.radii[i] = g.valid ? (int)g.radius : 0;
  o.valid[i] = g.valid ? 1 : 0;
  o.means2d[2 * i] = g.valid ? g.px : -1e4f;
  o.means2d[2 * i + 1] = g.valid ? g.py : -1e4f;
  o.conics[3 * i] = g.valid ? g.cyy * g.det_inv : 1.f;
  o.conics[3 * i + 1] = g.valid ? -g.cxy * g.det_inv : 0.f;
  o.conics[3 * i + 2] = g.valid ? g.cxx * g.det_inv : 1.f;
  o.depths[i] = g.valid ? g.t[2] : d.zfar;
}

// sigmoid's gradient as autograd forms it: g (1 - y) y.
__device__ __forceinline__ float sigmoid_vjp(float g, float y) {
  return g * (1.f - y) * y;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
preprocess_bwd_kernel(Leaves L, CamIn ci, Dims d, Cot g_op, Cot g_feat,
                      Cot g_m2d, Cot g_con, Cot g_col, Grads gr) {
  __shared__ float cam[kCamFloats];
  load_cam(cam, ci);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d.C) return;
  const float* W = cam + kW;
  const float* F = cam + kF;

  const bool alive = L.alive[i] != 0;
  const float sig_o = sigmoid(L.opacity[i]);
  const float op = sig_o * (alive ? 1.f : 0.f);
  Geo g;
  geometry(g, L, cam, d, i, op, alive);

  // Opacity and the material sigmoids.
  gr.opacity[i] = sigmoid_vjp(g_op.at(i, 0) * (alive ? 1.f : 0.f), sig_o);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    gr.albedo[3 * i + c] = sigmoid_vjp(g_feat.at(i, 5 + c),
                                       sigmoid(L.albedo[3 * i + c]));
  gr.roughness[i] = sigmoid_vjp(g_feat.at(i, 8), sigmoid(L.roughness[i]));
  gr.metallic[i] = sigmoid_vjp(g_feat.at(i, 9), sigmoid(L.metallic[i]));

  float gx[3] = {0.f, 0.f, 0.f};   // d xyz, besides the view-space part
  float gt[3] = {0.f, 0.f, 0.f};   // d of the view-space position t
  float ge[9];                      // d of the rotation elements
#pragma unroll
  for (int k = 0; k < 9; ++k) ge[k] = 0.f;
  float gs2[3] = {0.f, 0.f, 0.f};  // d of the squared scales

  // Colors -> SH coefficients and the view direction.
  const int K = (D + 1) * (D + 1);
  if (d.with_colors) {
    float v[3], dir[3], nd;
    view_dir(g, cam, v, dir, nd);
    float b[16], gb[16];
    sh_basis<D>(dir[0], dir[1], dir[2], b);
#pragma unroll
    for (int k = 0; k < K; ++k) gb[k] = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float xc = sh_radiance<D>(b, L, d.k_rest, i, c) + 0.5f;
      const float gc = g_col.at(i, c);
      // torch.maximum(x, 0): the whole gradient above 0, half at the tie.
      const float gxc = xc > 0.f ? gc : (xc == 0.f ? gc * 0.5f : 0.f);
      gr.f_dc[3 * i + c] = gxc * b[0];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        gr.f_rest[((size_t)i * d.k_rest + (k - 1)) * 3 + c] = gxc * b[k];
        gb[k] += gxc * sh_coef(L, d.k_rest, i, k, c);
      }
    }
    float gd[3];
    sh_basis_vjp<D>(dir[0], dir[1], dir[2], gb, gd);
    const float dot = (gd[0] * v[0] + gd[1] * v[1]) + gd[2] * v[2];
    const float nd3 = nd * nd * nd;
#pragma unroll
    for (int k = 0; k < 3; ++k) gx[k] += gd[k] / nd - v[k] * (dot / nd3);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) gr.f_dc[3 * i + c] = 0.f;
  }
  for (int k = d.with_colors ? K : 1; k <= d.k_rest; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      gr.f_rest[((size_t)i * d.k_rest + (k - 1)) * 3 + c] = 0.f;

  // Features: the normal and the plane distance |n_cam . t| (or t_z).
  {
    Normal nr;
    normal(nr, g, cam);
    float gn[3] = {g_feat.at(i, 2), g_feat.at(i, 3), g_feat.at(i, 4)};
    const float gdist = g_feat.at(i, 1);
    if (d.z_depth) {
      gt[2] += gdist;
    } else {
      float cn[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) cn[k] = dot3(nr.n[0], nr.n[1], nr.n[2], W, k);
      const float dot = sum3(cn[0] * g.t[0], cn[1] * g.t[1], cn[2] * g.t[2]);
      // abs: sign(dot), 0 at 0.
      const float gdot = dot > 0.f ? gdist : (dot < 0.f ? -gdist : 0.f);
#pragma unroll
      for (int k = 0; k < 3; ++k) gt[k] += gdot * cn[k];
      // n_cam = n @ W[:3, :3]: d n_j += sum_k d n_cam_k W[j][k].
#pragma unroll
      for (int j = 0; j < 3; ++j)
        gn[j] += ((gdot * g.t[0]) * W[4 * j] + (gdot * g.t[1]) * W[4 * j + 1])
                 + (gdot * g.t[2]) * W[4 * j + 2];
    }
    // n = nf / |nf|.
    const float dot = (gn[0] * nr.nf[0] + gn[1] * nr.nf[1]) + gn[2] * nr.nf[2];
    const float nn3 = nr.nn * nr.nn * nr.nn;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float gnf = gn[k] / nr.nn - nr.nf[k] * (dot / nn3);
      const float gcol = nr.flip ? -gnf : gnf;
      ge[3 * k] += nr.col == 0 ? gcol : 0.f;
      ge[3 * k + 1] += nr.col == 1 ? gcol : 0.f;
      ge[3 * k + 2] += nr.col == 2 ? gcol : 0.f;
    }
  }

  if (g.valid) {
    // means2d -> the clip-space position.
    const float gpx = g_m2d.at(i, 0) * 0.5f * (float)d.width;
    const float gpy = g_m2d.at(i, 1) * 0.5f * (float)d.height;
    const float gph0 = gpx * g.pw, gph1 = gpy * g.pw;
    const float gpw = gpx * g.ph[0] + gpy * g.ph[1];
    const float gph3 = g.in_front ? gpw * -(g.pw * g.pw) : 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gx[j] += (gph0 * F[4 * j] + gph1 * F[4 * j + 1]) + gph3 * F[4 * j + 3];

    // conics -> the 2D covariance.
    const float ga = g_con.at(i, 0), gb = g_con.at(i, 1), gc = g_con.at(i, 2);
    const float ginv = (ga * g.cyy + gb * -g.cxy) + gc * g.cxx;
    const float gdet = ginv * -(g.det_inv * g.det_inv);
    const float gcxx = gc * g.det_inv + gdet * g.cyy;
    const float gcyy = ga * g.det_inv + gdet * g.cxx;
    const float gcxy = -(gb * g.det_inv) - 2.f * gdet * g.cxy;

    // The 2D covariance -> R Sigma R^T and the Jacobian.
    const float* M = g.M;
    float gM[6];
    gM[0] = gcxx * (g.j00 * g.j00);
    gM[1] = gcxy * (g.j00 * g.j11);
    gM[2] = gcxx * (2.f * g.j00 * g.j02) + gcxy * (g.j00 * g.j12);
    gM[3] = gcyy * (g.j11 * g.j11);
    gM[4] = gcxy * (g.j02 * g.j11) + gcyy * (2.f * g.j11 * g.j12);
    gM[5] = gcxx * (g.j02 * g.j02) + gcxy * (g.j02 * g.j12)
            + gcyy * (g.j12 * g.j12);
    const float gj00 = gcxx * (2.f * g.j00 * M[0] + 2.f * g.j02 * M[2])
                       + gcxy * (g.j11 * M[1] + g.j12 * M[2]);
    const float gj02 = gcxx * (2.f * g.j00 * M[2] + 2.f * g.j02 * M[5])
                       + gcxy * (g.j11 * M[4] + g.j12 * M[5]);
    const float gj11 = gcyy * (2.f * g.j11 * M[3] + 2.f * g.j12 * M[4])
                       + gcxy * (g.j00 * M[1] + g.j02 * M[4]);
    const float gj12 = gcyy * (2.f * g.j11 * M[4] + 2.f * g.j12 * M[5])
                       + gcxy * (g.j00 * M[2] + g.j02 * M[5]);
    const float fx = cam[kFx], fy = cam[kFy];
    const float ginv_z2 = gj02 * (-fx * g.tx) + gj12 * (-fy * g.ty);
    const float ginv_z = gj00 * fx + gj11 * fy + 2.f * g.inv_z * ginv_z2;
    const float gtx = gj02 * -fx * g.inv_z2;
    const float gty = gj12 * -fy * g.inv_z2;
    float gtz = -ginv_z * (g.inv_z * g.inv_z);
    // tx = clamp(t_x / tz, -lim, lim) * tz; clamp passes at its bounds.
    const float gux = (g.ux >= -cam[kLimX] && g.ux <= cam[kLimX]) ? gtx * g.tz
                                                                   : 0.f;
    const float guy = (g.uy >= -cam[kLimY] && g.uy <= cam[kLimY]) ? gty * g.tz
                                                                   : 0.f;
    gtz += gtx * g.uxc + gty * g.uyc;
    gt[0] += gux / g.tz;
    gt[1] += guy / g.tz;
    gtz += -gux * (g.t[0] / (g.tz * g.tz)) - guy * (g.t[1] / (g.tz * g.tz));
    if (g.t[2] > 0.2f) gt[2] += gtz;

    // R Sigma R^T -> Sigma.
    float gsig[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const int a = pair_i(m), b = pair_j(m);
      const float u0 = W[a], u1 = W[4 + a], u2 = W[8 + a];
      const float v0 = W[b], v1 = W[4 + b], v2 = W[8 + b];
      gsig[0] += gM[m] * (u0 * v0);
      gsig[3] += gM[m] * (u1 * v1);
      gsig[5] += gM[m] * (u2 * v2);
      gsig[1] += gM[m] * (u0 * v1 + u1 * v0);
      gsig[2] += gM[m] * (u0 * v2 + u2 * v0);
      gsig[4] += gM[m] * (u1 * v2 + u2 * v1);
    }
    // Sigma -> the squared scales and the rotation elements.
    const float s2[3] = {g.s[0] * g.s[0], g.s[1] * g.s[1], g.s[2] * g.s[2]};
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int a = 3 * pair_i(p), b = 3 * pair_j(p);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gs2[k] += gsig[p] * (g.e[a + k] * g.e[b + k]);
        ge[a + k] += gsig[p] * s2[k] * g.e[b + k];
        ge[b + k] += gsig[p] * s2[k] * g.e[a + k];
      }
    }
  }

  // The view-space position -> xyz (t = xyz @ W[:3, :3] + W[3, :3]).
#pragma unroll
  for (int j = 0; j < 3; ++j)
    gr.xyz[3 * i + j] = gx[j] + ((gt[0] * W[4 * j] + gt[1] * W[4 * j + 1])
                                 + gt[2] * W[4 * j + 2]);

  // Squared scales -> log-scales: s^2 backward 2 s, exp backward s.
#pragma unroll
  for (int k = 0; k < 3; ++k)
    gr.scaling[3 * i + k] = gs2[k] * 2.f * g.s[k] * g.s[k];

  // Rotation elements -> the normalised quaternion -> the raw one.
  const float r = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  float gq[4];
  gq[0] = 2.f * (-z * ge[1] + y * ge[2] + z * ge[3] - x * ge[5] - y * ge[6]
                 + x * ge[7]);
  gq[1] = 2.f * (y * ge[1] + z * ge[2] + y * ge[3] - r * ge[5] + z * ge[6]
                 + r * ge[7]) - 4.f * x * (ge[4] + ge[8]);
  gq[2] = 2.f * (x * ge[1] + r * ge[2] + x * ge[3] + z * ge[5] - r * ge[6]
                 + z * ge[7]) - 4.f * y * (ge[0] + ge[8]);
  gq[3] = 2.f * (-r * ge[1] + x * ge[2] + r * ge[3] + y * ge[5] + x * ge[6]
                 + y * ge[7]) - 4.f * z * (ge[0] + ge[4]);
  const float qdot = ((gq[0] * g.q[0] + gq[1] * g.q[1]) + gq[2] * g.q[2])
                     + gq[3] * g.q[3];
  const float nq3 = g.nq * g.nq * g.nq;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    gr.rotation[4 * i + k] = gq[k] / g.nq - g.q[k] * (qdot / nq3);
}

template <int D>
cudaError_t launch_fwd(const Leaves& L, const CamIn& c, const Dims& d,
                       const FwdOut& o, cudaStream_t s) {
  const int blocks = (d.C + kThreads - 1) / kThreads;
  if (blocks > 0) preprocess_fwd_kernel<D><<<blocks, kThreads, 0, s>>>(L, c, d, o);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const Leaves& L, const CamIn& c, const Dims& d,
                       const Cot* cot, const Grads& gr, cudaStream_t s) {
  const int blocks = (d.C + kThreads - 1) / kThreads;
  if (blocks > 0)
    preprocess_bwd_kernel<D><<<blocks, kThreads, 0, s>>>(
        L, c, d, cot[0], cot[1], cot[2], cot[3], cot[4], gr);
  return cudaGetLastError();
}

Leaves leaves_of(void* const* in) {
  Leaves L;
  L.xyz = static_cast<const float*>(in[0]);
  L.f_dc = static_cast<const float*>(in[1]);
  L.f_rest = static_cast<const float*>(in[2]);
  L.scaling = static_cast<const float*>(in[3]);
  L.rotation = static_cast<const float*>(in[4]);
  L.opacity = static_cast<const float*>(in[5]);
  L.albedo = static_cast<const float*>(in[6]);
  L.roughness = static_cast<const float*>(in[7]);
  L.metallic = static_cast<const float*>(in[8]);
  L.alive = static_cast<const uint8_t*>(in[9]);
  return L;
}

CamIn cam_of(void* const* in) {
  CamIn c;
  c.wv = static_cast<const float*>(in[10]);
  c.fp = static_cast<const float*>(in[11]);
  c.cc = static_cast<const float*>(in[12]);
  c.fx = static_cast<const float*>(in[13]);
  c.fy = static_cast<const float*>(in[14]);
  c.tanx = static_cast<const float*>(in[15]);
  c.tany = static_cast<const float*>(in[16]);
  return c;
}

Dims dims_of(int C, int k_rest, int with_colors, int z_depth, int tile,
             int width, int height, float zfar) {
  Dims d;
  d.C = C;
  d.k_rest = k_rest;
  d.with_colors = with_colors;
  d.z_depth = z_depth;
  d.tile = tile;
  d.width = width;
  d.height = height;
  d.grid_x = (width + tile - 1) / tile;
  d.grid_y = (height + tile - 1) / tile;
  d.zfar = zfar;
  return d;
}

}  // namespace

// in: xyz, f_dc, f_rest, scaling, rotation, opacity, albedo, roughness,
// metallic, alive, world_view, full_proj, cam_center, fx, fy, tanfovx,
// tanfovy (17 device pointers). out: opacities, features, means2d, depths,
// conics, colors, radii, rect_min, rect_max, tiles_touched, valid (11).
extern "C" int gs2m_preprocess_fwd(void* const* in, void* const* out, int C,
                                   int k_rest, int deg, int with_colors,
                                   int z_depth, int tile, int width,
                                   int height, float zfar, void* stream) {
  const Leaves L = leaves_of(in);
  const CamIn c = cam_of(in);
  const Dims d = dims_of(C, k_rest, with_colors, z_depth, tile, width,
                         height, zfar);
  FwdOut o;
  o.opac = static_cast<float*>(out[0]);
  o.feat = static_cast<float*>(out[1]);
  o.means2d = static_cast<float*>(out[2]);
  o.depths = static_cast<float*>(out[3]);
  o.conics = static_cast<float*>(out[4]);
  o.colors = static_cast<float*>(out[5]);
  o.radii = static_cast<int*>(out[6]);
  o.rect_min = static_cast<int*>(out[7]);
  o.rect_max = static_cast<int*>(out[8]);
  o.tiles = static_cast<int*>(out[9]);
  o.valid = static_cast<uint8_t*>(out[10]);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 0: return (int)launch_fwd<0>(L, c, d, o, s);
    case 1: return (int)launch_fwd<1>(L, c, d, o, s);
    case 2: return (int)launch_fwd<2>(L, c, d, o, s);
    case 3: return (int)launch_fwd<3>(L, c, d, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// in: as the forward's. cot: the cotangents of opacities, features,
// means2d, conics and colors (null where there is none), with their element
// strides (row, column) in strides[0..10). grads: xyz, f_dc, f_rest,
// scaling, rotation, opacity, albedo, roughness, metallic (9, contiguous).
extern "C" int gs2m_preprocess_bwd(void* const* in, void* const* cot,
                                   const long long* strides,
                                   void* const* grads, int C, int k_rest,
                                   int deg, int with_colors, int z_depth,
                                   int tile, int width, int height,
                                   void* stream) {
  const Leaves L = leaves_of(in);
  const CamIn c = cam_of(in);
  const Dims d = dims_of(C, k_rest, with_colors, z_depth, tile, width,
                         height, 0.f);
  Cot ct[5];
  for (int k = 0; k < 5; ++k) {
    ct[k].p = static_cast<const float*>(cot[k]);
    ct[k].s0 = strides[2 * k];
    ct[k].s1 = strides[2 * k + 1];
  }
  Grads gr;
  gr.xyz = static_cast<float*>(grads[0]);
  gr.f_dc = static_cast<float*>(grads[1]);
  gr.f_rest = static_cast<float*>(grads[2]);
  gr.scaling = static_cast<float*>(grads[3]);
  gr.rotation = static_cast<float*>(grads[4]);
  gr.opacity = static_cast<float*>(grads[5]);
  gr.albedo = static_cast<float*>(grads[6]);
  gr.roughness = static_cast<float*>(grads[7]);
  gr.metallic = static_cast<float*>(grads[8]);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 0: return (int)launch_bwd<0>(L, c, d, ct, gr, s);
    case 1: return (int)launch_bwd<1>(L, c, d, ct, gr, s);
    case 2: return (int)launch_bwd<2>(L, c, d, ct, gr, s);
    case 3: return (int)launch_bwd<3>(L, c, d, ct, gr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
