"""Spherical-harmonics color evaluation (degrees 0..3).

Port of gs2m_tpu/core/sh.py: the same polynomial basis and constants. The
JAX render path evaluates every band the coefficients carry and masks bands
above the active degree; here the degree is a Python int, so the basis is
built only up to it — the summed terms are the same.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def _sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., (deg+1)^2] SH basis values at unit directions."""
    out = [torch.full_like(dirs[..., 0], C0)]
    if deg > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                    C2[3] * xz, C2[4] * (xx - yy)]
            if deg > 2:
                out += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
                        C3[2] * y * (4.0 * zz - xx - yy),
                        C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                        C3[4] * x * (4.0 * zz - xx - yy),
                        C3[5] * z * (xx - yy), C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Raw SH radiance [..., C] (no +0.5 offset, no clamp).

    deg: active degree in [0, 3], at most the degree `sh` carries.
    sh: [..., K, C] coefficients with K >= (deg+1)^2 (extra coeffs ignored).
    dirs: [..., 3] unit view directions.
    """
    K = num_sh_coeffs(deg)
    if not 0 <= deg <= 3 or sh.shape[-2] < K:
        raise ValueError(f"SH degree {deg} needs {K} coefficients, "
                         f"got {sh.shape[-2]}")
    basis = _sh_basis(deg, dirs)
    return torch.sum(basis[..., None] * sh[..., :K, :], dim=-2)


def sh_to_rgb(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> RGB as the rasterizer does: +0.5 offset then clamp to >= 0.
    torch.maximum, not clamp_min: at a tie (a color channel exactly 0) it
    splits the gradient in half, as the JAX package's jnp.maximum does."""
    x = eval_sh(deg, sh, dirs) + 0.5
    return torch.maximum(x, x.new_zeros(()))


def rgb_to_sh_dc(rgb):
    """Invert the DC band: color -> DC coefficient (numpy or torch)."""
    return (rgb - 0.5) / C0
