"""Port vs JAX package: ops/binning.py, the Binning contract exactly equal.

Both packages bin the SAME Projected (the JAX one, carried over), so any
difference is the binning's own. The port keeps the JAX package's layout
fields and adds `num_kept`; the JAX package's per-Gaussian counts, which
only its backward reads, are not ported. On the four cases of
tests/test_binning_fuzz.py the layout, the kept count and the blend on the
layout (K1's and K2's plain versions) are held against the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.ops.binning import bin_gaussians as jbin
from gs2m_tpu.ops.binning import num_tiles
from gs2m_tpu.ops.blend_pallas import blend_tiles_pallas
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu.ops.rasterize import build_features, pack_values
from gs2m_tpu_torch.ops.binning import Binning as TBinning
from gs2m_tpu_torch.ops.binning import bin_gaussians as tbin
from gs2m_tpu_torch.ops.blend import blend_tiles
from gs2m_tpu_torch.ops.projection import Projected as TProjected
from gs2m_tpu_torch.utils.grad_gate import grad_gate

from tests.test_golden import make_camera, make_scene
from tests.test_torch_core import camera_pair, random_pose_scene

torch.set_num_threads(1)


def projected_pair(seed, n=120, size=(64, 48), boost=4.0):
    g = random_pose_scene(seed, n=n, capacity=128)
    jc, _ = camera_pair(*size)
    op = jnp.minimum(g.get_opacity[:, 0] * boost, 0.995)
    jp = jproject(g, jc, g.max_sh_degree, opacities=op)
    tp = TProjected(*[torch.from_numpy(np.array(x)) for x in jp])
    return jp, tp, op, torch.from_numpy(np.array(op))


# The JAX package's Binning fields the port keeps (all but num_kept).
SHARED = tuple(f for f in TBinning._fields if f != "num_kept")


def port_binning(jb) -> TBinning:
    """The port's Binning of a JAX package layout, built by field name."""
    return TBinning(**{f: torch.from_numpy(np.array(getattr(jb, f)))
                       for f in SHARED})


def assert_binning_equal(jb, tb):
    for name in SHARED:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("seed,size", [(0, (64, 48)), (1, (80, 72))])
def test_binning_exactly_equal(chunk, seed, size):
    jp, tp, jop, top = projected_pair(seed, size=size)
    H, W = size[1], size[0]
    jb = jbin(jp, H, W, 16, 2 ** 13, chunk, opacities=jop)
    tb = tbin(tp, H, W, 16, 2 ** 13, chunk, top)
    assert_binning_equal(jb, tb)
    assert int(tb.dropped) == 0 and int(tb.num_instances) > 0


@pytest.mark.parametrize("chunk", [64, 128])
def test_binning_overflow_equal(chunk):
    """A cap below the aligned demand: both the expansion and the alignment
    overflow paths, `dropped` and the cut tiles agree."""
    jp, tp, jop, top = projected_pair(2, size=(64, 48), boost=8.0)
    for cap in (2 * chunk, 6 * chunk):
        jb = jbin(jp, 48, 64, 16, cap, chunk, opacities=jop)
        tb = tbin(tp, 48, 64, 16, cap, chunk, top)
        assert_binning_equal(jb, tb)
        assert int(tb.dropped) > 0


def test_binning_empty_scene_equal():
    jp, tp, jop, top = projected_pair(3)
    jp = jp._replace(tiles_touched=jnp.zeros_like(jp.tiles_touched),
                     valid=jnp.zeros_like(jp.valid))
    tp = tp._replace(tiles_touched=torch.zeros_like(tp.tiles_touched),
                     valid=torch.zeros_like(tp.valid))
    jb = jbin(jp, 48, 64, 16, 2 ** 10, 64, opacities=jop)
    tb = tbin(tp, 48, 64, 16, 2 ** 10, 64, top)
    assert_binning_equal(jb, tb)
    assert not bool(tb.tile_nonempty.any()) and bool(tb.is_null.all())


# --- tests/test_binning_fuzz.py's four cases ---------------------------------


def fuzz_case(seed, n, opaque, cap_slack):
    """tests/test_binning_fuzz.py's scenes and caps: the JAX Gaussians,
    camera and Projected, its port copy, the opacities in both packages and
    (H, W, tile, chunk, a cap nothing overflows, the case's cap)."""
    rng = np.random.default_rng(seed)
    H, W, tile, chunk = 72, 56, 16, 32
    cam = make_camera(width=W, height=H)
    g = make_scene(rng, n=n, capacity=max(n, 64), random_pose=True)
    if opaque:
        g = dataclasses.replace(
            g, opacity=jnp.full_like(g.opacity, float(np.log(9.0))),
            scaling=jnp.full_like(g.scaling, float(np.log(0.55))))
    opac = jnp.minimum(g.get_opacity[:, 0], 0.99)
    jp = jproject(g, cam, g.max_sh_degree, opacities=opac)
    tp = TProjected(*[torch.from_numpy(np.array(x)) for x in jp])
    T = num_tiles(H, W, tile)[0] * num_tiles(H, W, tile)[1]
    demand = int(np.asarray(jp.tiles_touched).sum())
    IB = max(int(-(-demand // chunk)) * chunk + chunk, 2 * chunk) + T * chunk
    I = max(int(-(-int(demand * cap_slack) // chunk)) * chunk, 2 * chunk)
    return (g, cam, jp, tp, opac, torch.from_numpy(np.array(opac)),
            (H, W, tile, chunk, IB, I))


CASES = [(10, 120, True, 8.0),    # dense opaque
         (11, 120, False, 8.0),   # translucent
         (12, 160, True, 1.0),    # tight cap: alignment overflow
         (13, 60, True, 8.0)]     # sparse


@pytest.mark.parametrize("seed,n,opaque,cap_slack", CASES)
def test_fuzz_layout_matches_jax(seed, n, opaque, cap_slack):
    g, cam, jp, tp, jop, top, dims = fuzz_case(seed, n, opaque, cap_slack)
    H, W, tile, chunk, IB, I = dims
    for cap in (IB, I):
        jb = jbin(jp, H, W, tile, cap, chunk, opacities=jop)
        tb = tbin(tp, H, W, tile, cap, chunk, top)
        assert_binning_equal(jb, tb)
    assert int(tb.num_instances) > 0
    if cap_slack == 1.0:
        assert int(tb.dropped) > 0


@pytest.mark.parametrize("seed,n,opaque,cap_slack", CASES)
def test_num_kept_counts_the_laid_out_instances(seed, n, opaque, cap_slack):
    """`num_kept`, the instances the per-tile cull keeps: the JAX package's
    per-Gaussian counts summed, and the layout's non-null slots where
    nothing drops (no fewer where the cap overflows)."""
    g, cam, jp, tp, jop, top, dims = fuzz_case(seed, n, opaque, cap_slack)
    H, W, tile, chunk, IB, I = dims
    base = tbin(tp, H, W, tile, IB, chunk, top)
    jb = jbin(jp, H, W, tile, IB, chunk, opacities=jop)
    laid = int((~base.is_null).sum())
    assert int(base.dropped) == 0
    per_gaussian = int(np.asarray(jb.gauss_present).sum())
    assert int(base.num_kept) == per_gaussian == laid
    assert 0 < int(base.num_kept) <= int(base.num_instances)
    tight = tbin(tp, H, W, tile, I, chunk, top)
    laid = int((~tight.is_null).sum())
    assert int(tight.num_kept) == int(base.num_kept)
    if int(tight.dropped) == 0:
        assert laid == int(base.num_kept)
    else:
        assert laid < int(base.num_kept)


@pytest.mark.parametrize("seed,n,opaque,cap_slack", CASES)
def test_fuzz_blend_matches_jax(seed, n, opaque, cap_slack):
    """The blend on each case's layout at its own cap: the port's (the plain
    versions of K1 and, through autograd, K2) against the JAX package's
    (Pallas, interpret mode). Outputs allclose, observe counts equal, the
    four leaves' gradients at the check_grads gate."""
    g, cam, jp, tp, jop, top, dims = fuzz_case(seed, n, opaque, cap_slack)
    H, W, tile, chunk, IB, I = dims
    jb = jbin(jp, H, W, tile, I, chunk, opacities=jop)
    tb = tbin(tp, H, W, tile, I, chunk, top)
    values = pack_values(jp.colors, build_features(g, cam), 5)
    Hp, Wp = -(-H // tile) * tile, -(-W // tile) * tile
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1, 1, (values.shape[1], Hp, Wp)).astype(np.float32)

    def jloss(v, m, c, o):
        out = blend_tiles_pallas(v, m, c, o, jb, H, W, tile, chunk,
                                 interpret=True)
        return (jnp.sum(out.image * w) + jnp.sum(out.final_T ** 2)), out

    jargs = (values, jp.means2d, jp.conics, jop)
    (_, ref), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(*jargs)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_(True)
              for x in jargs]
    out = blend_tiles(*leaves, tb, H, W, tile, chunk)
    loss = (out.image * torch.from_numpy(w)).sum() + (out.final_T ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(out.image.detach().numpy(),
                               np.asarray(ref.image), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.final_T.detach().numpy(),
                               np.asarray(ref.final_T), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(out.observe.numpy(), np.asarray(ref.observe))
    for name, got, want in zip(("values", "means2d", "conics", "opacities"),
                               grads, jgrads):
        rep = grad_gate(got.numpy(), np.asarray(want))
        assert rep["pass"], (name, rep)
    assert float(grads[3].abs().max()) > 0
