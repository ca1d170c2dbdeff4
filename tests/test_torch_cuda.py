"""The port on the card: CUDA kernels against their plain PyTorch versions and
the CUDA render path against the CPU one, at small shapes: both value widths
(V=8 as the train path's warmup and geometry stages blend, V=16 as the
render app's material package does), the paths' chunk of 256 and other
chunks, and edges the paths rarely reach (ragged image edges, termination,
the 0.99 clamp, empty and overflowing layouts, Gaussians that cross many
warps and tiles, opacities next to 1/255, the largest chunks, tiles whose
pixels all fall to T <= 0.5 early, where K3 retires them); and the mesh
path (TSDF fusion, marching tetrahedra) on the card against the CPU; and
the training step's properties on the card: no host sync per step (also
with the span recorder on) and bit-equal reruns, in the geometry and the material stage; and the
parallel paths on the card: a 4-band render against the full frame and
the one-rank data-parallel step against the single-view step; and the
per-Gaussian preprocess pair (csrc/preprocess.cu) against the eager chain
on the card: forward outputs (integers equal) on the CPU tests' edge scene,
a small scene and the benchmark's 2^19-row state, backward at the gate,
and its launches per train step; and the Adam kernel (csrc/adam.cu)
bit-equal to the eager loop on the same card tensors, and its launches per
update and per train step.

Marked `cuda`; each test skips without a card. On a machine with one:
    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.models.render import render
from gs2m_tpu_torch.ops import blend
from gs2m_tpu_torch.ops.binning import bin_gaussians, num_tiles
from gs2m_tpu_torch.ops.projection import project
from gs2m_tpu_torch.ops.rasterize import build_features, pack_values
from gs2m_tpu_torch.utils.grad_gate import DEFAULT_TOL, TOLERANCES, grad_gate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def scene(seed, n, spread=1.0, msd=2e-3, opacity=0.8, sh_degree=2,
          aniso=0.5, opacity_sd=0.0):
    """Random Gaussians: log-scales spread by `aniso`, opacity logits
    `opacity` + N(0, opacity_sd)."""
    rng = np.random.default_rng(seed)
    K = (sh_degree + 1) ** 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    params = dict(
        xyz=f(n, 3) * np.float32(spread), f_dc=f(n, 1, 3),
        f_rest=0.1 * f(n, K - 1, 3),
        scaling=np.log(np.sqrt(msd)) + aniso * f(n, 3),
        rotation=f(n, 4),
        opacity=np.full((n, 1), opacity, np.float32)
        + (opacity_sd * f(n, 1) if opacity_sd else 0.0),   # no draw at sd 0
        albedo=f(n, 3), roughness=f(n, 1), metallic=f(n, 1))
    return params, np.ones(n, bool), sh_degree


def camera(W, H, device):
    return Camera.create(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.9,
                         0.9 * H / W, W, H, device=device)


def k1_inputs(params, W, H, V, chunk, cap, device):
    g = Gaussians.from_numpy(*params, device=device)
    cam = camera(W, H, device)
    op = g.get_opacity[:, 0]
    proj = project(g, cam, g.max_sh_degree, op)
    b = bin_gaussians(proj, H, W, 16, cap, chunk, op)
    values = pack_values(proj.colors, build_features(g, cam),
                         10 if V == 16 else 5)
    geom, vals = blend.gather_instances(values, proj.means2d, proj.conics, op,
                                        b.gid, b.is_null)
    gy, gx = num_tiles(H, W, 16)
    return geom, vals, b, dict(T=gy * gx, grid_x=gx, width=W, height=H,
                               tile=16, chunk=chunk)


CASES = [  # (seed, n, spread, opacity, W, H, V, chunk, cap)
    (0, 3000, 1.0, 0.8, 160, 120, 16, 256, 2 ** 16),
    (1, 3000, 1.0, 0.8, 150, 113, 8, 64, 2 ** 16),     # ragged edges
    (2, 5000, 0.3, 4.0, 96, 96, 16, 128, 2 ** 17),     # deep, terminates
    (3, 2000, 1.0, 0.8, 200, 90, 8, 512, 2 ** 16),
    (4, 3000, 1.0, 0.8, 160, 120, 16, 64, 64 * 40),    # overflow
    (5, 50, 0.05, 0.8, 256, 192, 16, 256, 2 ** 12),    # mostly empty tiles
    (6, 3000, 0.3, 6.0, 128, 96, 8, 128, 2 ** 17),     # the 0.99 alpha clamp
    (7, 3000, 0.5, 2.0, 160, 120, 8, 256, 2 ** 16),    # train path: V=8, chunk 256
    # Large anisotropic Gaussians that cross many warps and tiles.
    (10, 600, 1.0, 0.8, 160, 120, 8, 256, 2 ** 17, dict(msd=0.05, aniso=1.5)),
    (11, 600, 1.0, 2.0, 144, 112, 16, 128, 2 ** 17, dict(msd=0.05, aniso=1.5)),
    # Opacities next to 1/255 (logit -5.54): the cull's empty rectangles
    # and the gate's edge at the centre pixels.
    (12, 4000, 1.0, -5.54, 160, 120, 8, 256, 2 ** 16, dict(opacity_sd=0.01)),
    # The largest chunks: 1024 at V=16 (one block per SM), 512 at V=16.
    (13, 3000, 1.0, 0.8, 160, 120, 16, 1024, 2 ** 17),
    (14, 5000, 0.3, 4.0, 96, 96, 16, 512, 2 ** 17),    # deep, terminates
    # K3's retirement at T = 0.5: a dense stack of half-transparent splats
    # that retires early, at many depths, with later chunks skipped whole;
    # and tiles that retire in their first chunk at chunk 1024.
    (15, 12000, 0.25, -1.0, 96, 96, 8, 256, 2 ** 18, dict(opacity_sd=1.0)),
    (16, 20000, 0.3, 4.0, 96, 96, 8, 1024, 2 ** 18),
]


def case_scene(case):
    """(scene params, W, H, V, chunk, cap) of one CASES row."""
    seed, n, spread, opacity, W, H, V, chunk, cap, *extra = case
    params = scene(seed, n, spread, opacity=opacity, **(extra[0] if extra else {}))
    return params, W, H, V, chunk, cap


@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_k1_matches_plain_version(cuda, case):
    seed = case[0]
    geom, vals, b, kw = k1_inputs(*case_scene(case), cuda)
    n0 = blend.LAUNCHES["blend_fwd", vals.shape[0]]
    ker = blend.blend_fwd(geom, vals, b.chunk_tile, **kw)
    torch.cuda.synchronize()
    assert blend.LAUNCHES["blend_fwd", vals.shape[0]] == n0 + 1
    ref = blend.blend_fwd_plain(geom, vals, b.chunk_tile, **kw)
    for name in ("img", "fT", "clogT"):
        a, r = getattr(ker, name), getattr(ref, name)
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-4, msg=name)
    for name in ("cdone", "obs"):
        assert torch.equal(getattr(ker, name), getattr(ref, name)), name
    if seed in (2, 14):
        assert bool((ker.cdone > 0).any())
    if seed == 4:
        assert int(b.dropped) > 0
    if seed == 12:  # opacities on both sides of 1/255
        op = geom[5][~b.is_null]
        assert bool((op < blend.ALPHA_MIN).any() and (op >= blend.ALPHA_MIN).any())
        assert bool((ker.obs > 0).any())


def test_kernel_resources(cuda):
    """K2 keeps two resident blocks per SM up to chunk 512, K3 two at every
    chunk and K1 one; none spills at the paths' chunk."""
    for V in (8, 16):
        for chunk in (256, 512, 1024):
            k2 = blend.kernel_info("blend_bwd", V, chunk)
            assert k2["blocks_per_sm"] >= (2 if chunk <= 512 else 1), (V, chunk, k2)
            k1 = blend.kernel_info("blend_fwd", V, chunk)
            assert k1["blocks_per_sm"] >= 1, (V, chunk, k1)
    for chunk in (256, 512, 1024):
        k3 = blend.kernel_info("blend_obs", 8, chunk)
        assert k3["blocks_per_sm"] >= 2, (chunk, k3)
    for name in ("blend_fwd", "blend_bwd", "blend_obs"):
        for V in (8, 16):
            assert blend.kernel_info(name, V, 256)["local_bytes"] == 0, (name, V)


def test_k1_rejects_cpu_only_shapes(cuda):
    geom = torch.zeros(8, 256, device=cuda)
    with pytest.raises(ValueError):
        blend.blend_fwd(geom, torch.zeros(12, 256, device=cuda),
                        torch.zeros(1, dtype=torch.int32, device=cuda), T=1,
                        grid_x=1, width=16, height=16, tile=16, chunk=256)


@pytest.mark.parametrize("stage", [(False, False), (True, False), (True, True)])
def test_render_on_card_matches_cpu(cuda, stage):
    params = scene(7, 4000)
    pk = {}
    for dev in ("cpu", cuda):
        g = Gaussians.from_numpy(*params, device=dev)
        pk[str(dev)] = render(g, camera(144, 104, dev),
                              torch.full((3,), 0.25, device=dev), 2,
                              geometry_stage=stage[0], material_stage=stage[1],
                              sobel_normal=True, chunk=128,
                              instance_cap=2 ** 16)
    c, d = pk["cpu"], pk["cuda"]
    for k in ("radii", "dropped", "visibility_filter"):
        assert torch.equal(d[k].cpu(), c[k]), k
    # CUDA's and the CPU's exp/log differ by an ulp here and there, and one
    # ulp at the alpha >= 1/255 gate flips a whole instance.
    for k in ("observe", "normal_mask"):
        assert float((d[k].cpu() == c[k]).float().mean()) >= 0.999, k
    # sobel_map normalizes cross products of depth differences, which scales
    # those ulps by 1/|cross| (observed up to 6e-5 on an H100): atol 1e-4.
    for k, v in c.items():
        if v.dtype.is_floating_point:
            torch.testing.assert_close(d[k].cpu(), v, rtol=1e-4,
                                       atol=1e-4 if k == "sobel_map" else 1e-5,
                                       msg=lambda m, k=k: f"{k}: {m}")


def test_binning_on_card_equals_cpu(cuda):
    """The same projection binned on both devices: exactly equal layouts."""
    g = Gaussians.from_numpy(*scene(8, 3000), device="cpu")
    op = g.get_opacity[:, 0]
    proj = project(g, camera(160, 120, "cpu"), 2, op)
    ref = bin_gaussians(proj, 120, 160, 16, 2 ** 14, 64, op)
    got = bin_gaussians(type(proj)(*[x.to(cuda) for x in proj]), 120, 160, 16,
                        2 ** 14, 64, op.to(cuda))
    for name, a, b in zip(ref._fields, ref, got):
        assert torch.equal(b.cpu(), a), name


def k2_inputs(case, device):
    """K1's carries and a seeded cotangent on the card for one CASES row."""
    seed, V = case[0], case[6]
    geom, vals, b, kw = k1_inputs(*case_scene(case), device)
    fwd = blend.blend_fwd(geom, vals, b.chunk_tile, **kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    T = kw["T"]
    g_img = torch.randn(T + 1, V, 256, generator=gen, device=device)
    gT = torch.randn(T + 1, 1, 256, generator=gen, device=device)
    g_img[T] = 0.0
    gT[T] = 0.0
    return (geom, vals, b.chunk_tile, fwd.clogT, fwd.cdone, g_img, gT,
            fwd.fT), b, kw


@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_k2_matches_plain_version(cuda, case):
    args, b, kw = k2_inputs(case, cuda)
    n0 = blend.LAUNCHES["blend_bwd", args[1].shape[0]]
    ker = blend.blend_bwd(*args, **kw)
    again = blend.blend_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert blend.LAUNCHES["blend_bwd", args[1].shape[0]] == n0 + 2
    ref = blend.blend_bwd_plain(*args, **kw)
    for name in ("dgeom", "dvals"):
        a, r = getattr(ker, name), getattr(ref, name)
        assert torch.equal(a, getattr(again, name)), name  # no atomics
        assert bool(torch.isfinite(a).all()), name
        # One ulp at a termination or gate edge flips a whole instance's
        # term: per channel row, at most 1e-4 of the entries may be off.
        scale = r.abs().amax(dim=1, keepdim=True)
        off = (a - r).abs() > 1e-4 * scale + 1e-6
        assert float(off.float().mean()) <= 1e-4, name
    if case[0] == 4:
        assert int(b.dropped) > 0
    if case[0] == 6:
        assert float(args[0][5].max()) > 0.99   # opacity row past the clamp


def skipped_chunks(fwd, chunk_tile, kw) -> int:
    """Chunks after a tile's first whose every inside pixel had retired
    (done, or logT below LOG_RETIRE) at their start, from K1's carries: K3
    skips them whole."""
    T = kw["T"]
    later = (chunk_tile < T) & torch.cat([
        torch.zeros(1, dtype=torch.bool, device=chunk_tile.device),
        chunk_tile[1:] == chunk_tile[:-1]])
    px, py = blend.pixel_coords(chunk_tile.clamp(max=T - 1).long(), 16,
                                kw["grid_x"])
    outside = (px >= kw["width"]) | (py >= kw["height"])
    retired = ((fwd.cdone[:, 0] > 0) | (fwd.clogT[:, 0] < blend.LOG_RETIRE)
               | outside)
    return int((later & retired.all(dim=1)).sum())


@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_k3_equals_plain_version_and_k1(cuda, case):
    geom, vals, b, kw = k1_inputs(*case_scene(case), cuda)
    n0 = blend.LAUNCHES["blend_obs", 0]
    obs = blend.blend_obs(geom, b.chunk_tile, **kw)
    torch.cuda.synchronize()
    assert blend.LAUNCHES["blend_obs", 0] == n0 + 1
    fwd = blend.blend_fwd(geom, vals, b.chunk_tile, **kw)
    assert torch.equal(obs, fwd.obs)
    assert torch.equal(obs, blend.blend_obs_plain(geom, b.chunk_tile, **kw))
    if case[0] in (15, 16):  # the retirement rows reach their edge
        assert skipped_chunks(fwd, b.chunk_tile, kw) > 0
        assert bool((obs > 0).any())


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("seed,shuffle", [(4, False), (11, True)])
def test_k3_at_the_half_transmittance_edge(cuda, seed, shuffle, chunk):
    """The stacks of tests/test_torch_obs_retire.py, which leave T within a
    few ulps of 0.5 at every pixel of one tile of a 48x48 image, through K3:
    count for count equal to K1's obs, which walks every pixel to
    termination with the same step and f32 adds. (The plain version is not
    held here: torch.cumsum on the card adds in another order, so at these
    ulp ties its counts differ from both kernels' by design.)"""
    from test_torch_obs_retire import GRID_X, HEIGHT, TX, TY, WIDTH, stacks
    geom = stacks(seed, shuffle)
    n_chunks = -(-geom.shape[1] // chunk) + 1    # + the dummy tile's chunk
    geom = torch.cat([geom, geom.new_zeros(
        8, n_chunks * chunk - geom.shape[1])], dim=1).to(cuda)
    T = GRID_X * (HEIGHT // 16)
    chunk_tile = torch.full((n_chunks,), TY * GRID_X + TX, dtype=torch.int32,
                            device=cuda)
    chunk_tile[-1] = T
    kw = dict(T=T, grid_x=GRID_X, width=WIDTH, height=HEIGHT, tile=16,
              chunk=chunk)
    obs = blend.blend_obs(geom, chunk_tile, **kw)
    fwd = blend.blend_fwd(geom, torch.zeros(8, geom.shape[1], device=cuda),
                          chunk_tile, **kw)
    assert torch.equal(obs, fwd.obs)
    assert bool((obs > 0).any())


@pytest.mark.parametrize("stage", [False, True])
def test_render_backward_on_card_matches_cpu(cuda, stage):
    """Leaf gradients of one render, on the card (K1, K2) and on the CPU
    (plain versions), at the distributional gradient gate."""
    params = scene(9, 3000)
    grads = {}
    for dev in ("cpu", cuda):
        g = Gaussians.from_numpy(*params, device=dev)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in g.params_dict().items()}
        sink = torch.zeros(g.capacity, 2, device=dev, requires_grad=True)
        pkg = render(g.with_params(leaves), camera(144, 104, dev),
                     torch.zeros(3, device=dev), 2, geometry_stage=stage,
                     sobel_normal=stage, chunk=128, instance_cap=2 ** 16,
                     m2d_abs_sink=sink)
        loss = (pkg["render"] - 0.3).abs().mean() + pkg["depth_map"].mean()
        if stage:
            loss = loss + (pkg["sobel_map"] - pkg["normal_map"]).abs().mean()
        names = list(leaves) + ["abs_sink"]
        out = torch.autograd.grad(loss, list(leaves.values()) + [sink],
                                  allow_unused=True)
        grads[str(dev)] = {k: (torch.zeros(1) if v is None else v.cpu())
                           for k, v in zip(names, out)}
    for k, ref in grads["cpu"].items():
        rep = grad_gate(grads["cuda"][k].numpy(), ref.numpy(),
                        tol=TOLERANCES.get(k, DEFAULT_TOL))
        assert rep["pass"], (k, rep)


def small_trainer(device, tmp_path, material: bool, geometry_from: int = 2,
                  iterations: int = 30_000):
    """A Trainer on chip_smoke's train-scene layout at 96x64 (3,000 points,
    4 views, widened neighbor thresholds); with `material` the material
    stage from geometry_from on, against a 64-texel light."""
    import chip_smoke
    from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig, PipelineConfig
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.pbr.render import make_pbr_fns
    from gs2m_tpu_torch.train.trainer import Trainer

    src = chip_smoke.build_train_scene(tmp_path, 3000, 96, 64, 4, 0)
    model = ModelConfig(source_path=str(src), resolution=1, material=material)
    opt = OptimConfig(geometry_from_iter=geometry_from, iterations=iterations,
                      multi_view_max_angle=179.0, multi_view_max_dist=100.0,
                      nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0,
                      multi_view_sample_num=2000)
    fns = make_pbr_fns(base_res=64, device=device) if material else None
    return Trainer(model, PipelineConfig(chunk=64), opt,
                   Scene(model, opt, device=device), pbr_fns=fns)


@pytest.mark.parametrize("material", [False, True], ids=["geometry", "material"])
def test_train_steps_do_not_sync_with_the_host(cuda, tmp_path, material):
    """Outside the 100-iteration boundaries a train step (warmup, geometry
    or material: renders, K1/K2, losses, the PBR pass, the reductions, Adam
    and the light's Adam) never waits for the card: torch's sync debug mode
    turns any host sync into an error."""
    trainer = small_trainer(cuda, tmp_path, material)
    for _ in range(3 if material else 1):     # warm up the lazy inits
        trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            metrics = trainer.train_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trainer.mv_active_count > 0
    assert bool(torch.isfinite(metrics["loss"]))
    if material:
        assert trainer.rough_active_count > 0 and float(metrics["Lmat"]) > 0


@pytest.mark.parametrize("material", [False, True], ids=["geometry", "material"])
def test_recorder_on_steps_do_not_sync_with_the_host(cuda, tmp_path, material):
    """With the span recorder on (utils/spans.py), train steps still never
    wait for the card: its counters keep the render packages' device
    scalars until snapshot() reads them."""
    from gs2m_tpu_torch.utils import spans

    trainer = small_trainer(cuda, tmp_path, material)
    for _ in range(3 if material else 1):     # warm up the lazy inits
        trainer.train_step()
    torch.cuda.synchronize()
    spans.reset()
    spans.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            trainer.train_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        spans.disable()
    snap = spans.snapshot()
    spans.reset()
    assert len(snap["steps"]) == 3
    renders = snap["spans"]["step/render"]["n"]
    c = snap["counters"]
    assert len(c["instances"]) == len(c["kept_instances"]) == renders >= 3
    assert all(v > 0 for v in c["instances"])
    assert all(0 < k <= i for k, i in zip(c["kept_instances"], c["instances"]))


@pytest.mark.parametrize("material", [False, True], ids=["geometry", "material"])
def test_train_steps_are_bit_reproducible(cuda, tmp_path, material):
    """Two runs of the same steps from one state (a checkpoint) on the card
    end bit-equal: loss, every parameter, the Adam moments, the densify
    statistics and, in the material stage, the light and its moments. No
    float atomics on the path (ops/gather.py, cuDNN deterministic)."""
    import chip_smoke

    trainer = small_trainer(cuda, tmp_path, material, geometry_from=1)
    trainer.train_step()
    ckpt = str(tmp_path / "ckp.pkl")
    trainer.save_checkpoint(ckpt)
    runs = []
    for _ in range(2):
        trainer.load_checkpoint(ckpt)
        for _ in range(2):
            trainer.train_step()
        torch.cuda.synchronize()
        runs.append(chip_smoke.training_state(trainer))
    assert trainer.mv_active_count > 0
    if material:
        assert trainer.rough_active_count > 0
    assert chip_smoke.differing(*runs) == []


def test_sp_render_on_card_matches_full_frame(cuda):
    """parallel/sp.py on the card: 4 bands of a 144x104 frame (padded to
    128 rows; the last band has 8 rows inside the frame) against the full
    frame, at K1's gate: radii equal, observe counts and images within the
    share K1 is held to."""
    from gs2m_tpu_torch.ops.rasterize import (build_features,
                                              rasterize_from_projected)
    from gs2m_tpu_torch.parallel.sp import make_sp_render

    g = Gaussians.from_numpy(*scene(7, 4000), device=cuda)
    cam = camera(144, 104, cuda)
    bg = torch.full((3,), 0.25, device=cuda)
    op = g.get_opacity[:, 0]
    full = rasterize_from_projected(project(g, cam, 2, op), op,
                                    build_features(g, cam), bg, cam,
                                    feature_count=9, chunk=128,
                                    instance_cap=2 ** 16)
    n0 = blend.LAUNCHES["blend_fwd", 16]
    out = make_sp_render([cuda], 4, 104, feature_count=9,
                         active_sh_degree=2, chunk=128,
                         instance_cap_per_band=2 ** 15)(g, cam, bg)
    assert blend.LAUNCHES["blend_fwd", 16] == n0 + 4
    assert int(out.dropped) == int(full.dropped) == 0
    assert torch.equal(out.radii, full.radii)
    assert float((out.observe == full.observe).float().mean()) >= 0.9999
    for k in ("color", "buffer", "final_T"):
        a, b = getattr(out, k), getattr(full, k)
        assert a.shape == b.shape, k
        assert float(((a - b).abs() > 1e-5).float().mean()) <= 1e-4, k


def test_world_of_one_dp_step_on_card_equals_the_step(cuda, tmp_path):
    """The data-parallel step in a one-rank gloo group on the card (its
    buffers staged through pinned host memory) is the single-view step, bit
    for bit: parameters, Adam moments, statistics and loss."""
    import torch.distributed as dist

    import chip_smoke
    from gs2m_tpu_torch.parallel.dp import make_dp_train_step
    from gs2m_tpu_torch.train.trainer import make_train_step

    trainer = small_trainer(cuda, tmp_path, False, geometry_from=0)
    snap = chip_smoke.snapshot(trainer)
    states = []
    for dp in (False, True):
        chip_smoke.restore(trainer, snap)
        args = (trainer.model_cfg, trainer.pipe, trainer.opt, trainer.scene,
                trainer.instance_cap, True)
        if dp:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
        try:
            step = make_dp_train_step(*args) if dp else make_train_step(*args)
            (trainer.gaussians, trainer.opt_state, trainer.stats,
             trainer.last_metrics) = step(
                trainer.gaussians, trainer.opt_state, trainer.stats, 1, 2,
                True, 1, 0, trainer.generator)
            torch.cuda.synchronize()
        finally:
            if dp:
                dist.destroy_process_group()
        states.append(chip_smoke.training_state(trainer))
    assert chip_smoke.differing(*states) == []


def test_gather_rows_backward_is_deterministic(cuda):
    """The light's scatter: many bilinear taps onto few texels, summed the
    same way on every run and equal to the CPU's sum within rounding."""
    from gs2m_tpu_torch.ops.gather import gather_rows

    gen = torch.Generator(device=cuda).manual_seed(0)
    src = torch.rand(5000, 3, generator=gen, device=cuda, requires_grad=True)
    idx = torch.randint(0, 5000, (4, 200_000), generator=gen, device=cuda)
    ct = torch.randn(4, 200_000, 3, generator=gen, device=cuda)
    grads = [torch.autograd.grad(gather_rows(src, idx), [src], ct)[0]
             for _ in range(2)]
    assert torch.equal(grads[0], grads[1])
    ref = torch.zeros(5000, 3, dtype=torch.float64).index_add_(
        0, idx.reshape(-1).cpu(), ct.reshape(-1, 3).double().cpu())
    torch.testing.assert_close(grads[0].double().cpu(), ref, rtol=1e-5,
                               atol=1e-4)


def sphere_views(device, n=8, W=96, H=72):
    """Analytic unit-sphere depths (tests/test_mesh.py's ray-sphere hit) and
    seeded colors from a ring of n cameras."""
    rng = np.random.default_rng(0)
    cams, depths = [], []
    for i in range(n):
        th = 2 * np.pi * i / n
        eye = np.array([4.0 * np.sin(th), 0.5, -4.0 * np.cos(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        cam = Camera.create(R, -R.T @ eye, 0.7, 0.55, W, H, device=device)
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        d = np.stack([(xs - W / 2) / float(cam.fx), (ys - H / 2) / float(cam.fy),
                      np.ones_like(xs)], -1) @ R.T
        b, a = np.sum(d * eye, -1), np.sum(d * d, -1)
        disc = b * b - a * (eye @ eye - 1.0)
        s = (-b - np.sqrt(np.maximum(disc, 0))) / a
        depths.append(np.where((disc > 0) & (s > 0), s, 0.0).astype(np.float32))
        cams.append(cam)
    colors = rng.uniform(0, 1, (n, 3, H, W)).astype(np.float32)
    return cams, np.stack(depths), colors


@pytest.mark.parametrize("bounds", [None, [[-2.0, 0.0], [-2.0, 2.0],
                                           [-2.0, 2.0]]], ids=["all", "bounds"])
def test_mesh_path_on_card_matches_cpu(cuda, bounds):
    """fuse_depths and marching_tetrahedra_blocks on the card: the same
    blocks, volume and faces as on the CPU (the fusion is elementwise with
    tensor divisors, so both devices round alike), vertices within 1e-6."""
    from gs2m_tpu_torch.mesh import fuse_depths, marching_tetrahedra_blocks

    out = {}
    for dev in ("cpu", cuda):
        cams, depths, colors = sphere_views(dev)
        vol = fuse_depths(depths, colors, cams, 0.05, 0.15, 8.0,
                          bounds=bounds, slab_blocks=300)
        mesh = marching_tetrahedra_blocks(vol, slab_blocks=100)
        out[str(dev)] = [t.cpu() for t in (vol.block_coords, vol.tsdf,
                                            vol.weight, vol.color, *mesh)]
    (bc, tsdf, w, col, v, f, c), ref = out["cuda"], out["cpu"]
    assert torch.equal(bc, ref[0]) and bc.shape[0] > 100
    assert torch.equal(w, ref[2])
    torch.testing.assert_close(tsdf, ref[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(col, ref[3], rtol=0, atol=1e-6)
    assert torch.equal(f, ref[5]) and f.shape[0] > 1000
    torch.testing.assert_close(v, ref[4], rtol=0, atol=1e-6)
    torch.testing.assert_close(c, ref[6], rtol=0, atol=1e-6)


# --- the per-Gaussian preprocess kernel pair (ops/preprocess.py) -------------

PRE_FLOAT = ("opacities", "features", "means2d", "depths", "conics", "colors")
PRE_INT = ("radii", "rect_min", "rect_max", "tiles_touched", "valid")


def to_card(g: Gaussians, device) -> Gaussians:
    import dataclasses

    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).to(device) for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor)})


def bench_state(device):
    """The benchmark's geometry cell state (2^19 rows, 300k alive, SH
    degree 3) and one of its cameras at the trained 800x600."""
    import json
    from pathlib import Path

    from benchmark.cellkit.scene import arc_camera, make_state
    from gs2m_tpu_torch.core.camera import focal2fov

    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "benchmark/configs/dtu-wo-brdf.json").read_text())
    st = make_state(cfg, 2 ** 31 + 5, device)
    p = st.params
    g = Gaussians(xyz=p["xyz"], features_dc=p["f_dc"],
                  features_rest=p["f_rest"], scaling=p["scaling"],
                  rotation=p["rotation"], opacity=p["opacity"],
                  albedo=p["albedo"], roughness=p["roughness"],
                  metallic=p["metallic"], alive=st.alive,
                  max_sh_degree=cfg["model"]["sh_degree"])
    s = cfg["scene"]
    R, T = arc_camera(0.3, s["camera_distance"], s["camera_height"])
    cam = Camera.create(R, T, focal2fov(s["focal_px"], s["image_width"]),
                        focal2fov(s["focal_px"], s["image_height"]),
                        s["image_width"] // 2, s["image_height"] // 2,
                        device=device)
    return g, cam, cfg["model"]["sh_degree"]


def pre_fields(out) -> dict:
    return dict(zip(PRE_FLOAT[:2] + tuple(out.proj._fields),
                    (out.opacities, out.features, *out.proj)))


def assert_preprocess_matches(got, ref):
    """The kernel's outputs against the plain path's on the card: integers
    equal, floats at the render tests' gates."""
    got, ref = pre_fields(got), pre_fields(ref)
    for k in PRE_INT:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), (
            k, int((got[k] != ref[k]).sum()))
    for k in PRE_FLOAT:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, k=k: f"{k}: {m}")


def edge_case(deg, device):
    # By module name: pytest puts tests/ on the path, and a `tests` package
    # installed elsewhere may shadow the repository's.
    from test_torch_preprocess import cpu_camera, edge_scene

    cam = cpu_camera()
    return to_card(edge_scene(deg), device), Camera(**{
        k: (v.to(device) if isinstance(v, torch.Tensor) else v)
        for k, v in vars(cam).items()})


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_preprocess_fwd_matches_plain_path_on_edge_rows(cuda, deg):
    """The forward kernel against the eager chain on the card, on the CPU
    tests' edge scene (behind the near plane, det <= 0, dead slots, scale
    ties, a colour at 0, the tanfov clamp), with and without colours."""
    from gs2m_tpu_torch.ops import preprocess as pp

    g, cam = edge_case(deg, cuda)
    n0 = blend.LAUNCHES["preprocess_fwd", 0]
    for kw in (dict(), dict(with_colors=False), dict(z_depth=True)):
        assert_preprocess_matches(pp.preprocess(g, cam, deg, **kw),
                                  pp.preprocess_plain(g, cam, deg, **kw))
    assert blend.LAUNCHES["preprocess_fwd", 0] == n0 + 3


@pytest.mark.parametrize("which", ["small", "bench"])
def test_preprocess_fwd_matches_plain_path(cuda, which):
    """At a small random scene and at the benchmark's 2^19-row state."""
    from gs2m_tpu_torch.ops import preprocess as pp

    if which == "small":
        g = Gaussians.from_numpy(*scene(21, 4000, sh_degree=3), device=cuda)
        cam, deg = camera(160, 120, cuda), 3
    else:
        g, cam, deg = bench_state(cuda)
    with torch.no_grad():
        got = pp.preprocess(g, cam, deg)
        ref = pp.preprocess_plain(g, cam, deg)
    assert bool(ref.proj.valid.any())
    assert_preprocess_matches(got, ref)


def pre_grads(fn, g, cam, deg, cot):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in g.params_dict().items()}
    out = fn(g.with_params(leaves), cam, deg)
    loss = (torch.sum(out.opacities * cot[0]) + torch.sum(out.features * cot[1])
            + torch.sum(out.proj.means2d * cot[2])
            + torch.sum(out.proj.conics * cot[3])
            + torch.sum(out.proj.colors * cot[4]))
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if d is None else d
            for (k, v), d in zip(leaves.items(), got)}


@pytest.mark.parametrize("case", ["edge0", "edge1", "edge2", "edge3", "bench"])
def test_preprocess_bwd_matches_autograd_on_card(cuda, case):
    """The backward kernel (through autograd of preprocess) against
    autograd of the eager chain on the card, and against its plain twin,
    at the distributional gate; one launch each way."""
    from gs2m_tpu_torch.ops import preprocess as pp
    from test_torch_preprocess import THIN

    if case == "bench":
        g, cam, deg = bench_state(cuda)
    else:
        deg = int(case[-1])
        g, cam = edge_case(deg, cuda)
    C = g.capacity
    gen = torch.Generator(device=cuda).manual_seed(7)
    cot = [torch.randn(C, *s, generator=gen, device=cuda)
           for s in ((), (10,), (2,), (3,), (3,))]
    if case != "bench":   # rounding noise there (test_torch_preprocess.cotangents)
        cot[2][THIN] = 0.0
        cot[3][THIN] = 0.0
    n0 = (blend.LAUNCHES["preprocess_fwd", 0], blend.LAUNCHES["preprocess_bwd", 0])
    got = pre_grads(pp.preprocess, g, cam, deg, cot)
    assert (blend.LAUNCHES["preprocess_fwd", 0],
            blend.LAUNCHES["preprocess_bwd", 0]) == (n0[0] + 1, n0[1] + 1)
    ref = pre_grads(pp.preprocess_plain, g, cam, deg, cot)
    twin = pp.preprocess_bwd_plain(g, cam, *cot, deg=deg)
    for k, r in ref.items():
        assert bool(torch.isfinite(got[k]).all()), k
        for other in (r, twin[k]):
            rep = grad_gate(got[k].cpu().numpy(), other.cpu().numpy(),
                            tol=TOLERANCES.get(k, DEFAULT_TOL))
            assert rep["pass"], (k, rep)


@pytest.mark.parametrize("material", [False, True], ids=["geometry", "material"])
def test_preprocess_launches_per_step(cuda, tmp_path, material):
    """One forward per render and one backward per differentiated render:
    geometry steps 2 / 2 (the view and its nearest), material steps 3 / 2
    (the nearby view's render is gradient-free)."""
    trainer = small_trainer(cuda, tmp_path, material)
    for _ in range(3):
        trainer.train_step()
    mv, rough = trainer.mv_active_count, trainer.rough_active_count
    before = dict(blend.LAUNCHES)
    trainer.train_step()
    torch.cuda.synchronize()
    assert trainer.mv_active_count == mv + 1
    n = {k: blend.LAUNCHES[k, 0] - before.get((k, 0), 0)
         for k in ("preprocess_fwd", "preprocess_bwd")}
    if material:
        assert trainer.rough_active_count == rough + 1
    assert n == {"preprocess_fwd": 3 if material else 2, "preprocess_bwd": 2}


@pytest.mark.parametrize("rows,count", [(4099, 0), (4099, 15_090),
                                        (524_289, 15_090)])
def test_adam_kernel_bit_equal_to_eager_loop(cuda, rows, count):
    """csrc/adam.cu against the eager loop (adam_update_plain) on the same
    card tensors over 3 steps whose LRs change: the nine groups at SH
    degree 3 of an odd row count (every group's ragged end), dead rows with
    zero moments, a group without a gradient, a group with -0.0 moments and
    an unaligned gradient (copied). p, m and v bit-equal; one launch an
    update."""
    import chip_smoke
    from gs2m_tpu_torch.train import optim

    params, grads, state, lrs = chip_smoke.adam_case(rows, cuda, 5, count)
    assert grads["xyz"].data_ptr() % 16 != 0
    ref = {k: v.clone() for k, v in params.items()}
    ref_state = optim.AdamState(
        mu={k: v.clone() for k, v in state.mu.items()},
        nu={k: v.clone() for k, v in state.nu.items()}, count=count)
    n0 = blend.LAUNCHES["adam", 0]
    for step in range(3):
        optim.adam_update(params, grads, state, lrs(step))
        optim.adam_update_plain(ref, grads, ref_state, lrs(step))
    torch.cuda.synchronize()
    assert blend.LAUNCHES["adam", 0] - n0 == 3
    assert state.count == ref_state.count == count + 3
    bits = lambda x: x.view(torch.int32)
    for what, a, b in (("p", params, ref), ("m", state.mu, ref_state.mu),
                       ("v", state.nu, ref_state.nu)):
        for k in a:
            assert torch.equal(bits(a[k]), bits(b[k])), (what, k)


@pytest.mark.parametrize("material", [False, True], ids=["geometry", "material"])
def test_adam_launches_per_step(cuda, tmp_path, material):
    """One launch of csrc/adam.cu a train step in the geometry stage, two in
    the material stage (the Gaussians' and the light's update)."""
    trainer = small_trainer(cuda, tmp_path, material)
    for _ in range(3):
        trainer.train_step()
    before = blend.LAUNCHES["adam", 0]
    trainer.train_step()
    torch.cuda.synchronize()
    assert blend.LAUNCHES["adam", 0] - before == (2 if material else 1)


def test_adam_time_counts_under_the_profiler_range_around_it(cuda):
    """The kernel is launched inside the operator gs2m::adam_, so the
    profiler ties its device time to that op and to the step/* range around
    the update, where the benchmark reads the stage's device ms."""
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from gs2m_tpu_torch.train import optim

    params, grads, state, lrs = chip_smoke.adam_case(1 << 16, cuda, 3)
    optim.adam_update(params, grads, state, lrs(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("step/update"):
            optim.adam_update(params, grads, state, lrs(1))
        torch.cuda.synchronize()
    events = prof.events()
    kernel_us = sum(e.device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and "adam_kernel" in e.name)
    span = [e for e in events if e.device_type == DeviceType.CPU
            and e.name == "step/update"]
    op = [e for e in events if e.device_type == DeviceType.CPU
          and e.name == "gs2m::adam_"]
    assert kernel_us > 0 and len(span) == 1 and len(op) == 1
    assert op[0].device_time_total == pytest.approx(kernel_us, rel=1e-6)
    assert span[0].device_time_total >= kernel_us
