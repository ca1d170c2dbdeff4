"""The Adam kernel's wrapper on the CPU (train/optim.py): the group table
csrc/adam.cu takes (tensors, LRs, each group's block range; 16-byte
alignment required in place, gradients copied to it), the float32 host
scalars against numpy, the refusals, the dispatch, the operator gs2m::adam_
that launches it, the launch counter's module, the table on states that the
trainer's row surgery leaves, and chip_smoke.py's AdamTap. The kernel itself
runs only on a card (tests/test_torch_cuda.py holds it bit-equal to the
eager loop there); the eager loop on CPU tensors is held to the JAX package
by tests/test_torch_train.py::test_adam_and_schedules_match_jax.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from gs2m_tpu_torch import launches
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.ops import blend
from gs2m_tpu_torch.pbr import render as pbr_render
from gs2m_tpu_torch.train import densify as D
from gs2m_tpu_torch.train import optim
from gs2m_tpu_torch.train import trainer as trainer_mod

CSRC = Path(optim.__file__).resolve().parent.parent / "csrc" / "adam.cu"


def _const(name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);",
                     CSRC.read_text()).group(1)


def test_constants_match_the_kernel_source():
    assert int(_const("kMaxGroups")) == optim.ADAM_MAX_GROUPS
    threads, vec = int(_const("kThreads")), int(_const("kVec"))
    assert _const("kBlockElems") == "kThreads * kVec"
    assert threads * vec == optim.ADAM_BLOCK


def test_table_of_the_nine_groups():
    """Each group in the params' order: its tensors, its LR in float32, and
    blocks [first[k], first[k+1]) covering its elements in ADAM_BLOCK runs,
    the grid's size last; metallic without a gradient; xyz's unaligned
    gradient copied to an aligned one of the same values."""
    rows = 4099
    params, grads, state, lrs = chip_smoke.adam_case(rows, "cpu", 1)
    table = optim.adam_table(params, grads, state, lrs(2))
    n = [p.numel() for p, _, _, _ in table.tensors]
    assert n == [rows * int(np.prod(w))
                 for w in chip_smoke.ADAM_WIDTHS.values()]
    assert sum(n) == rows * 64
    assert table.lr == [np.float32(lr) for lr in lrs(2).values()]
    assert all(type(lr) is np.float32 for lr in table.lr)
    first = optim.adam_blocks(n)
    blocks = np.diff(first)
    assert first[0] == 0
    assert list(blocks) == [-(-k // optim.ADAM_BLOCK) for k in n]
    assert all((b - 1) * optim.ADAM_BLOCK < k <= b * optim.ADAM_BLOCK
               for b, k in zip(blocks, n))
    assert [g is None for _, g, _, _ in table.tensors] == [
        k == "metallic" for k in params]
    for (p, g, m, v), k in zip(table.tensors, params):
        assert p is params[k] and m is state.mu[k] and v is state.nu[k]
        assert g is None or (g is grads[k]) == (k != "xyz")
        assert g is None or (g.data_ptr() % 16 == 0 and torch.equal(
            g, grads[k]))
    assert grads["xyz"].data_ptr() % 16 != 0


def _group(n: int, shift: str = "", grad: bool = True):
    """One group of n elements; `shift` names the tensor placed one float
    past a 16-byte boundary."""
    def t(name):
        buf = torch.arange(n + 4, dtype=torch.float32)
        return buf[1:n + 1] if name == shift else buf[:n]
    p, g, m, v = (t(x) for x in "pgmv")
    state = optim.AdamState(mu={"a": m}, nu={"a": v}, count=0)
    return {"a": p}, {"a": g if grad else None}, state


@pytest.mark.parametrize("n,grad", [(1024, True), (4, True), (4097, True),
                                    (3, True), (1, False)])
def test_block_ranges_of_aligned_groups(n, grad):
    params, grads, state = _group(n, "", grad)
    table = optim.adam_table(params, grads, state, {"a": 0.1})
    assert table.tensors[0][1] is grads["a"]
    assert optim.adam_blocks([n]) == [0, -(-n // optim.ADAM_BLOCK)]


@pytest.mark.parametrize("shift,what", [("p", "param"),
                                        ("m", "first moment"),
                                        ("v", "second moment")])
def test_refuses_what_is_written_in_place_unless_aligned(shift, what):
    params, grads, state = _group(1024, shift)
    with pytest.raises(ValueError, match=f"the {what} of a.*16-byte aligned"):
        optim.adam_table(params, grads, state, {"a": 0.1})


@pytest.mark.parametrize("n", [1, 1024])
def test_copies_an_unaligned_gradient(n):
    params, grads, state = _group(n, "g")
    table = optim.adam_table(params, grads, state, {"a": 0.1})
    g = table.tensors[0][1]
    assert g is not grads["a"] and g.data_ptr() % 16 == 0
    assert torch.equal(g, grads["a"])


def test_adam_blocks_of_several_groups():
    n = [1, optim.ADAM_BLOCK, optim.ADAM_BLOCK + 1, 3 * optim.ADAM_BLOCK]
    assert optim.adam_blocks(n) == [0, 1, 2, 4, 7]
    assert optim.adam_blocks([]) == [0]


def test_scalars_are_float32_as_eager_cuda_rounds_them():
    """b1, b2, 1-b1, 1-b2 and eps are the Python floats rounded to float32;
    1/c1 and 1/c2 the float32 reciprocals of the float32 bias corrections,
    as numpy computes them in float32."""
    b1, b2, eps = 0.9, 0.999, 1e-15
    f = np.float32
    for count in (1, 2, 3, 100, 15_090, 30_000):
        got = optim.adam_scalars(count, b1, b2, eps)
        assert all(type(x) is np.float32 for x in got)
        c1 = f(1.0) - np.power(f(b1), f(count))
        c2 = f(1.0) - np.power(f(b2), f(count))
        want = (f(b1), f(b2), f(1 - b1), f(1 - b2), f(1.0) / c1,
                f(1.0) / c2, f(eps))
        assert [x.tobytes() for x in got] == [x.tobytes() for x in want], count
    assert optim.adam_scalars(1, b1, b2, eps)[2] == f(0.1)


def _case():
    return chip_smoke.adam_case(37, "cpu", 2)


def _refused(params, grads, state, match):
    lrs = {k: 0.1 for k in params}
    with pytest.raises(ValueError, match=match):
        optim.adam_table(params, grads, state, lrs)


@pytest.mark.parametrize("which", ["param", "first moment", "second moment"])
def test_refuses_what_is_written_in_place_unless_contiguous(which):
    params, grads, state, _ = _case()
    x = torch.zeros(3, 37).t()
    if which == "param":
        params["scaling"] = x
    else:
        (state.mu if which == "first moment" else state.nu)["scaling"] = x
    _refused(params, grads, state, f"the {which} of scaling.*contiguous")


@pytest.mark.parametrize("which", ["param", "gradient", "first moment",
                                   "second moment"])
def test_refuses_a_wrong_dtype(which):
    params, grads, state, _ = _case()
    d = {"param": params, "gradient": grads, "first moment": state.mu,
         "second moment": state.nu}[which]
    d["opacity"] = d["opacity"].double()
    _refused(params, grads, state, f"the {which} of opacity must be a float32")


def test_refuses_a_gradient_of_another_shape():
    params, grads, state, _ = _case()
    grads["rotation"] = grads["rotation"][:-1]
    _refused(params, grads, state, "the gradient of rotation must be")


@pytest.mark.parametrize("groups", [0, optim.ADAM_MAX_GROUPS + 1])
def test_refuses_a_group_count_outside_the_table(groups):
    params = {f"g{i}": torch.zeros(5) for i in range(groups)}
    _refused(params, {}, optim.adam_init(params), "1 to 16 groups")


def test_takes_most_groups_the_table_holds():
    params = {f"g{i}": torch.zeros(5) for i in range(optim.ADAM_MAX_GROUPS)}
    table = optim.adam_table(params, {}, optim.adam_init(params),
                             dict.fromkeys(params, 0.1))
    assert len(table.tensors) == optim.ADAM_MAX_GROUPS
    assert optim.adam_blocks([p.numel() for p, _, _, _ in table.tensors]) == (
        list(range(optim.ADAM_MAX_GROUPS + 1)))


def test_gradients_are_copied_contiguous_and_unchanged():
    params, grads, state, lrs = _case()
    g = torch.arange(45 * 37, dtype=torch.float32).reshape(45, 37)
    grads["f_rest"] = g.t().unflatten(1, (15, 3))
    assert not grads["f_rest"].is_contiguous()
    table = optim.adam_table(params, grads, state, lrs(0))
    got = table.tensors[list(params).index("f_rest")][1]
    assert got.is_contiguous() and torch.equal(got, grads["f_rest"])
    assert got.data_ptr() % 16 == 0


def test_cpu_tensors_run_the_eager_loop_and_launch_nothing():
    params, grads, state, lrs = _case()
    ref = {k: v.clone() for k, v in params.items()}
    ref_state = optim.AdamState(
        mu={k: v.clone() for k, v in state.mu.items()},
        nu={k: v.clone() for k, v in state.nu.items()}, count=0)
    before = dict(blend.LAUNCHES)
    for step in range(2):
        optim.adam_update(params, grads, state, lrs(step))
        optim.adam_update_plain(ref, grads, ref_state, lrs(step))
    assert blend.LAUNCHES == before
    assert state.count == ref_state.count == 2
    for a, b in ((params, ref), (state.mu, ref_state.mu),
                 (state.nu, ref_state.nu)):
        for k in a:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))


def test_other_devices_raise():
    p = {"a": torch.zeros(4, device="meta")}
    with pytest.raises(ValueError, match="cuda or cpu, not meta"):
        optim.adam_update(p, {}, optim.adam_init(p), {"a": 0.1})


def test_table_takes_the_states_that_row_surgery_leaves():
    """The trainer's row surgery (densify and prune, the observe trim,
    capacity growth, opacity reset) leaves parameters and moments that the
    kernel takes as they are: contiguous and 16-byte aligned."""
    rng = np.random.default_rng(4)
    C, n = 64, 40
    raw = {k: rng.normal(size=(C, *w)).astype(np.float32)
           for k, w in chip_smoke.ADAM_WIDTHS.items()}
    g = Gaussians.from_numpy(raw, np.arange(C) < n, 3, device="cpu")
    state = optim.adam_init(g.params_dict())
    stats = dataclasses.replace(D.DensifyStats.zeros(C, "cpu"),
                                accum=torch.full((C,), 1.0),
                                denom=torch.ones(C))

    def check(g, state):
        params = g.params_dict()
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        table = optim.adam_table(params, grads, state,
                                 dict.fromkeys(params, 0.1))
        assert len(table.tensors) == len(params)

    g, state, stats, _ = D.densify_and_prune(
        g, state, stats, 1e-4, 1e-4, 0.005, 4.0, 0.01, 20.0,
        generator=torch.Generator().manual_seed(0))
    check(g, state)
    g, state, stats = D.prune_rows(g, state, stats,
                                   torch.from_numpy(rng.uniform(size=C) < .2))
    check(g, state)
    g, state, stats = D.grow_capacity(g, state, stats, 96)
    check(g, state)
    g, state = D.reset_opacity(g, state)
    check(g, state)


def test_the_operator_mutates_params_and_moments_and_has_no_cpu_kernel():
    """gs2m::adam_ declares p, m and v written in place (the profiler and
    the dispatcher see an in-place op) and runs only on CUDA tensors: the
    CPU path never reaches it."""
    schema = str(torch.ops.gs2m.adam_.default._schema)
    assert schema == ("gs2m::adam_(Tensor(a!)[] params, Tensor?[] grads, "
                      "Tensor(b!)[] mu, Tensor(c!)[] nu, float[] lrs, "
                      "float[] coef) -> ()")
    x = [torch.zeros(4)]
    with pytest.raises(NotImplementedError):
        torch.ops.gs2m.adam_(x, [None], x, x, [0.1], [0.0] * 7)


def test_launch_counter_lives_in_its_own_module():
    """ops/blend.py re-exports the counter that every wrapper counts in;
    launch_counts names every kernel, Adam's included."""
    assert blend.LAUNCHES is launches.LAUNCHES
    assert blend.launch_counts is launches.launch_counts
    assert blend.KERNELS == launches.KERNELS
    assert blend.LAUNCH_LOG_ENV == launches.LAUNCH_LOG_ENV
    assert optim.LAUNCHES is launches.LAUNCHES
    before = launches.launch_counts()
    assert set(before) == set(launches.KERNELS) and "adam" in before
    launches.LAUNCHES["adam", 0] += 2
    try:
        assert launches.launch_counts()["adam"] == before["adam"] + 2
    finally:
        launches.LAUNCHES["adam", 0] -= 2


def test_tap_keeps_the_named_update_and_restores_the_modules():
    """chip_smoke.AdamTap stands in for adam_update where the trainer and
    the light's update call it, counts each set of groups' updates, and
    keeps clones of the inputs and outputs of the update it was asked
    for."""
    saved = (trainer_mod.adam_update, pbr_render.adam_update)
    params, grads, state, lrs = _case()
    light = {"light": torch.ones(6)}
    light_state = optim.adam_init(light)
    with chip_smoke.AdamTap("cpu", {"xyz": 2, "light": 1}) as tap:
        assert trainer_mod.adam_update == tap.update
        assert pbr_render.adam_update == tap.update
        trainer_mod.adam_update(params, grads, state, lrs(0))
        before = chip_smoke.adam_clone(params, grads, state)
        pbr_render.adam_update(light, {"light": torch.ones(6)}, light_state,
                               {"light": 0.5})
        trainer_mod.adam_update(params, grads, state, lrs(1))
        after = chip_smoke.adam_clone(params, {}, state)
        trainer_mod.adam_update(params, grads, state, lrs(2))
    assert (trainer_mod.adam_update, pbr_render.adam_update) == saved
    assert tap.calls == {"xyz": 3, "light": 1}
    assert tap.launches == {"xyz": 0, "light": 0}    # CPU: the eager loop
    (p, g, s), (p2, s2), kept_lrs, _, _ = tap.kept["xyz"]
    assert kept_lrs == lrs(1) and s.count == 1 and s2.count == 2
    assert not any(chip_smoke.adam_bits_differ((p, s), before[::2]).values())
    assert not any(chip_smoke.adam_bits_differ((p2, s2), after[::2]).values())
    assert all(torch.equal(g[k], grads[k]) for k in grads
               if grads[k] is not None)
    assert tap.kept["light"][0][2].count == 0
