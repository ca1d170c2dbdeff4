"""The control: the reference computed with TF32 (the precision below the
configurations' float32 with TF32 off) in the program's place is not
correct, at the cells' own size (a few seconds a seed on the card)."""
import pytest

from cellkit import cells, compare, runner
from cellkit import scene as S

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["dtu-wo-brdf", "dtu-brdf"])
def test_tf32_reference_fails(cuda, name):
    import readings

    cfg = cells.config(name)
    n = cells.traffic("post-densify-window")["compared_steps"]
    failed = []
    for seed in (1, 2, 3):
        scene, state = S.make_scene(cfg, seed, cuda), S.make_state(cfg, seed, cuda)
        _, ref = runner.reference_steps(cfg, scene, state, seed, n)
        with readings.tf32():
            _, low = runner.reference_steps(cfg, scene, state, seed, n)
        ok, rows = compare.judge(compare.numbers(low, ref),
                                 compare.load_limits(name))
        failed.append(not ok)
    assert all(failed)
