"""A run with the timed path broken underneath comes out not correct: the
step that leaves the state unchanged, the photometric loss over half of
the image, and the blend's output altered where it is produced. The run
skips the look for a card and runs on the CPU at a small size."""
import time

import pytest

from cellkit import cells, compare, runner
from conftest import tiny_config


def run_cell(name, fault=None):
    import readings

    cfg = tiny_config(name)
    run = runner.CellRun(cfg, cells.traffic("post-densify-window"), name + "-train",
                         12345, 0.3, False, "cpu", time.perf_counter(),
                         compare.load_limits(name),
                         cells.benchmark()["end_to_end"])
    if fault is None:
        return run.run()
    with readings.planted(fault):
        return run.run()


@pytest.mark.parametrize("name", ["dtu-wo-brdf", "dtu-brdf"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_fault_is_caught(name, fault):
    out = run_cell(name, fault)
    assert out["correct"] is (fault is None), out["compared"]
