"""Two data-parallel ranks of the port on the CPU (gloo) in the material
stage, against the JAX package's make_dp_train_step on a 2-device CPU mesh
(tests/test_parallel.py:184-250's case: the light's gradient is the mean
of the views') and against one process. The pixel draws are the same
seeded top-k in both packages; the checks are tests/test_torch_dp2.py's.
"""
import pytest

from tests.test_torch_dp2 import (build_scene, check_one_process_mean,
                                  check_step_matches_jax, dp_step_runs)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp2_material")
    return dp_step_runs(build_scene(root), root / "steps", ("material",))


def test_dp_material_step_matches_jax(step_runs):
    check_step_matches_jax(step_runs, "material")


def test_dp_material_step_is_the_one_process_mean(step_runs):
    check_one_process_mean(step_runs, "material")
