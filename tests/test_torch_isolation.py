"""The port stands alone: no module of gs2m_tpu_torch, and not chip_smoke.py,
imports JAX or anything of the JAX package (gs2m_tpu_torch itself is fine),
and no string constant of theirs names a JAX package module (`gs2m_tpu.`
followed by a module name), which a runner would launch with `python -m`.

An AST scan, not a sys.modules check: the test process has JAX loaded for
the comparison tests.
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gs2m_tpu")
SOURCES = sorted((ROOT / "gs2m_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_has_its_modules():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for mod in ("__init__", "core/config", "core/sh", "core/camera",
                "core/gaussians", "data/ply", "data/colmap", "data/readers",
                "data/scene", "ops/projection", "ops/binning", "ops/blend",
                "ops/rasterize", "ops/normals", "models/render",
                "utils/images", "apps/render",
                # training slice
                "ops/knn", "ops/ssim", "ops/grid_sample", "models/losses",
                "train/optim", "train/densify", "train/trainer",
                "train/reporting", "utils/grad_gate", "apps/train",
                # mesh path, metrics, quality gate
                "mesh/__init__", "mesh/tsdf", "mesh/marching",
                "mesh/cluster", "apps/metrics", "apps/quality_gate",
                # material stage
                "ops/gather", "pbr/__init__", "pbr/cubemap", "pbr/shade",
                "pbr/bsdf", "pbr/render", "apps/material_gate",
                # parallelism
                "parallel/__init__", "parallel/dp", "parallel/sp",
                # the last surface: LPIPS and the viewer bridge
                "utils/lpips", "apps/network_gui",
                # the benchmark harness
                "apps/eval_dtu", "apps/run_dtu", "apps/report_dtu",
                "apps/eval_tnt", "apps/convert_json", "apps/run_tnt",
                "apps/run_shiny", "apps/run_glossy", "apps/vis_turntable",
                # the per-Gaussian preprocess kernel pair
                "ops/preprocess"):
        assert f"gs2m_tpu_torch/{mod}.py" in names, mod


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


JAX_MODULE = re.compile(r"\bgs2m_tpu\.[A-Za-z_]")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_string_names_a_jax_package_module(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not JAX_MODULE.search(node.value), (
                f"{path.name}:{node.lineno} names a JAX package module: "
                f"{node.value[:80]!r}")


def test_string_scan_sees_a_module_launch():
    tree = ast.parse('run([sys.executable, "-m", "gs2m_tpu.apps.train"])\n'
                     'x = f"-m gs2m_tpu.apps.{name}"\n'
                     'ok = ["gs2m_tpu_torch.apps.train", "gs2m_tpu/ops/a.py"]')
    hits = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and JAX_MODULE.search(n.value)]
    assert sorted(hits) == ["-m gs2m_tpu.apps.", "gs2m_tpu.apps.train"]
