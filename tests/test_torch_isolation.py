"""The PyTorch port stands alone: no module of `src/repro_torch` (nor
`chip_smoke.py`, nor the port's examples `examples/*_torch.py` and
scripts `scripts/*_torch.py`, `scripts/ep_routing_probe.py`, nor the
spawned ranks of the port's worlds `tests/torch_*_ranks.py` and the card
tests `tests/test_torch_*_card.py`) imports
`jax` or the reference package `repro`, and importing the serving API,
the serving tools or the paper harness loads no JAX."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py")) \
    + sorted((ROOT / "scripts").glob("*_torch.py")) + [
        ROOT / "scripts" / "ep_routing_probe.py"] \
    + sorted((ROOT / "tests").glob("torch_*_ranks.py")) \
    + sorted((ROOT / "tests").glob("test_torch_*_card.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _assert_importing_loads_no_jax(modules: str):
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr


def test_importing_the_serving_api_loads_no_jax():
    _assert_importing_loads_no_jax(
        "repro_torch.serve.api, repro_torch.launch.serve, "
        "repro_torch.serve.frontend, repro_torch.benchmarks.traffic_gen, "
        "repro_torch.benchmarks.serve_throughput, "
        "repro_torch.benchmarks.paged_kernel_bench, "
        "repro_torch.benchmarks.quant_margin")


def test_importing_the_paper_harness_loads_no_jax():
    _assert_importing_loads_no_jax(
        "repro_torch.benchmarks.run, repro_torch.configs.sunrise_chip, "
        "repro_torch.models.resnet")
