"""The port's public names against the reference's, module by module.

Each module of `src/repro/` with a counterpart at the same path in
`src/repro_torch/` is parsed (by AST, importing neither package); every
public top-level name of the reference module (functions, classes,
assignments, and in an `__init__.py` the names it re-exports; not a
module's logger, `log = get_logger(...)`, which no caller imports) must be a
top-level name of the port's module, unless `WAITING` lists it with the
ROADMAP.md queue A item it waits for: A.7 (the paper side's XLA tools).  A caller of the reference's API would otherwise get an
ImportError or AttributeError from the port.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

A7 = "A.7 (item 14): the XLA tools"

# module (relative path) -> {name: the queue A item it waits for}
WAITING = {
    "configs/__init__.py": {n: A7 for n in (
        "shape_applicable", "applicable_cells", "input_specs",
        "param_specs", "prefill_batch_specs", "cache_specs")},
    "configs/base.py": {n: A7 for n in (
        "shape_applicable", "applicable_cells", "input_specs",
        "param_specs", "prefill_batch_specs", "cache_specs",
        "decode_token_specs")},
    "configs/sunrise_chip.py": {"TARGET": A7},
    "core/__init__.py": {"TPU_V5E": A7},
    "core/hwmodel.py": {"TPU_V5E": A7, "TpuTarget": A7},
    "launch/cells.py": {n: A7 for n in (
        "Cell", "active_params", "attention_flops", "model_flops",
        "build_cell", "lower_cell")},
    "serve/serve_step.py": {n: A7 for n in (
        "HLO_PROBE_GEOM", "bulk_attn_shapes", "lowered_paged_hlo")},
    "serve/sharded/__init__.py": {"lowered_sharded_hlo": A7},
    "serve/sharded/serve_step.py": {"lowered_sharded_hlo": A7},
}

MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                 if (PORT / p.relative_to(REF)).exists())


def _is_logger(value: ast.expr) -> bool:
    """`get_logger(...)`: a module's own logger."""
    return (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id == "get_logger")


def public_names(path: Path) -> set[str]:
    """Top-level public names of a module: defs, classes and assigned
    names, plus the names an `__init__.py` imports (its re-exports)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign) and not _is_logger(node.value):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_the_modules_with_a_counterpart_are_found():
    assert len(MODULES) >= 40
    for rel in ("serve/kv_cache.py", "serve/serve_step.py",
                "serve/__init__.py", "models/__init__.py"):
        assert rel in MODULES
    assert set(WAITING) <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_of_the_reference_is_in_the_port(rel):
    ref = public_names(REF / rel)
    port = public_names(PORT / rel)
    waiting = WAITING.get(rel, {})
    assert all("A.7" in item for item in waiting.values())
    # a name listed as waiting must be a reference name the port lacks
    missing = ref - port
    assert set(waiting) <= ref, f"{rel}: not reference names: " \
        f"{sorted(set(waiting) - ref)}"
    assert not set(waiting) & port, f"{rel}: ported now, drop from " \
        f"WAITING: {sorted(set(waiting) & port)}"
    assert missing <= set(waiting), f"{rel}: the port lacks " \
        f"{sorted(missing - set(waiting))}"
