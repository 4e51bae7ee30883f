"""The benchmark stands apart from the JAX package: no module under
``bench/`` imports ``jax``, ``jaxlib``, ``flax`` or ``repro`` (top-level
names compared whole, so ``repro_torch`` is not ``repro``), nothing under
``bench/reference/`` imports the port, and nothing reads ``benchmarks/``."""
from __future__ import annotations

import ast

import bench_testlib as lib

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def sources():
    return sorted(p for p in lib.BENCH.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_no_jax_and_no_jax_package():
    bad = {str(p.relative_to(lib.ROOT)): sorted(set(imports(p)) & FORBIDDEN)
           for p in sources()}
    assert not {k: v for k, v in bad.items() if v}
    assert len(sources()) > 20


def test_the_reference_imports_nothing_of_the_port():
    ref = [p for p in sources() if "reference" in p.parts]
    assert ref
    for p in ref:
        assert "repro_torch" not in set(imports(p)), p
        assert "repro_torch" not in p.read_text(), p


def test_nothing_reads_the_jax_benchmarks():
    for p in sources():
        if p.name == "test_bench_imports.py":
            continue
        assert "benchmarks" not in set(imports(p)), p
        assert '"benchmarks' not in p.read_text(), p
        assert "'benchmarks" not in p.read_text(), p


def test_top_level_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN
