"""No source of the benchmark imports JAX or the JAX package; the generator,
the reference and the roofline import nothing of the program either. Top-
level names are compared whole: the program's name, ``hiphase_tpu_torch``,
begins with the JAX package's."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "hiphase_tpu"}


def sources(*parts):
    root = os.path.join(BENCH, *parts)
    if os.path.isfile(root):
        yield root
        return
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, BENCH), name)
             for p in sources() for name in top_level_imports(p)
             if name in JAX}
    assert not found


def test_generator_reference_and_roofline_import_nothing_of_the_program():
    found = {(os.path.relpath(p, BENCH), name)
             for part in (("sim",), ("reference",), ("roofline.py",))
             for p in sources(*part) for name in top_level_imports(p)
             if name == "hiphase_tpu_torch"}
    assert not found


def test_run_checks_whole_module_names(monkeypatch):
    import sys

    import run
    monkeypatch.setitem(sys.modules, "hiphase_tpu_torch_like", object())
    assert "hiphase_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
