"""Nothing under mvsbench/ imports JAX, the JAX package, the root
bench.py or chip_smoke.py (compared by whole top-level name: the port's
name begins with the JAX package's), and the plain reference imports
nothing of the port, directly or through mvsbench's own modules."""
import ast
import os

import pytest

from conftest import REPO

MV = os.path.join(REPO, "mvsbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "cmvs_pmvs_tpu", "bench", "chip_smoke"}


def sources():
    for base, dirs, files in os.walk(MV):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def imports(path):
    """Top-level names and mvsbench modules a file imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                out |= {"mvsbench." + (node.module or a.name)
                        for a in node.names}
            elif node.module == "mvsbench":
                out |= {"mvsbench." + a.name for a in node.names}
            else:
                out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, MV))
def test_no_jax_no_jax_package_no_drivers(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    seen, todo = set(), ["mvsbench.reference"]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        for name in imports(path):
            assert name.split(".")[0] != "cmvs_pmvs_tpu_torch", (mod, name)
            if name.startswith("mvsbench."):
                todo.append(name)
    assert "mvsbench.scene" in seen
