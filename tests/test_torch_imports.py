"""The port imports neither jax nor anything of the JAX package, and its
default device is CUDA: with no CUDA device the engine and the CLI raise
instead of running on the CPU."""
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cmvs_pmvs_tpu_torch  # noqa: E402
from cmvs_pmvs_tpu_torch.cli import pmvs as cli  # noqa: E402
from cmvs_pmvs_tpu_torch.device import resolve_device  # noqa: E402
from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = cmvs_pmvs_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              pkg.__name__ + ".")]


def test_every_port_module_imports_without_jax():
    mods = _port_modules() + ["chip_smoke"]
    assert len(mods) > 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "             ('jax', 'cmvs_pmvs_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-2000:]


def _port_sources():
    base = os.path.join(ROOT, "cmvs_pmvs_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(base):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    out = {}
    for path in paths:
        with open(path) as f:
            out[os.path.relpath(path, ROOT)] = f.read()
    return out


def test_no_jax_import_in_port_sources():
    for name, src in _port_sources().items():
        assert "import jax" not in src and "from jax" not in src, name


def test_no_jax_package_reference_in_port_sources():
    """No module path of the JAX package (`cmvs_pmvs_tpu.` followed by a
    name; the port's own `cmvs_pmvs_tpu_torch` does not match) and no
    bare import of it, the native extension included."""
    srcs = _port_sources()
    assert len(srcs) > 20
    for name, src in srcs.items():
        for needle in ("cmvs_pmvs_tpu.", "from cmvs_pmvs_tpu ",
                       "import cmvs_pmvs_tpu\n", "import cmvs_pmvs_tpu ",
                       "_native"):
            assert needle not in src, (name, needle)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_requires_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        PMVSEngine(scene=None, opt=None)


def test_cli_default_device_raises_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path), "option.txt"])
