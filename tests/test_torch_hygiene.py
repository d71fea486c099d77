"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its engine runs on the GPU unless the caller asks for the
CPU.  Few test items per file (see tests/test_torch_kernels.py for
why)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "feathercnn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "feathercnn_tpu")


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return mods


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _port_modules())
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
            + "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_source_imports_jax():
    """Nor does it load the JAX package's native library or build it: the
    port builds its own C++ copy (``native_csrc/``)."""
    for path in _sources():
        text = path.read_text()
        assert "libfeatherio" not in text and '"make"' not in text, path
        tree = ast.parse(text, str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, \
                    f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def test_engine_without_device_raises_on_a_host_without_gpu():
    import torch

    from feathercnn_tpu_torch.engine import Engine
    from feathercnn_tpu_torch.models import resnet50

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    g = resnet50()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g)
    with pytest.raises(RuntimeError):
        Engine(g, device="cuda")
    assert Engine(g, device="cpu").device.type == "cpu"


def test_cuda_tensor_wrappers_never_take_the_plain_version():
    """The wrappers pick the plain version by the tensor's device alone:
    the source holds no ``try`` around a launch."""
    for name in ("matmul.py", "conv.py", "depthwise.py", "fused_chain.py",
                 "ident.py", "eltwise.py", "stem.py"):
        tree = ast.parse((PORT / "kernels" / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


def _imported(path: Path, inside_functions: bool = False):
    """The absolute module names ``path`` imports (``from a import b`` as
    both ``a`` and ``a.b``); with ``inside_functions``, only those of the
    imports made inside a function."""
    tree = ast.parse(path.read_text(), str(path))
    if inside_functions:
        tree = ast.Module(body=[n for n in ast.walk(tree) if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))], type_ignores=[])
    package = list(path.relative_to(ROOT).with_suffix("").parts[:-1])
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] \
                if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names.add(mod)
            names.update(f"{mod}.{a.name}" for a in node.names)
    return names


def test_imports_run_one_way():
    """``numerics.py`` is the bottom layer (it imports nothing of the
    package); the kernels and the sharded collectives and convs import no
    op lowering; ``ops/lowering.py`` imports the kernels at module level,
    so no cycle is broken inside a function."""
    def under(names, prefix):
        return sorted(n for n in names
                      if n == prefix or n.startswith(prefix + "."))

    ops = "feathercnn_tpu_torch.ops"
    assert not under(_imported(PORT / "numerics.py"), "feathercnn_tpu_torch")
    lower = [PORT / "parallel" / f"{m}.py"
             for m in ("spatial", "tp", "dist", "overlap", "mesh")]
    for path in sorted((PORT / "kernels").glob("*.py")) + lower:
        assert not under(_imported(path), ops), path.relative_to(ROOT)
    assert not under(_imported(PORT / "ops" / "lowering.py", True),
                     "feathercnn_tpu_torch.kernels")
