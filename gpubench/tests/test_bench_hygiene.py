"""What the benchmark may import and read: never JAX or the JAX package
(top-level names compared whole: ``feathercnn_tpu_torch`` is the port and
not ``feathercnn_tpu``), the reference nothing of the program, and nothing
the repository's older benchmark of the JAX package wrote."""

import ast
import sys
from pathlib import Path

import pytest

from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "feathercnn_tpu"}
SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def strings(path: Path):
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "feathercnn_tpu_torch" not in imported(path)
    assert not imported(path) & {"program", "run", "harness"}


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reads_nothing_of_the_old_benchmark(path):
    for s in strings(path):
        parts = s.replace("\\", "/").split("/")
        assert "bench" not in parts and "bench.py" not in parts, s
        assert not any(p.startswith("BENCH_") for p in parts), s


def test_only_program_reaches_the_program():
    reach = [p.relative_to(BENCH_DIR).as_posix() for p in SOURCES
             if "feathercnn_tpu_torch" in imported(p)]
    assert reach == ["program.py"]


def test_the_runtime_check_compares_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "feathercnn_tpu_torch.engine", sys)
    assert "feathercnn_tpu_torch" not in run.forbidden_modules()
    assert "feathercnn_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "feathercnn_tpu.engine", sys)
    assert "feathercnn_tpu" in run.forbidden_modules()


def test_a_reader_that_loads_jax_refuses_the_run(small, bench, tmp_path,
                                                 monkeypatch):
    """The look at ``sys.modules`` comes after the per-layer readers and
    the reference have run: a reader that pulls in (a stub of) ``jax``
    refuses the run."""
    import copy

    import run
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    (small / "metrics" / "loads_jax.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(trace):\n    return 1.0\n")
    b = copy.deepcopy(bench)
    b["per_layer"].append({"name": "loads_jax", "unit": "%",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine", "moves": "images_per_s",
                           "workloads": ["mobilenet_v1_w8a8.offline"]})
    had = "jax" in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            run.run_cell(b, "mobilenet_v1_w8a8.offline", 3, 0.5, True, "cpu",
                         bench_dir=small, t_start=0.0)
    finally:
        if not had:
            sys.modules.pop("jax", None)
