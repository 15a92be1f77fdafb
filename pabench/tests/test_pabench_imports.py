"""What the benchmark may load: neither JAX nor the JAX package in a run
(top-level module names compared whole, since the port's name begins
with the JAX package's), nothing of the program in the reference, and
none of the JAX package's benchmark files."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from pabench import harness

PKG = Path(harness.__file__).resolve().parent
ROOT = PKG.parent
PLAIN = ["fields.py", "compare.py", *[f"reference/{p.name}" for p in
                                      sorted((PKG / "reference").glob("*.py"))]]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, 0) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pencilarrays_tpu_torch_fake",
                        sys.modules["json"])
    assert "pencilarrays_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "pencilarrays_tpu.ops",
                        sys.modules["json"])
    found = harness.forbidden_modules()
    assert "jax" in found and "pencilarrays_tpu" in found


@pytest.mark.parametrize("rel", PLAIN)
def test_reference_imports_nothing_of_the_program(rel):
    allowed = {"__future__", "typing", "torch", "numpy", "math"}
    for module, level in _imports(PKG / rel):
        top = module.split(".")[0]
        assert level > 0 or top in allowed, f"{rel} imports {module}"
        if level > 0:
            assert module.split(".")[0] in ("", "fields", "compare",
                                            "ns_step", "fft_roundtrip",
                                            "transpose_cycle"), module


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    script = (
        "import json, sys, time\n"
        "import pabench.reference.ns_step, pabench.reference.fft_roundtrip\n"
        "import pabench.reference.transpose_cycle\n"
        "plain = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from pabench import harness\n"
        "wl, cfg = harness.find_cell('cycle1024.alltoall')\n"
        "cfg = dict(cfg, grid=[8, 6, 4])\n"
        "r = harness.run_cell(wl, cfg, 3, 0.1, True, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps({'plain': plain, 'found':"
        " harness.forbidden_modules(), 'correct': r['correct'],"
        " 'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and got["found"] == []
    assert "pencilarrays_tpu_torch" in got["tops"]
    assert "pencilarrays_tpu_torch" not in got["plain"]
    assert not {"jax", "jaxlib", "flax", "pencilarrays_tpu"} & set(
        got["tops"])


def test_harness_reads_none_of_the_jax_package_benchmark_files():
    words = ("bench.py", "benchmarks/", "BENCH_", "BASELINE.json",
             "MULTICHIP_")
    for p in PKG.rglob("*"):
        if p.is_file() and "tests" not in p.relative_to(PKG).parts \
                and p.suffix in (".py", ".json"):
            text = p.read_text()
            assert not [w for w in words if w in text], p
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["paths"] == [
        "pabench"]
