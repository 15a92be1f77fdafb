"""The benchmark's data: every cell finds its configuration, driver,
reference and limits by name; every name and unit keeps to the allowed
characters; a new cell and a new metric are new files and no edit."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pabench import harness

PKG = Path(harness.__file__).resolve().parent
ROOT = PKG.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (PKG / "workloads").glob("*.json"))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_finds_config_driver_reference_and_limits(name):
    wl, cfg = harness.find_cell(name)
    assert wl["name"] == name and cfg["name"] == wl["config"]
    assert (PKG / "drivers" / f"{wl['driver']}.py").is_file()
    assert (PKG / "reference" / f"{wl['driver']}.py").is_file()
    assert hasattr(harness.driver(wl["driver"]), "setup")
    assert wl["limits"] and all(isinstance(v, (int, float))
                                for v in wl["limits"].values())
    assert wl["chips"] in (1, 4) and _line(wl["why"])
    for key in cfg["reduced"]:
        assert key in cfg, f"{cfg['name']} reduces {key!r}, which it lacks"


def test_manifest_agrees_with_the_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert sorted(cells) == WORKLOADS
    configs = {c["name"]: c for c in BENCH["configs"]}
    for name, cell in cells.items():
        wl = harness.load("workloads", name)
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (wl["config"], wl["traffic"], wl["chips"], wl["why"])
    for name, c in configs.items():
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == name and c["file"].startswith("pabench/")
        assert (c["source"], c["reduced"]) == (cfg["source"], cfg["reduced"])
    assert {c["config"] for c in cells.values()} == set(configs)
    readers = harness.metric_readers()
    for m in BENCH["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        assert set(m["workloads"]) <= set(cells)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}


def test_names_units_and_lines_keep_to_the_contract():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
               for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    lines = [c["source"] for c in BENCH["configs"]]
    lines += [c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
    lines += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(_line(s) for s in lines)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in PKG.rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_new_cell_config_and_metric_are_found_in_a_copy_with_no_edit(
        tmp_path):
    copy = tmp_path / "pabench"
    shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in copy.rglob("*") if p.is_file()}
    cfg = json.loads((copy / "configs" / "pencil1024_f32.json").read_text())
    cfg.update(name="pencil_tiny", grid=[12, 10, 8])
    (copy / "configs" / "pencil_tiny.json").write_text(json.dumps(cfg))
    wl = json.loads((copy / "workloads" / "cycle1024.ring.json").read_text())
    wl.update(name="tiny.ring", config="pencil_tiny")
    (copy / "workloads" / "tiny.ring.json").write_text(json.dumps(wl))
    (copy / "metrics" / "steps_seen.py").write_text(
        'UNIT = "1"\n\n\ndef read(w):\n    return float(w.steps)\n')
    script = (
        "import json, time\n"
        "from pabench import harness\n"
        "wl, cfg = harness.find_cell('tiny.ring')\n"
        "r = harness.run_cell(wl, cfg, 2**33 + 5, 0.2, True, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps({'file': harness.__file__,"
        " 'correct': r['correct'], 'metrics': sorted(r['metrics'])}))\n")
    env_path = f"{tmp_path}:{ROOT}"
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(copy))
    assert got["correct"] is True
    assert "steps_seen" in got["metrics"]
    after = {p.relative_to(copy): p.read_bytes()
             for p in copy.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before

