"""The manifest resolves every piece by name, and new pieces are new files."""

import json
import re
import shutil
import sys

import pytest

from benchmark.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_resolves():
    man = Manifest()
    for name, cell in man.cells.items():
        cfg = man.config(cell["config"])
        traffic = man.traffic(cell["traffic"])
        assert cfg["name"] == cell["config"]
        assert hasattr(man.entry(traffic["entry"]), "Job")
        assert man.limits(name)
        assert any(m["name"] == "setup_s" for m in man.end_to_end(name))
        assert len(man.end_to_end(name)) >= 2 and man.per_layer(name)
    for m in man.data["per_layer"]:
        assert callable(man.metric(m["name"]).read)


def test_manifest_shapes():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= data["run_seconds"] <= 51 and data["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in data[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in data["end_to_end"]}
    layers = {}
    for m in data["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= {w["name"] for w in data["workloads"]}
        moved = next(e for e in data["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        layers.setdefault(m["layer"], []).append(m["name"])
    if (ROOT / "PERF.md").is_file():
        perf = (ROOT / "PERF.md").read_text()
        assert all(layer in perf for layer in layers)
    assert len(json.dumps(data)) < 64 * 1024


def test_new_files_are_found(tmp_path):
    """A configuration, a traffic mix, a metric and an entry added as new files
    in a copy are found, and no file that was there is edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "gtnmf_music_m32.json").read_text())
    cfg["name"] = "music_copy"
    (b / "configs" / "music_copy.json").write_text(json.dumps(cfg))
    (b / "traffic" / "short_copy.json").write_text(json.dumps(
        dict(json.loads((b / "traffic" / "single_100k.json").read_text()), T=500)))
    (b / "limits" / "copy_cell.json").write_text(json.dumps({"eft": 1.0}))
    (b / "metrics" / "calls_traced.py").write_text("def read(tr):\n    return tr.calls\n")
    (b / "entries" / "echo.py").write_text("class Job:\n    pass\n")
    data["configs"].append(dict(data["configs"][0], name="music_copy",
                                file="benchmark/configs/music_copy.json"))
    data["workloads"].append({"name": "copy_cell", "config": "music_copy",
                              "traffic": "short_copy", "chips": 1, "why": "a copy"})
    data["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "samples_per_s", "workloads": ["copy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    man = Manifest(tmp_path, b)
    assert man.config("music_copy")["name"] == "music_copy"
    assert man.traffic(man.cell("copy_cell")["traffic"])["T"] == 500
    assert man.limits("copy_cell") == {"eft": 1.0}
    assert [m["name"] for m in man.per_layer("copy_cell")] == ["calls_traced"]
    assert man.metric("calls_traced").read(type("T", (), {"calls": 3})) == 3
    assert man.metric("calls_traced.split").read(type("T", (), {"calls": 4})) == 4
    assert hasattr(man.entry("echo"), "Job")
    for p, content in before.items():
        assert p.read_bytes() == content
    with pytest.raises(KeyError):
        man.cell("no_such_cell")


def test_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a run
    fails and prints no result."""
    import subprocess

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ep_piano_100k",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
