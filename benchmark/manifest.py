"""The benchmark's manifest and the files it names.

Everything is found by name: a cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``configs/<config>.json``, its
traffic ``traffic/<traffic>.json`` (which names an entry point,
``entries/<entry>.py``), its limits ``limits/<cell>.json``, and each
per-layer metric ``metrics/<metric>.py``.  A per-layer quantity split by the
end-to-end metric it moves is named ``<metric>.<suffix>`` and read by
``metrics/<metric>.py`` where no file of its full name exists.  Adding one of
these is adding a file and an entry; no file here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.configs[name]["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def entry(self, name: str) -> ModuleType:
        return _module(self.dir, "entries", name)

    def metric(self, name: str) -> ModuleType:
        if "." in name and not (self.dir / "metrics" / f"{name}.py").is_file():
            name = name.split(".")[0]
        return _module(self.dir, "metrics", name)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.data["per_layer"] if cell in m.get("workloads", [cell])]


def _module(bench_dir: Path, kind: str, name: str) -> ModuleType:
    """``<bench_dir>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
