"""BENCHMARK.json and the files it names, found by name: a configuration's
file (its ``file``), a traffic mix ``portbench/traffic/<traffic>.json``, a
metric's reader ``portbench/metrics/<name>.py`` and a cell's limits
``portbench/limits/<cell>.json``.  Adding a configuration, a mix, a
metric or a cell adds files and entries; no file here changes."""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.cells = {w["name"]: w for w in self.doc["workloads"]}

    def _json(self, rel: str) -> dict:
        with open(os.path.join(self.root, rel)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return self._json(self.configs[name]["file"])

    def traffic(self, name: str) -> dict:
        return self._json(os.path.join("portbench", "traffic", f"{name}.json"))

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer ones
        (traced): those without a ``workloads`` list and those whose list
        names the cell."""
        group = self.doc["per_layer"] if traced else self.doc["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    @staticmethod
    def reader(metric: str):
        return importlib.import_module(f"portbench.metrics.{metric}")


def problems(doc: dict) -> List[str]:
    """What in a BENCHMARK.json breaks the naming rules or does not resolve
    (the CPU tests hold the committed one to an empty list)."""
    out = []
    names: Dict[str, int] = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in doc[group]:
            names[e["name"]] = names.get(e["name"], 0) + 1
            if not NAME.match(e["name"]):
                out.append(f"{group}: bad name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{e['name']}: bad unit {e['unit']!r}")
    out += [f"{n}: used {k} times" for n, k in names.items() if k > 1]
    configs = {c["name"] for c in doc["configs"]}
    cells = {w["name"] for w in doc["workloads"]}
    for w in doc["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: no config {w['config']!r}")
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"{w['name']}: bad {k} {w[k]!r}")
    for m in doc["end_to_end"] + doc["per_layer"]:
        out += [f"{m['name']}: no cell {c!r}" for c in m.get("workloads", []) if c not in cells]
    for c in doc["configs"]:
        out += [f"{c['name']}: bad reduced key {k!r}" for k in c["reduced"] if not NAME.match(k)]
    return out
