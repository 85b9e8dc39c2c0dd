"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits, its driver and the readers
of its metrics. An unknown name is refused with the names that exist."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path | None = None) -> dict:
    path = (root or Path.cwd()) / "BENCHMARK.json"
    if not path.is_file():
        raise LookupError(f"no BENCHMARK.json in {path.parent}")
    return json.loads(path.read_text())


def _pick(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(e["name"] for e in entries)
    raise LookupError(f"unknown {what} {name!r}; known: {known}")


def workload(bench: dict, name: str) -> dict:
    return _pick(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    entry = _pick(bench["configs"], name, "configuration")
    return json.loads((HERE.parent / entry["file"]).read_text())


def _json(folder: str, name: str, what: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        known = ", ".join(sorted(p.stem for p in (HERE / folder).glob("*.json")))
        raise LookupError(f"unknown {what} {name!r}; known: {known}")
    return json.loads(path.read_text())


def traffic(name: str) -> dict:
    return _json("traffic", name, "traffic mix")


def limits(cell: str) -> dict:
    return _json("limits", cell, "cell's limits")


def driver(name: str):
    if not (HERE / "drivers" / f"{name}.py").is_file():
        known = ", ".join(sorted(p.stem for p in (HERE / "drivers").glob("*.py")
                                 if not p.stem.startswith("_")))
        raise LookupError(f"unknown driver {name!r}; known: {known}")
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        known = ", ".join(sorted(p.name[:-3] for p in (HERE / "metrics").glob("*.py")))
        raise LookupError(f"unknown metric {name!r}; known: {known}")
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
