"""Finding the benchmark's files by name: a cell's workload file, its
configuration, its traffic mix, and the per-layer metric readers.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric sits in a file of its own under `benchmark/`, named after it, so
that a new cell or metric is added by adding files:

- `configs/<config>.json` (with the settings files it names beside it),
- `traffic/<mix>.json`,
- `workloads/<cell>.json`,
- `metrics/<metric>.py`, which defines `read(run) -> float | None`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    """`BENCHMARK.json` at the root of the checkout."""
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload file {path.relative_to(ROOT)}")
    return load_json(path)


def config(name: str) -> dict:
    cfg = load_json(BENCH_DIR / "configs" / f"{name}.json")
    cfg["dir"] = BENCH_DIR / "configs"
    return cfg


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def metric_reader(name: str):
    """The `read` function of `metrics/<name>.py`, loaded from its path
    (metric names hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_for(cell: str, spec: dict | None = None) -> list[dict]:
    """The per-layer metrics that `BENCHMARK.json` lists for `cell`: those
    whose `workloads` name it, and those without a `workloads` key whose
    end-to-end metric the cell reports."""
    spec = spec or benchmark_spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    reported = {n for n, m in e2e.items() if cell in m.get("workloads", [cell])}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def end_to_end_for(cell: str, spec: dict | None = None) -> list[dict]:
    spec = spec or benchmark_spec()
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
