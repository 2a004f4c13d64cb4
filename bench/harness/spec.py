"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``bench/configs/<config>.json``; its ``kind``
names ``bench/models/<kind>.py`` (leaves, counts, the port's config)
and ``bench/reference/<kind>.py`` (the plain forward). A traffic mix is
``bench/traffic/<traffic>.json``; its ``driver`` names
``bench/drivers/<driver>.py``, a module that defines ``Driver``. A
per-layer metric's reader is ``bench/metrics/<metric>.py``, a module
with ``read(window) -> float | None``. Adding a cell, a mix, a
configuration, a model kind, a driver or a metric adds files and
entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """A configuration's file, as ``BENCHMARK.json`` names it."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _load(path: Path, mod_name: str):
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(package: str, name: str, bench_dir: Path = BENCH):
    """The module ``bench/<package>/<name>.py`` (``name`` an identifier:
    a driver's or a model kind's), imported as ``bench.<package>.<name>``
    from this checkout and loaded from its file from another."""
    path = bench_dir / package / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise KeyError(f"no {path}")
    if bench_dir == BENCH:
        return importlib.import_module(f"bench.{package}.{name}")
    return _load(path, f"bench_{package}_{name}")


def driver(name: str, bench_dir: Path = BENCH):
    """``bench/drivers/<name>.py``, whose ``Driver`` is the driver."""
    return _module("drivers", name, bench_dir)


def model(kind: str, bench_dir: Path = BENCH):
    """``bench/models/<kind>.py``: the kind's leaves, counts and the
    port's config."""
    return _module("models", kind, bench_dir)


def reference(kind: str, bench_dir: Path = BENCH):
    """``bench/reference/<kind>.py``: the kind's plain forward."""
    return _module("reference", kind, bench_dir)


def reader(metric: str, bench_dir: Path = BENCH) -> Callable:
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    return _load(bench_dir / "metrics" / f"{metric}.py",
                 "bench_metric_" + re.sub(r"\W", "_", metric)).read


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
    reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_per_layer(bench: dict, cell: str, window: dict,
                   bench_dir: Path = BENCH) -> Dict[str, dict]:
    """Every per-layer metric of ``cell`` that its reader finds something
    to read for, as ``{name: {"value", "unit"}}``."""
    out = {}
    for m in cell_metrics(bench, cell, "per_layer"):
        v: Optional[float] = reader(m["name"], bench_dir)(window)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def problems(bench: dict, root: Path = ROOT) -> List[str]:
    """What in ``BENCHMARK.json`` or the files it names the harness
    cannot run: a missing file (a configuration, its kind's model and
    reference, a mix, its driver, a reader), a name or unit outside the allowed
    characters, a per-layer metric whose ``moves`` its cells do not
    report."""
    bad = []
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["config"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    bad += [f"name {n!r}" for n in names if not NAME_RE.match(n)]
    bad += [f"unit {m['unit']!r} of {m['name']}"
            for m in bench["end_to_end"] + bench["per_layer"]
            if not UNIT_RE.match(m["unit"])]
    bench_dir = root / "bench"
    for c in bench["configs"]:
        if not (root / c["file"]).is_file():
            bad.append(f"config file {c['file']}")
            continue
        kind = config(bench, c["name"], root).get("kind", "")
        for pkg in ("models", "reference"):
            if not (bench_dir / pkg / f"{kind}.py").is_file():
                bad.append(f"bench/{pkg}/ of kind {kind!r} of {c['name']}")
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        path = bench_dir / "traffic" / f"{w['traffic']}.json"
        if not path.is_file():
            bad.append(f"traffic file of {w['traffic']}")
        elif not (bench_dir / "drivers" /
                  f"{traffic(w['traffic'], bench_dir)['driver']}.py"
                  ).is_file():
            bad.append(f"driver of {w['traffic']}")
        e2e = {m["name"] for m in cell_metrics(bench, w["name"],
                                               "end_to_end")}
        if "setup_s" not in e2e or len(e2e) < 2:
            bad.append(f"{w['name']} reports {sorted(e2e)}")
        if not cell_metrics(bench, w["name"], "per_layer"):
            bad.append(f"{w['name']} has no per-layer metric")
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        if not (bench_dir / "metrics" / f"{m['name']}.py").is_file():
            bad.append(f"reader of {m['name']}")
        if m["moves"] not in e2e_names:
            bad.append(f"{m['name']} moves unknown {m['moves']!r}")
        for cell in m.get("workloads", sorted(cells)):
            if cell not in cells:
                bad.append(f"{m['name']} lists unknown cell {cell!r}")
                continue
            got = {x["name"] for x in cell_metrics(bench, cell,
                                                   "end_to_end")}
            if m["moves"] not in got:
                bad.append(f"{m['name']} moves {m['moves']}, which "
                           f"{cell} does not report")
    return bad
