"""The harness finds every configuration, model kind, traffic mix,
driver and per-layer metric by its name: a copy of ``bench/`` with a
throwaway configuration of a new kind, a mix of a new driver and a
metric added as new files (and new entries in ``BENCHMARK.json``) runs
the discovery with no existing file edited.
Also the rules on names, units and ``moves`` that the real
``BENCHMARK.json`` has to keep."""
import hashlib
import json
import shutil

import numpy as np
import pytest

import benchtest_util  # noqa: F401  (import paths)
from benchtest_util import ROOT

from bench.harness import spec as SP  # noqa: E402


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_benchmark_json_has_no_problems():
    assert SP.problems(SP.load_benchmark(ROOT), ROOT) == []


def test_names_and_units_use_the_allowed_characters():
    bench = SP.load_benchmark(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert SP.NAME_RE.match(m["name"]), m["name"]
        assert SP.UNIT_RE.match(m["unit"]), m["unit"]
    for w in bench["workloads"]:
        for k in ("name", "config", "traffic"):
            assert SP.NAME_RE.match(w[k]), w[k]
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert SP.NAME_RE.match("k1.roofline_pct.serve")
    for bad in ("a b", "a,b", "a/b", "", "x" * 65, "µs"):
        assert not SP.NAME_RE.match(bad)
    assert not SP.UNIT_RE.match("tokens per second")


def test_every_moves_is_reported_in_each_of_its_cells():
    bench = SP.load_benchmark(ROOT)
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            got = {x["name"] for x in SP.cell_metrics(bench, cell,
                                                      "end_to_end")}
            assert m["moves"] in got, (m["name"], cell)


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / "bench/configs/costmodel-base.json").read_text())
    (root / "bench/configs/throwaway.json").write_text(
        json.dumps(dict(base, name="throwaway", kind="throwaway_kind")))
    for pkg in ("models", "reference"):
        (root / f"bench/{pkg}/throwaway_kind.py").write_text(
            "def row_flops(cfg, seq):\n    return 3 * seq\n")
    mix = json.loads((root / "bench/traffic/open-fresh-base.json").read_text())
    (root / "bench/traffic/throwaway-mix.json").write_text(
        json.dumps(dict(mix, driver="throwaway_driver", new_param=0.5)))
    (root / "bench/drivers/throwaway_driver.py").write_text(
        "class Driver:\n    kind = 'serve'\n")
    (root / "bench/metrics/throwaway.count.py").write_text(
        "def read(w):\n    return 7.0 if w['kind'] == 'serve' else None\n")
    bench["configs"].append({"name": "throwaway", "source": "a test",
                             "file": "bench/configs/throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway-cell",
                               "config": "throwaway",
                               "traffic": "throwaway-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({
        "name": "throwaway_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["throwaway-cell"]})
    bench["per_layer"].append({
        "name": "throwaway.count", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "gateway",
        "moves": "throwaway_per_s", "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert SP.problems(bench, root) == []
    cfg = SP.config(bench, "throwaway", root)
    assert cfg["name"] == "throwaway"
    tr = SP.traffic("throwaway-mix", root / "bench")
    assert tr["new_param"] == 0.5
    assert SP.driver(tr["driver"], root / "bench").Driver.kind == "serve"
    assert SP.model(cfg["kind"], root / "bench").row_flops(cfg, 2) == 6
    assert SP.reference(cfg["kind"], root / "bench").row_flops(cfg, 1) == 3
    got = SP.read_per_layer(bench, "throwaway-cell", {"kind": "serve"},
                            root / "bench")
    assert got == {"throwaway.count": {"value": 7.0, "unit": "1"}}
    e2e = {m["name"] for m in SP.cell_metrics(bench, "throwaway-cell",
                                              "end_to_end")}
    assert e2e == {"setup_s", "throwaway_per_s"}


def test_a_metric_whose_moves_its_cell_lacks_is_a_problem():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(bench["per_layer"][0], name="x.y",
                                   workloads=["base-search"]))
    assert any("x.y" in p for p in SP.problems(bench, ROOT))


def test_a_missing_driver_or_model_kind_is_a_problem(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "bench/drivers/train.py").unlink()
    (root / "bench/models/conv1d.py").unlink()
    got = SP.problems(bench, root)
    assert any("driver of train-bucketed-b512" in p for p in got), got
    assert any("bench/models/" in p for p in got), got


@pytest.mark.parametrize("rate", [500.0, 2600.0])
def test_the_open_loop_offers_the_mean_rate(rate):
    arrivals = SP.driver("open_loop").Driver.arrivals
    tr = {"rate_per_s": rate}
    arr = arrivals(tr, 2 ** 40 + 99, 20.0)
    assert abs(len(arr) / 20.0 - rate) < rate * 0.05
    assert (arr >= 0).all() and (arr < 20.0).all()
    assert (np.diff(arr) > 0).all()
    assert (arrivals(tr, 2 ** 40 + 99, 20.0) == arr).all()
