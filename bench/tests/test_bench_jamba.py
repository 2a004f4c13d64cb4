"""The ``jamba2-3b`` configuration's pieces, found by name, and its check
on the CPU at a small width: the program passes the scan's limit, and
each control (a bfloat16 scan state, the inner norms left out, the state
restarted at each of the reference's chunks, half of each batch left
out) fails one of the configuration's limits, as does a program whose
scan gives a wrong gradient of A or of D. The whole-step limits are the
chip's, set at the published widths; at width 64 the program's own
bfloat16 noise is larger, so only the scan's limit and
``batch_mismatch`` are held here."""
import json

import pytest

import benchtest_util  # noqa: F401  (import paths)
from benchtest_util import ROOT

torch = pytest.importorskip("torch")

from bench.drivers import lm_train as LT  # noqa: E402
from bench.harness import runner  # noqa: E402
from bench.harness import spec as SP  # noqa: E402

CELL = "jamba2-3b-train-s4096"
READERS = ("scan.roofline_pct.lmtrain", "scan.share_pct.lmtrain",
           "scan.launches_per_step.lmtrain", "mfu_pct.lmtrain",
           "device.idle_pct.lmtrain", "lm.optimizer_ms.lmtrain")


def test_the_cell_and_its_pieces_are_found_by_name():
    bench = SP.load_benchmark(ROOT)
    assert SP.problems(bench, ROOT) == []
    cell = SP.workload(bench, CELL)
    cfg = SP.config(bench, cell["config"], ROOT)
    tr = SP.traffic(cell["traffic"])
    assert cfg["kind"] == "jamba" and tr["driver"] == "lm_train"
    assert SP.driver(tr["driver"]).Driver.kind == "lmtrain"
    kind = SP.model(cfg["kind"])
    assert kind.port_config(cfg).n_layers == cfg["num_hidden_layers"] == 14
    n = sum(int(torch.tensor(s).prod()) for _, s, _ in
            kind.param_shapes(cfg))
    assert 1.59e9 < n < 1.61e9
    assert hasattr(SP.reference(cfg["kind"]), "run_steps")
    got = {m["name"] for m in SP.cell_metrics(bench, CELL, "per_layer")}
    assert got == set(READERS)
    for name in READERS:
        assert SP.reader(name)({"kind": "train", "trace": None,
                                "win": {}, "work": []}) is None
    e2e = {m["name"] for m in SP.cell_metrics(bench, CELL, "end_to_end")}
    assert e2e == {"setup_s", "train_graphs_per_s"}


def test_counts_of_the_cell():
    kind = SP.model("jamba")
    cfg = SP.config(SP.load_benchmark(ROOT), "jamba2-3b", ROOT)
    # ~6 x 1.6e9 parameters x 32,768 tokens, and the causal attention
    flops = kind.step_flops(cfg, 8, 4096)
    assert 3.1e14 < flops < 3.3e14
    # x, dt, y (and dy, dx, ddt) of (rows, L, channels); B and C 16 wide
    fwd, bwd = kind.scan_bytes(8, 4096, 5120, 16)
    seq = 8 * 4096 * 5120 * 4
    assert 3 * seq < fwd < 3.01 * seq and 5 * seq < bwd < 5.02 * seq


def _small_run(tmp_path_factory):
    """One harness run of the cell on the CPU at width 64, 300 steps of
    2 rows (one 256-step chunk of the reference's scan crossed)."""
    torch.set_num_threads(2)
    bench = SP.load_benchmark(ROOT)
    cfg = SP.config(bench, "jamba2-3b", ROOT)
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               mamba_dt_rank=4, vocab_size=256)
    path = tmp_path_factory.mktemp("cfg") / "jamba-small.json"
    path.write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][-1], name="jamba-small",
                                 file=str(path)))
    bench["workloads"].append(dict(SP.workload(bench, CELL),
                                   name="jamba-small-cell",
                                   config="jamba-small"))
    out = runner.run_cell(bench, "jamba-small-cell", 2 ** 40 + 7, 0.5,
                          False, "cpu", limits={},
                          traffic_overrides={"batch_size": 2,
                                             "seq_len": 300})
    return out["_run"], out["_answers"], cfg["limits"]["lmtrain"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _small_run(tmp_path_factory)


def test_the_program_passes_the_scan_limit(small):
    run, ans, lim = small
    got = LT.lm_numbers(run, ans)
    assert got["batch_mismatch"] == 0
    assert got["scan_rel_err"] <= lim["scan_rel_err"], got


@pytest.mark.parametrize("fault", LT.CONTROLS)
def test_each_control_fails_a_limit(small, fault):
    run, ans, lim = small
    got = LT.lm_numbers(run, ans, fault)
    assert any(got[k] > v for k, v in lim.items()), (got, lim)


class _DoubleGrad(torch.autograd.Function):
    """The identity, whose backward doubles the gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 2 * g


@pytest.mark.parametrize("arg", ["A", "D"])
def test_a_wrong_scan_gradient_fails_the_worst_leaf(small, tmp_path_factory,
                                                    monkeypatch, arg):
    """A program whose scan doubles the gradient of A (or of D), and
    nothing else: one leaf of the 23 (``A_log`` or ``D``) is wrong, and
    the worst leaf's gap fails its limit, by over 3x the sound program's
    own worst leaf at this width."""
    sound = LT.lm_numbers(*small[:2])
    from repro_torch.models import mamba
    plain = mamba.selective_scan
    at = {"A": 2, "D": 5}[arg]

    def wrong(*ins):
        ins = list(ins)
        ins[at] = _DoubleGrad.apply(ins[at])
        return plain(*ins)
    monkeypatch.setattr(mamba, "selective_scan", wrong)
    run, ans, lim = _small_run(tmp_path_factory)
    got = LT.lm_numbers(run, ans)
    assert got["grad1_gap"] > max(lim["grad1_gap"],
                                  3 * sound["grad1_gap"]), (got, sound, lim)
