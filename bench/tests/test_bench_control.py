"""The controls: the plain reference put in the program's place in the
nearest precision below the configuration's (TF32 for float32) has to
come out as not correct, at a size a test run holds. On the CPU TF32
is emulated by rounding each product's operands to TF32; on a card,
where there is one, the products run in TF32."""
import pytest

import benchtest_util  # noqa: F401  (import paths)
from benchtest_util import run_small

torch = pytest.importorskip("torch")

from bench.harness import check as C  # noqa: E402
from bench.harness import spec as SP  # noqa: E402


def _devices():
    return ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])


@pytest.mark.parametrize("cell", ["base-serve-open", "operand-serve-open",
                                  "base-search"])
def test_tf32_control_fails_the_prediction_limit(cell):
    out = run_small(cell, seed=777)
    run, (graphs, _) = out["_run"], out["_answers"]
    limit = run.cfg["limits"][SP.driver(run.traffic["driver"]).Driver.kind][
        "pred_rel_err"]
    assert out["correct"], out["check"]
    for dev in _devices():
        d = torch.device(dev)
        params = {k: v for k, v in run.params.items()}
        params = _to(params, d)
        ieee = C.reference_predictions(graphs, run.cfg, run.vocab, params,
                                       run.stats, d)
        tf32 = C.reference_predictions(graphs, run.cfg, run.vocab, params,
                                       run.stats, d, "tf32")
        assert C.rel_err(tf32, ieee) > limit, dev


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_training_control_and_faults_fail():
    out = run_small("base-train", seed=778)
    assert out["correct"], out["check"]
    run, ans = out["_run"], out["_answers"]
    lim = run.cfg["limits"]["train"]
    numbers = SP.driver("train").train_numbers

    def fails(got):
        return any(got[k] > lim[k] for k in lim)
    assert fails(numbers(run, ans, "tf32"))
    assert fails(numbers(run, ans, "ieee", 0.5))
    still = dict(ans, params=[run.params] * 3)      # a state left unchanged
    assert numbers(run, still)["delta3_gap"] == pytest.approx(1.0)
    assert fails(numbers(run, still))
