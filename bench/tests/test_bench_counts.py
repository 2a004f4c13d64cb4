"""The operations and bytes the roofline and ``mfu`` shares count,
held to ``chip_smoke.py``'s counts at the paper's two configurations;
the ladder's padding rows are not counted."""
import importlib.util
import json

import numpy as np
import pytest

import benchtest_util  # noqa: F401  (import paths)
from benchtest_util import ROOT

torch = pytest.importorskip("torch")

from bench.harness import model as M  # noqa: E402
from bench.harness import roofline as R  # noqa: E402
from bench.models import conv1d as K  # noqa: E402


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_counts",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(p, heads):
    return (p["emb"], [c["w"] for c in p["convs"]],
            [c["b"] for c in p["convs"]], [f["w"] for f in p["fc"]],
            [f["b"] for f in p["fc"]],
            torch.cat([p["heads"][t]["w"] for t in heads], 1),
            torch.cat([p["heads"][t]["b"] for t in heads]))


@pytest.mark.parametrize("name,seq", [("costmodel-base", 128),
                                      ("costmodel-operand", 256)])
def test_counts_equal_chip_smokes(name, seq):
    cfg = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    p = M.seeded_params(cfg, 0, torch.device("cpu"))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 500, (23, seq)).astype(np.int32)
    ids[:, seq // 2:] = 0
    cs = _chip_smoke()
    _, _, flops, nbytes = cs.bound_ms(torch.from_numpy(ids),
                                      _args(p, cfg["heads"]))
    assert R.batch_work(cfg, ids) == (flops, nbytes)
    # the service pads 23 rows to its ladder's 24: the padded row, all
    # PAD, is work chip_smoke's count of the padded batch includes and
    # the benchmark's does not
    padded = np.concatenate([ids, np.zeros((1, seq), np.int32)])
    _, _, flops_pad, _ = cs.bound_ms(torch.from_numpy(padded),
                                     _args(p, cfg["heads"]))
    assert flops_pad > flops
    assert R.batch_work(cfg, ids)[0] == 23 * K.row_flops(cfg, seq)


def test_peaks_are_the_data_sheets():
    assert R.PEAK_FLOPS == 495e12
    assert R.PEAK_FFMA_FLOPS == 67e12
    assert R.PEAK_BYTES == 3.35e12
    work = [(495e12, 1.0), (1.0, 3.35e12)]
    assert R.least_seconds(work) == pytest.approx(2.0)
    assert R.least_seconds([(67e12, 1.0)], R.PEAK_FFMA_FLOPS) == \
        pytest.approx(1.0)


def test_row_flops_by_hand():
    cfg = json.loads((ROOT / "bench/configs/costmodel-base.json").read_text())
    conv = 2 * 32 * (2 * 64 * 64) * 6
    fc = 2 * (64 * 256 + 256 * 64 + 64 * 3)
    assert K.row_flops(cfg, 32) == conv + fc
