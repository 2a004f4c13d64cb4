"""The port's twins of the four examples (``examples/*_torch.py``) run
end to end with ``--device cpu`` at reduced sizes, and each defaults to
the card. The LM smoke twin's checkpoint restores in the reference."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.checkpoint import ckpt as R_CKPT
from repro.configs import get_arch as r_arch
from repro.models import model as RMODEL
from repro_torch import params as P

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: beside the other test workers a pool as wide
    as the machine oversubscribes its cores (this file took 2-5x longer
    under the six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_on_cpu(capsys):
    out = example("quickstart_torch").main(
        ["--device", "cpu", "--n-graphs", "80", "--steps", "20",
         "--batch", "32"])
    assert np.isfinite(out["pred"]) and out["true"] > 0
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert "predicted register pressure" in capsys.readouterr().out


def test_compiler_advisors_twin_on_cpu(capsys):
    out = example("compiler_advisors_torch").main(
        ["--device", "cpu", "--n-graphs", "160", "--train-steps", "10"])
    assert sorted(out["costs"]) == sorted(
        ["latency_us", "register_pressure", "valu_utilization"])
    assert out["unroll"]["best_factor"] >= 1
    assert out["search"].predict_calls == 1 + out["search"].expansions
    assert out["server"]["requests"] > 0
    assert "beam search" in capsys.readouterr().out


def test_train_costmodel_twin_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "6", "--n-graphs", "80",
            "--batch", "32", "--ckpt-dir", str(tmp_path)]
    metrics = example("train_costmodel_100m_torch").main(argv)
    assert all(np.isfinite(v) for v in metrics.values())
    assert "trained 6 steps" in capsys.readouterr().out
    # a second call finds the run complete (compressed-grad state too)
    example("train_costmodel_100m_torch").main(argv)
    assert "run already complete" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-small",
                                  "llava-next-34b"])
def test_train_lm_smoke_twin_on_cpu(arch, tmp_path):
    out = example("train_lm_smoke_torch").main(
        ["--device", "cpu", "--arch", arch, "--steps", "12", "--batch",
         "4", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    # the checkpoint restores in the reference, leaf for leaf
    like = RMODEL.init_params(jax.random.PRNGKey(0), r_arch(arch).reduced())
    back, step, _ = R_CKPT.restore(str(tmp_path), like)
    assert step == 12
    got = dict(P.tree_flatten_with_paths(P.to_numpy(out["params"])))
    for path, leaf in P.tree_flatten_with_paths(
            jax.tree.map(np.asarray, back)):
        np.testing.assert_array_equal(leaf, got[path])


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", ["--n-graphs", "70", "--steps", "1"]),
    ("compiler_advisors_torch", ["--n-graphs", "70", "--train-steps", "1"]),
    ("train_costmodel_100m_torch", ["--n-graphs", "70", "--steps", "1"]),
    ("train_lm_smoke_torch", ["--steps", "1"])])
def test_twins_default_to_the_card(name, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    if name == "train_costmodel_100m_torch":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        example(name).main(argv)


def test_chip_smoke_lm_phase_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's lm phase end to end on the CPU at reduced width and
    length (the card runs qwen3-0.6b at full width): losses fall, the
    float32 decode path agrees with the prefill, all ten archs run."""
    from repro_torch.configs import ARCHS, get_arch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", EXAMPLES.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "LM_TRAIN", (4, 32, 8))
    monkeypatch.setattr(cs, "LM_DECODE", (2, 24, 4, 40))
    monkeypatch.setattr(cs, "LM_CPU", (2, 8))
    out = cs.phase_lm("cpu rehearsal", device="cpu",
                      cfg=get_arch("qwen3-0.6b").reduced())
    losses = out["train"]["losses"]
    assert len(losses) == 8 and losses[-1] < losses[0]
    agree = out["float32_decode_vs_prefill"]
    assert agree["positions"] == 48 and agree["agree"] == 48
    assert sorted(out["reduced_archs"]) == sorted(ARCHS)
    assert '"phase": "lm"' in capsys.readouterr().out
