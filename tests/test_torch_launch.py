"""The port's command-line drivers (``repro_torch.launch``) on the CPU,
against the reference's where both run: a checkpoint written by either
package's train CLI evaluates in the other's for every family; the
serve CLI prints the reference's lines in-process, through the fused
forward's plain version and through 2 spawned CPU replicas with
telemetry that the obs CLI reports; the optimize CLI resumes a run the
reference finished and finds its searches; the ingest CLI prints the
reference's lines over the port's own StableHLO lowering; and every CLI
defaults to the card."""
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import ingest as R_INGEST
from repro.launch import optimize as R_OPTIMIZE
from repro.launch import train as R_TRAIN
from repro_torch.ir import stablehlo as SH
from repro_torch.kernels import conv1d_stack as K
from repro_torch.launch import ingest as T_INGEST
from repro_torch.launch import obs as OBS
from repro_torch.launch import optimize as T_OPTIMIZE
from repro_torch.launch import serve as T_SERVE
from repro_torch.launch import train as T_TRAIN
from repro_torch.obs import assemble, completeness

# Evaluation metrics of the same params, float32 in two packages: the
# predictions differ by rounding (measured <= 4.3e-7 relative).
METRIC_RTOL = 1e-4
TRAIN_ARGS = ["--preset", "small", "--target", "all", "--steps", "20",
              "--n-graphs", "60", "--batch", "32"]
SERVE_ARGS = ["--device", "cpu", "--requests", "40", "--train-steps", "5",
              "--n-graphs", "80"]
OPT_ARGS = ["--n-graphs", "80", "--train-steps", "10", "--eval-graphs",
            "6", "--beam", "2", "--depth", "2", "--max-candidates", "16",
            "--eval-budget", "32"]
# 80 graphs: the reference CLI's training batch is 64 rows
INGEST_ARGS = ["--arch", "all", "--n-graphs", "80", "--train-steps", "5",
               "--fuzz", "20"]
KERNEL_RTOL = 2e-4       # the fused forward's plain version vs the model
# the reference serve CLI's lines on the in-process path, in order
SERVE_LINES = ["training joint multi-target cost model", "trained at ",
               "server up: heads=", "served ", "  batches=",
               "  latency p50=", "  cache_hit_rate=", "fusion advisor: ",
               "unroll advisor: ", "recompile advisor: ",
               "cache after session: "]


@pytest.fixture(autouse=True)
def keep_sigterm():
    """The train CLIs install a SIGTERM handler (checkpoint, then stop);
    give the test process its own back."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_reference(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    return main()


def assert_metrics_close(got, want):
    assert set(got) == set(want)
    for t in want:
        for k, v in want[t].items():
            assert got[t][k] == pytest.approx(v, rel=METRIC_RTOL,
                                              abs=1e-9), (t, k)


@pytest.mark.parametrize("model", ["conv1d", "fc", "lstm", "xformer"])
def test_train_checkpoints_evaluate_across_packages(model, tmp_path,
                                                    monkeypatch, capsys):
    """The reference's CLI trains; the port's ``--eval-only --device
    cpu`` reads its checkpoint and reports its metrics. Then the port
    trains, resumes its finished run, and the reference evaluates it."""
    args = [*TRAIN_ARGS, "--model", model]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    want = run_reference(R_TRAIN.main, [*args, "--ckpt-dir", ref_dir],
                         monkeypatch)
    got = T_TRAIN.main([*args, "--ckpt-dir", ref_dir, "--eval-only",
                        "--device", "cpu"])
    assert_metrics_close(got, want)
    capsys.readouterr()

    trained = T_TRAIN.main([*args, "--ckpt-dir", port_dir, "--device",
                            "cpu"])
    out = capsys.readouterr().out
    assert "trained 20 steps" in out
    assert sum(ln.startswith("eval[") for ln in out.splitlines()) == 3
    again = T_TRAIN.main([*args, "--ckpt-dir", port_dir, "--device",
                          "cpu"])
    assert "run already complete" in capsys.readouterr().out
    assert again == trained
    want = run_reference(R_TRAIN.main, [*args, "--ckpt-dir", port_dir,
                                        "--eval-only"], monkeypatch)
    assert_metrics_close(trained, want)


def test_train_single_target_and_argument_errors(tmp_path, capfd):
    got = T_TRAIN.main([*TRAIN_ARGS[:2], "--model", "fc", "--steps", "5",
                        "--n-graphs", "60", "--batch", "32",
                        "--ckpt-dir", str(tmp_path / "a"), "--device",
                        "cpu"])
    assert "rmse_rel_pct" in got       # one target: flat metrics
    assert "eval: " in capfd.readouterr().out
    with pytest.raises(SystemExit):
        T_TRAIN.main([*TRAIN_ARGS[:2], "--target", "bogus", "--n-graphs",
                      "60", "--ckpt-dir", str(tmp_path / "b"),
                      "--device", "cpu"])
    with pytest.raises(SystemExit):
        T_TRAIN.main(["--eval-only", "--n-graphs", "60", "--ckpt-dir",
                      str(tmp_path / "empty"), "--device", "cpu"])
    # --mesh-data 2: two spawned gloo ranks train one model; rank 0
    # prints the reference's lines once, and its metrics are those of
    # one device's run
    capfd.readouterr()
    mesh_args = [*TRAIN_ARGS[:4], "--steps", "5", "--n-graphs", "60",
                 "--batch", "32", "--device", "cpu"]
    one = T_TRAIN.main([*mesh_args, "--ckpt-dir", str(tmp_path / "c1")])
    capfd.readouterr()
    two = T_TRAIN.main([*mesh_args, "--mesh-data", "2",
                        "--ckpt-dir", str(tmp_path / "c2")])
    out = capfd.readouterr().out.splitlines()
    for prefix in ("dataset: ", "trained 5 steps", "eval[latency_us]",
                   "eval[register_pressure]", "eval[valu_utilization]"):
        assert sum(ln.startswith(prefix) for ln in out) == 1, (prefix, out)
    assert_metrics_close(two, one)


@pytest.mark.parametrize("kernel", [False, True])
def test_serve_in_process_prints_the_references_lines(kernel, capsys):
    """On the CPU ``--kernel`` serves through the fused forward's plain
    version: no kernel launches."""
    before = K.conv_forward_fused.launches
    m = T_SERVE.main([*SERVE_ARGS] + (["--kernel"] if kernel else []))
    out = capsys.readouterr().out.splitlines()
    starts = [next(i for i, ln in enumerate(out) if ln.startswith(p))
              for p in SERVE_LINES]
    assert starts == sorted(starts), out
    assert m["batches"] > 0 and m["cache_hits"] > 0 and m["shed"] == 0
    assert K.conv_forward_fused.launches == before


def test_serve_replicated_with_telemetry_and_obs_report(tmp_path,
                                                        capsys):
    """2 spawned CPU replicas under the supervisor, every request traced;
    the obs CLI reports the JSONL with every trace complete."""
    path = str(tmp_path / "obs.jsonl")
    stats = T_SERVE.main([*SERVE_ARGS, "--kernel", "--replicas", "2",
                          "--supervise", "--obs", "--obs-sample", "1",
                          "--obs-jsonl", path])
    out = capsys.readouterr().out
    assert "supervisor: active=2" in out and "completeness=100.0%" in out
    assert len(stats) == 2
    for s in stats:
        assert s["device"]["type"] == "cpu"
        assert s["forward_batches"] > 0 and s["nvcc_runs"] == 0
    spans, _ = OBS.read_records(path)
    trees = assemble(spans)
    assert trees and completeness(trees) == 1.0
    assert all(t.complete for t in trees.values())
    assert {p for t in trees.values() for p in t.procs} >= {
        "replica-0", "replica-1"}
    assert OBS.main(["report", path]) == 0
    report = capsys.readouterr().out
    assert "100.0% completeness" in report and "INCOMPLETE" not in report


def test_optimize_resumes_the_references_run(tmp_path, monkeypatch,
                                             capsys):
    """The reference trains and searches (``--direct``); the port resumes
    the finished run from the same ``--ckpt-dir`` and searches the same
    graphs: every best rewrite sequence and oracle cost equal (at this
    seed no best graph differs; one that did would be two candidates
    whose predicted costs tie within float32 rounding), the summary
    within METRIC_RTOL. Through the server with ``--kernel`` (the plain
    version on the CPU) the port's searches are the same again."""
    args = [*OPT_ARGS, "--ckpt-dir", str(tmp_path / "ck")]
    want = run_reference(R_OPTIMIZE.main, [*args, "--direct"], monkeypatch)
    capsys.readouterr()
    for extra in (["--direct"], ["--kernel"]):
        got = T_OPTIMIZE.main([*args, *extra, "--device", "cpu"])
        assert "resumed completed run" in capsys.readouterr().out
        for g, w in zip(got["per_graph"], want["per_graph"]):
            assert (g["graph"], g["seq"], g["steps"]) == \
                (w["graph"], w["seq"], w["steps"])
            assert g["oracle_best"] == pytest.approx(w["oracle_best"],
                                                     rel=1e-9)
        for k, v in want["summary"].items():
            assert got["summary"][k] == pytest.approx(
                v, rel=METRIC_RTOL, abs=1e-9), k


def ingest_lines(out):
    """The ingest CLI's output by kind of line."""
    lines = out.splitlines()
    kinds = {"service": "service up: ", "lowered": "lowered ",
             "fuzz": "fuzz: ", "stats": "ingested_texts="}
    got = {k: sum(ln.startswith(p) for ln in lines)
           for k, p in kinds.items()}
    got["predictions"] = sum(" n_ops=" in ln for ln in lines)
    got["errors"] = sum(" ERROR stage=" in ln for ln in lines)
    got["uncaught"] = sum("UNCAUGHT" in ln for ln in lines)
    return got


def test_ingest_prints_the_references_lines(monkeypatch, capsys):
    """All 43 per-layer subgraphs of the ten archs, lowered by the port,
    predict with no ERROR line, and the fuzz pass counts 0 uncaught
    exceptions; the reference's CLI prints as many lines of each kind."""
    got = T_INGEST.main(["--device", "cpu", *INGEST_ARGS])
    out = capsys.readouterr().out
    counts = ingest_lines(out)
    assert counts == {"service": 1, "lowered": 1, "fuzz": 1, "stats": 1,
                      "predictions": 43, "errors": 0, "uncaught": 0}
    assert "lowered 43 per-layer subgraphs of 10 archs" in out
    assert "0 uncaught exceptions" in out
    assert len(got["arch_rows"]) == 43 and got["fuzz"]["uncaught"] == 0
    assert max(r.unk_rate for *_, r in got["arch_rows"]) == 0.0
    run_reference(R_INGEST.main, INGEST_ARGS, monkeypatch)
    assert ingest_lines(capsys.readouterr().out) == counts


def test_ingest_kernel_runs_the_plain_version_on_the_cpu(capsys):
    """``--kernel`` on the CPU serves through the fused forward's plain
    version: no kernel launch, the same predictions within 2e-4."""
    args = ["--device", "cpu", "--arch", "qwen3-0.6b,granite-moe-1b-a400m",
            "--n-graphs", "80", "--train-steps", "5"]
    before = K.conv_forward_fused.launches
    plain = T_INGEST.main(args)
    kern = T_INGEST.main([*args, "--kernel"])
    capsys.readouterr()
    assert K.conv_forward_fused.launches == before
    assert kern["service"].use_kernel and not plain["service"].use_kernel
    assert len(kern["arch_rows"]) == len(plain["arch_rows"]) == 9
    for (*_, p), (*_, q) in zip(plain["arch_rows"], kern["arch_rows"]):
        assert q.key == p.key
        for t, v in p.predictions.items():
            np.testing.assert_allclose(q.predictions[t], v,
                                       rtol=KERNEL_RTOL)


def test_ingest_fuzz_alone_and_a_file(tmp_path, capsys):
    """``--arch none --fuzz 10`` mutates the affine example; ``--file``
    ingests a text the test wrote (the port's lowering of a layer)."""
    T_INGEST.main(["--device", "cpu", "--arch", "none", "--fuzz", "10",
                   "--train-steps", "0", "--n-graphs", "80"])
    out = capsys.readouterr().out
    assert "lowered " not in out and "fuzz: 10 mutated inputs" in out
    assert "0 uncaught exceptions" in out
    path = tmp_path / "attention.mlir"
    layer, fn, specs = SH.arch_subgraphs("qwen3-0.6b")[0]
    path.write_text(SH.lower_fn(fn, *specs)[0])
    T_INGEST.main(["--device", "cpu", "--arch", "none", "--file",
                   str(path), "--train-steps", "0", "--n-graphs", "80"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if str(path) in ln)
    assert "n_ops= 28" in line and "ERROR" not in line


def test_clis_default_to_the_card(tmp_path):
    """Without ``--device`` every CLI trains or serves on the card; with
    no card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    for main, argv in (
            (T_TRAIN.main, [*TRAIN_ARGS, "--ckpt-dir", str(tmp_path)]),
            (T_SERVE.main, SERVE_ARGS[2:]),
            (T_OPTIMIZE.main, OPT_ARGS),
            (T_INGEST.main, ["--n-graphs", "80", "--train-steps", "1"]),
            (T_INGEST.main, ["--n-graphs", "80", "--train-steps", "0"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
