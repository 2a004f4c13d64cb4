"""The port's real-MLIR front door against the reference's: the copied
parser (``repro_torch.ir.frontdoor``) ingests every text exactly as the
reference does, and the service's ``ingest_text``/``predict_text`` and
the server's ``predict_text`` agree with the reference service built on
the same numpy params. Then the contracts of ``tests/test_frontdoor.py``
on the port: the error taxonomy, bytes input, the struct-key cache
shared by text and graph, server/service parity, the fuzz gate and the
hypothesis properties, and the reference's ingest gate on the port's own
StableHLO lowering (``repro_torch.ir.stablehlo``)."""
from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                     # container lacks hypothesis;
    HAVE_HYPOTHESIS = False             # CI installs it

    def given(*a, **k):                 # noqa: D103 - stub decorators
        return lambda f: pytest.mark.skip("hypothesis not installed")(f)

    def settings(*a, **k):
        return lambda f: f

    class st:                           # noqa: N801
        @staticmethod
        def binary(**k):
            return None

        @staticmethod
        def integers(*a, **k):
            return None

        @staticmethod
        def data():
            return None

from repro.configs.costmodel import CostModelConfig
from repro.core import service as R_SVC
from repro.core import tokenizer as R_TOK
from repro.ir import frontdoor as R_FD
from repro.ir import printer as R_PR
from repro.ir import samplers as R_SMP
from repro.ir import stablehlo as SH
from repro_torch import params as P
from repro_torch.core import models as CM
from repro_torch.core import service as T_SVC
from repro_torch.core import tokenizer as T_TOK
from repro_torch.core.server import CostModelServer
from repro_torch.ir import frontdoor as FD
from repro_torch.ir import printer as T_PR
from repro_torch.ir import samplers as T_SMP
from repro_torch.ir import stablehlo as T_SH

CFG = CostModelConfig(name="fd-port-test", vocab_size=1024, max_seq=256,
                      embed_dim=16, conv_channels=(16,) * 2,
                      fc_dims=(32,))
ARCHS5 = ("qwen3-0.6b", "xlstm-125m", "whisper-small",
          "granite-moe-1b-a400m", "starcoder2-3b")
TOL = 2e-4      # normalized rows: float32 in another order than XLA's
RTOL_DEN = 1e-3  # denormalized predictions (expm1 of a z-score)


@pytest.fixture(scope="module")
def corpus():
    """(arch, layer, text) rows of the reference's StableHLO lowering of
    >= 5 real architectures: text that the port did not produce."""
    return SH.lower_arch_corpus(list(ARCHS5), seq=8)


@pytest.fixture(scope="module")
def port_corpus():
    """The same rows from the port's own lowering."""
    return T_SH.lower_arch_corpus(list(ARCHS5), seq=8)


@pytest.fixture(scope="module")
def sh_text():
    return SH.lower_arch_corpus(["qwen3-0.6b"], seq=4)[0][2]


@pytest.fixture(scope="module")
def world():
    """One numpy param tree (the port's init, embedding x20 and biases
    drawn so predictions spread) and one vocab, served by the reference
    service and by the port's CPU service."""
    r_rng, t_rng = np.random.default_rng(7), np.random.default_rng(7)
    r_seqs = [R_TOK.graph_tokens(R_SMP.sample_graph(r_rng), "ops")
              for _ in range(16)]
    t_seqs = [T_TOK.graph_tokens(T_SMP.sample_graph(t_rng), "ops")
              for _ in range(16)]
    kw = dict(n_unk_buckets=32, byte_fallback=True,
              max_size=CFG.vocab_size)
    r_vocab = R_TOK.extend_vocab_oov(R_TOK.fit_vocab(r_seqs, max_size=600),
                                     **kw)
    t_vocab = T_TOK.extend_vocab_oov(T_TOK.fit_vocab(t_seqs, max_size=600),
                                     **kw)
    assert t_vocab.token_to_id == r_vocab.token_to_id
    params = P.to_numpy(P.conv_init(
        CFG, CM.DEFAULT_HEADS, generator=torch.Generator().manual_seed(0)))
    params["emb"] = params["emb"] * 20.0
    b_rng = np.random.default_rng(0)
    for lyr in [*params["convs"], *params["fc"], *params["heads"].values()]:
        lyr["b"] = (b_rng.normal(size=lyr["b"].shape) * 0.1).astype(
            np.float32)
    stats = {t: {"mu": 0.2, "sigma": 1.3} for t in CM.DEFAULT_HEADS}
    ref = R_SVC.CostModelService("conv1d", CFG,
                                 jax.tree.map(jax.numpy.asarray, params),
                                 r_vocab, stats, mode="ops", max_seq=256)

    def make(**kw):
        return T_SVC.CostModelService("conv1d", CFG, params, t_vocab,
                                      stats, mode="ops", max_seq=256,
                                      device="cpu", **kw)
    return {"ref": ref, "make": make, "svc": make()}


@pytest.fixture(scope="module")
def service(world):
    return world["svc"]


def _printer_texts():
    """Printer texts of every sampler family, from each package's own
    graphs (same seed), which must print identically."""
    r_rng, t_rng = np.random.default_rng(3), np.random.default_rng(3)
    out = []
    for fam in sorted(T_SMP.SAMPLERS):
        for _ in range(2):
            t = T_PR.to_mlir(T_SMP.sample_graph(t_rng, fam))
            assert t == R_PR.to_mlir(R_SMP.sample_graph(r_rng, fam))
            out.append(t)
    return out


def _texts(source, corpus, sh_text):
    if source == "printer":
        return _printer_texts()
    if source == "affine":
        return [FD.AFFINE_EXAMPLE]
    if source == "stablehlo":
        return [sh_text] + [t for _, _, t in corpus[:6]]
    if source == "fuzz":
        seeds = [t for _, _, t in corpus[:4]] + [FD.AFFINE_EXAMPLE]
        return FD.fuzz_corpus(seeds, 200, np.random.default_rng(5))
    return [b"%0 = stablehlo.add %a, %b : tensor<4xf32>\xff\xfe", b"",
            12345, None, "   \n\t ", "\x00\xff\xfe", "%"]


def _same_ingest(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, R_FD.IngestError):
        assert (got.stage, got.reason, got.detail) == \
            (want.stage, want.reason, want.detail)
        return
    assert got.key == want.key
    assert got.tokens == want.tokens
    assert got.dialects == want.dialects
    assert got.n_ops == want.n_ops
    assert (got.graph is None) == (want.graph is None)
    if want.graph is not None:
        assert got.graph.struct_key() == want.graph.struct_key()


# ------------------------------------------- the copy against the reference
@pytest.mark.parametrize("source", ["printer", "affine", "stablehlo",
                                    "fuzz", "raw"])
def test_ingest_matches_reference(source, corpus, sh_text):
    texts = _texts(source, corpus, sh_text)
    assert texts
    for text in texts:
        _same_ingest(FD.ingest(text), R_FD.ingest(text))


def test_fuzz_corpus_and_mutations_identical(corpus):
    seeds = [t for _, _, t in corpus[:4]] + [FD.AFFINE_EXAMPLE]
    assert FD.AFFINE_EXAMPLE == R_FD.AFFINE_EXAMPLE
    assert FD.OPCODE_MAP == R_FD.OPCODE_MAP
    got = FD.fuzz_corpus(seeds, 220, np.random.default_rng(11))
    want = R_FD.fuzz_corpus(seeds, 220, np.random.default_rng(11))
    assert got == want
    t_rng, r_rng = np.random.default_rng(2), np.random.default_rng(2)
    for s in seeds:
        assert FD.mutate_text(s, t_rng) == R_FD.mutate_text(s, r_rng)
    toks = R_TOK.tokenize_text(seeds[0])
    assert FD.text_key(toks) == R_FD.text_key(toks)


@pytest.mark.parametrize("source", ["printer", "affine", "stablehlo",
                                    "fuzz"])
def test_ingest_text_matches_reference(source, world, corpus, sh_text):
    """Same TextEntry (ids, key, OOV and unk rates, dialects, n_ops) or
    the same structured error from both services."""
    svc, ref = world["svc"], world["ref"]
    for text in _texts(source, corpus, sh_text):
        got, want = svc.ingest_text(text), ref.ingest_text(text)
        assert type(got).__name__ == type(want).__name__
        if isinstance(want, R_FD.IngestError):
            assert (got.stage, got.reason) == (want.stage, want.reason)
            continue
        np.testing.assert_array_equal(got.ids, want.ids)
        assert got.key == want.key
        assert got.n_tokens == want.n_tokens
        assert got.oov_rate == want.oov_rate
        assert got.unk_rate == want.unk_rate
        assert got.dialects == want.dialects
        assert got.n_ops == want.n_ops


@pytest.mark.parametrize("use_kernel", [False, True])
def test_predict_text_matches_reference(use_kernel, world, corpus,
                                        sh_text):
    """Normalized rows within TOL, denormalized predictions within
    RTOL_DEN, on printer, affine and StableHLO texts; the fused forward's
    plain version on the CPU too (the card's path runs its kernel)."""
    svc, ref = world["make"](use_kernel=use_kernel), world["ref"]
    texts = (_printer_texts() + [FD.AFFINE_EXAMPLE, sh_text]
             + [t for _, _, t in corpus[:6]])
    ents = [svc.ingest_text(t) for t in texts]
    entries = [(e.key, e.ids) for e in ents]
    got, want = svc.predict_entries(entries), ref.predict_entries(entries)
    # columns by head name: the reference's tree went through a
    # key-sorting map, so its heads may stand in another order
    cols = [list(ref.heads).index(t) for t in svc.heads]
    np.testing.assert_allclose(got, want[:, cols], rtol=0, atol=TOL)
    for text in texts:
        got, want = svc.predict_text(text), ref.predict_text(text)
        assert isinstance(got, FD.TextPrediction), got
        assert set(got.predictions) == set(want.predictions)
        for t, v in want.predictions.items():
            np.testing.assert_allclose(got.predictions[t], v,
                                       rtol=RTOL_DEN)
        assert (got.key, got.n_tokens, got.n_ops) == \
            (want.key, want.n_tokens, want.n_ops)


# ----------------------------------------------------------------- parser
def test_parse_mlir_recovers_structure():
    text = """
module {
  func.func @f(%arg0: tensor<8x64xf32>, %arg1: tensor<64x64xf32>)
      -> tensor<8x64xf32> {
    %0 = stablehlo.dot_general %arg0, %arg1 : tensor<8x64xf32>
    %1 = stablehlo.maximum %0, %0 : tensor<8x64xf32>
    return %1 : tensor<8x64xf32>
  }
}
"""
    g = FD.parse_mlir(text)
    assert g is not None
    g.validate()
    opcodes = [op.opcode for op in g.ops]
    assert "matmul" in opcodes          # dot_general mapped
    assert "max" in opcodes or "maximum" in opcodes
    assert any(op.operands for op in g.ops)
    assert g.struct_key() == R_FD.parse_mlir(text).struct_key()


def test_printer_roundtrip_structural():
    """Printer output re-ingests structurally: same op count and opcode
    multiset (the parser drops attrs, so struct keys may differ)."""
    rng = np.random.default_rng(3)
    for fam in ["bert", "resnet"]:
        g = T_SMP.sample_graph(rng, fam)
        res = FD.ingest(T_PR.to_mlir(g))
        assert isinstance(res, FD.IngestResult)
        assert res.graph is not None
        assert res.n_ops == len(g.ops)
        assert sorted(o.opcode for o in res.graph.ops) == \
            sorted(o.opcode for o in g.ops)


def test_affine_example_ingests():
    res = FD.ingest(FD.AFFINE_EXAMPLE)
    assert isinstance(res, FD.IngestResult)
    assert "affine" in res.dialects
    assert len(res.tokens) > 10


def test_ingest_error_taxonomy():
    assert FD.ingest(12345).stage == "empty"
    assert FD.ingest("").stage == "empty"
    assert FD.ingest("   \n\t ").stage == "empty"
    err = FD.ingest(None)
    assert isinstance(err, FD.IngestError)
    assert err.stage == "empty"


def test_ingest_accepts_bytes_and_mojibake(service):
    text = b"%0 = stablehlo.add %a, %b : tensor<4xf32>\xff\xfe"
    assert isinstance(FD.ingest(text), (FD.IngestResult, FD.IngestError))
    out = service.predict_text(text)
    assert isinstance(out, (FD.TextPrediction, FD.IngestError))


# --------------------------------------------------------------- end to end
def test_arch_corpus_predicts_with_zero_unk(corpus, service):
    """Every lowered per-layer subgraph of >= 5 real archs predicts end
    to end with zero collapse onto bare <unk>."""
    assert len({a for a, _, _ in corpus}) >= 5
    before = service.phase_stats()["ingested_texts"]
    for arch, layer, text in corpus:
        out = service.predict_text(text)
        assert not isinstance(out, FD.IngestError), (arch, layer, out)
        assert out.unk_rate == 0.0, (arch, layer)
        assert out.n_ops > 0, (arch, layer)
        assert set(out.predictions) == set(service.heads)
        assert all(np.isfinite(v) for v in out.predictions.values())
    ps = service.phase_stats()
    assert ps["ingested_texts"] == before + len(corpus)
    assert 0.0 <= ps["oov_rate"] <= 1.0


def test_struct_key_unifies_text_and_graph_cache(world, sh_text):
    """A text and its re-ingestion share one LRU entry, and so do a text
    and the graph its parse recovers, asked through predict_all."""
    svc = world["make"]()
    ent1, ent2 = svc.ingest_text(sh_text), svc.ingest_text(sh_text)
    assert ent1.key == ent2.key
    a = svc.predict_text(sh_text)
    b = svc.predict_text(sh_text)
    assert a.predictions == b.predictions
    assert len(svc._cache) == 1
    g = FD.ingest(sh_text).graph
    hits = svc.cache_stats()["hits"]
    out = svc.predict_all([g])
    assert svc.cache_stats()["hits"] == hits + 1
    assert len(svc._cache) == 1
    assert {t: float(v[0]) for t, v in out.items()} == a.predictions


def test_server_and_service_predict_text_parity(corpus, service):
    want = {}
    for arch, layer, text in corpus[:6]:
        want[(arch, layer)] = service.predict_text(text).predictions
    with CostModelServer(service, max_batch=8, flush_us=500) as server:
        for arch, layer, text in corpus[:6]:
            got = server.predict_text(text)
            assert not isinstance(got, FD.IngestError)
            assert got.predictions == want[(arch, layer)]
        assert server.predict_text("").stage == "empty"
        snap = server.metrics_snapshot()
        assert "phase_oov_rate" in snap
        assert 0.0 <= snap["phase_oov_rate"] <= 1.0
    # stopped server: still structured, never raises
    err = server.predict_text(corpus[0][2])
    assert isinstance(err, FD.IngestError)
    assert err.stage == "predict"


def test_forward_failure_is_a_predict_stage_error(world):
    """A forward pass that raises (on the card: a kernel that does not
    build or launch) comes back as IngestError("predict"), counted."""
    svc = world["make"]()

    def broken(ids):
        raise RuntimeError("forward failed")
    svc._apply = broken
    before = svc.phase_stats()["ingest_errors"]
    err = svc.predict_text(FD.AFFINE_EXAMPLE)
    assert isinstance(err, FD.IngestError)
    assert (err.stage, err.reason) == ("predict", "RuntimeError")
    assert svc.phase_stats()["ingest_errors"] == before + 1


def test_fuzz_corpus_never_raises(corpus, service):
    """>= 200 mutated/truncated/dialect-spliced inputs, zero uncaught
    exceptions, and no failure at the predict stage."""
    seeds = [t for _, _, t in corpus[:8]] + [FD.AFFINE_EXAMPLE]
    mutated = FD.fuzz_corpus(seeds, 200, np.random.default_rng(5))
    assert len(mutated) >= 200
    errors = 0
    for text in mutated:
        out = service.predict_text(text)   # must not raise
        if isinstance(out, FD.IngestError):
            assert out.stage != "predict", out
            errors += 1
        else:
            assert all(np.isfinite(v)
                       for v in out.predictions.values())
    assert errors < len(mutated)           # not everything degrades


def test_gate_on_the_ports_own_lowering(corpus, port_corpus, service):
    """The reference's ingest gate on the port's lowering: every row
    predicts, zero IngestErrors, unk_rate_max == 0, and each text shares
    its cache key and predictions with the reference's text of the same
    layer."""
    assert [(a, lyr) for a, lyr, _ in port_corpus] == \
        [(a, lyr) for a, lyr, _ in corpus]
    unk_max, errors = 0.0, 0
    for (arch, layer, text), (_, _, ref_text) in zip(port_corpus, corpus):
        out = service.predict_text(text)
        if isinstance(out, FD.IngestError):
            errors += 1
            continue
        unk_max = max(unk_max, out.unk_rate)
        assert out.n_ops > 0, (arch, layer)
        want = service.predict_text(ref_text)
        assert out.key == want.key, (arch, layer)
        assert out.predictions == want.predictions
    assert errors == 0
    assert unk_max == 0.0


def test_fuzz_of_the_ports_lowering_raises_nothing(port_corpus, service):
    """200 seeded mutations of the port's lowered texts: each gives a
    prediction or a structured error that is not a forward failure."""
    seeds = [t for _, _, t in port_corpus]
    mutated = FD.fuzz_corpus(seeds, 200, np.random.default_rng(0))
    assert len(mutated) == 200
    outs = [service.predict_text(t) for t in mutated]   # must not raise
    errors = [o for o in outs if isinstance(o, FD.IngestError)]
    assert all(e.stage != "predict" for e in errors)
    assert len(errors) < len(outs)


@settings(max_examples=25, deadline=None)
@given(data=st.binary(max_size=300))
def test_predict_text_total_on_arbitrary_bytes(service, data):
    """Any byte string yields a TextPrediction or an IngestError."""
    out = service.predict_text(data)
    assert isinstance(out, (FD.TextPrediction, FD.IngestError))


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_predict_text_total_under_mutation(service, sh_text, data):
    """Truncations/splices of real lowered text never escape either."""
    text = sh_text
    n = data.draw(st.integers(0, len(text)))
    mode = data.draw(st.integers(0, 2))
    if mode == 0:
        mutated = text[:n]                          # truncation
    elif mode == 1:
        mutated = text[:n] + "\x00\xff" + text[n:]  # byte damage
    else:
        mutated = text[:n] + FD.AFFINE_EXAMPLE      # dialect splice
    out = service.predict_text(mutated)
    assert isinstance(out, (FD.TextPrediction, FD.IngestError))
