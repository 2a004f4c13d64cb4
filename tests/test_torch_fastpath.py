"""The port's hot-path featurization against the contracts of
``tests/test_fastpath.py``: incremental struct keys equal from-scratch
walks (and the reference's keys) across every rewrite rule, the
hashing switch, parent-delta token splicing equal to fresh encodes,
``fast_encode`` on and off giving the same rows, key-first LRU hits
that never tokenize (service and server) and the truncation counter on
both paths. Bit-identity stays within the port; rows are held to the
reference service on the same numpy params with allclose."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import models as RM
from repro.core import service as R_SVC
from repro.core import tokenizer as R_TOK
from repro.ir import samplers as R_SMP
from repro.opt import rewrites as R_RW
from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import tokenizer as TOK
from repro_torch.core.server import CostModelServer
from repro_torch.core.service import CostModelService
from repro_torch.ir import graph as IRG
from repro_torch.ir import samplers
from repro_torch.ir.graph import Graph, Tensor
from repro_torch.opt import rewrites as RW

CFG = CostModelConfig(name="fastpath", vocab_size=1024, max_seq=160,
                      embed_dim=16, conv_channels=(16,) * 6,
                      fc_dims=(32, 16))
STATS = {t: {"mu": 0.3, "sigma": 1.7} for t in RM.DEFAULT_HEADS}
TOL = 2e-4     # float32 in another accumulation order than XLA's


def _corpus(smp, tok, rw):
    """The reference fixture's graphs and vocab, from either package."""
    rng = np.random.default_rng(7)
    graphs = [smp.sample_graph(rng) for _ in range(24)]
    seqs = [tok.graph_tokens(g, "ops") for g in graphs]
    seqs += [tok.graph_tokens(rw.random_rewrite(g, rng), "ops")
             for g in graphs[:8]]
    return graphs, tok.fit_vocab(seqs, max_size=1024)


@pytest.fixture(scope="module")
def world():
    graphs, vocab = _corpus(samplers, TOK, RW)
    r_graphs, r_vocab = _corpus(R_SMP, R_TOK, R_RW)
    assert vocab.token_to_id == r_vocab.token_to_id
    params = RM.conv_init(jax.random.PRNGKey(0), CFG,
                          heads=RM.DEFAULT_HEADS)
    ref = R_SVC.CostModelService("conv1d", CFG, params, r_vocab, STATS,
                                 mode="ops", max_seq=160)
    pn = jax.tree.map(np.asarray, params)

    def make(**kw):
        kw = {"mode": "ops", "max_seq": 160, "device": "cpu", **kw}
        return CostModelService("conv1d", CFG, pn, vocab, STATS, **kw)
    return {"graphs": graphs, "r_graphs": r_graphs, "ref": ref,
            "make": make, "fast": make(), "legacy": make(fast_encode=False)}


def _rewrite_children(graphs, per_rule=2):
    out = []
    for g in graphs:
        for r in RW.default_rules():
            for s in r.applicable(g)[:per_rule]:
                try:
                    out.append(r.apply(g, s))
                except AssertionError:
                    pass
    return out


def _big_bert(tok, smp):
    rng = np.random.default_rng(1)
    while True:
        g = smp.sample_graph(rng, "bert")
        if len(tok.graph_tokens(g, "ops")) > 32:
            return g


# ----------------------------------------------------- incremental hashing
def test_struct_key_cached_and_invalidated():
    t = Tensor((4, 32))
    g = Graph()
    a = g.add_arg(t)
    x = g.add_op("relu", [a], t)
    g.outputs = [x]
    k1 = g.struct_key()
    assert g.struct_key() == k1 == g.struct_key_fresh()
    g.add_op("exp", [x], t)              # append invalidates the cache
    assert g.struct_key() != k1
    g2_key = g.struct_key()
    g.outputs = [g.n_args + 1]           # reassigning outputs too
    assert g.struct_key() != g2_key
    assert g.struct_key() == g.struct_key_fresh()


@pytest.mark.parametrize("family", sorted(samplers.SAMPLERS))
def test_incremental_equals_scratch_across_all_rules(family):
    """Every rewritten child's inherited-hash key equals a from-scratch
    walk, and the reference's key for the same rewrite sequence."""
    rng, r_rng = np.random.default_rng(0), np.random.default_rng(0)
    checked, rules_fired = 0, set()
    for seed in range(4):
        out = samplers.sample_graph(np.random.default_rng(seed), family)
        ref = R_SMP.sample_graph(np.random.default_rng(seed), family)
        for _ in range(4):
            firing = [(r, s) for r in RW.default_rules()
                      for s in r.applicable(out)]
            r_firing = [(r, s) for r in R_RW.default_rules()
                        for s in r.applicable(ref)]
            assert len(firing) == len(r_firing)
            if not firing:
                break
            i = int(rng.integers(0, len(firing)))
            assert i == int(r_rng.integers(0, len(r_firing)))
            (r, s), (rr, rs) = firing[i], r_firing[i]
            try:
                out = r.apply(out, s)
            except AssertionError:
                with pytest.raises(AssertionError):
                    rr.apply(ref, rs)
                continue
            ref = rr.apply(ref, rs)
            assert out.struct_key() == out.struct_key_fresh(), r.name
            assert out.struct_key() == ref.struct_key(), r.name
            rules_fired.add(r.name)
            checked += 1
    assert checked >= 8 and len(rules_fired) >= 2


def test_incremental_hashing_flag_restores_scratch_walks():
    g = samplers.sample_graph(np.random.default_rng(3), "bert")
    k = g.struct_key()
    prev = IRG.set_incremental_hashing(False)
    try:
        f = RW.REGISTRY["dtype_narrow"]
        child = f.apply(g, f.applicable(g)[0])
        assert child._inherited is None  # no inheritance while disabled
        assert child.struct_key() == child.struct_key_fresh()
        assert g.struct_key() == k       # keys agree across modes
    finally:
        IRG.set_incremental_hashing(prev)
    assert IRG.set_incremental_hashing(prev) is prev


def test_rewrite_children_inherit_most_hashes():
    """DCE re-hashes nothing: every survivor is a verbatim copy."""
    t = Tensor((4, 32))
    g = Graph()
    a = g.add_arg(t)
    live = g.add_op("relu", [a], t)
    g.add_op("exp", [a], t)              # dead
    g.add_op("tanh", [live], t)
    g.outputs = [g.n_args + 2]
    dce = RW.REGISTRY["dce"]
    child = dce.apply(g, dce.applicable(g)[0])
    assert set(child._inherited) == set(range(len(child.values)))
    assert child.struct_key() == child.struct_key_fresh()


# ------------------------------------------------ delta/ids-cache encoding
def test_fast_and_legacy_predictions_identical(world):
    """fast_encode on and off: the same rows bit for bit in the port,
    and the reference's rows within TOL."""
    fast, legacy, graphs = world["fast"], world["legacy"], world["graphs"]
    children = _rewrite_children(graphs[:10])
    assert children, "rewrites produced no candidates"
    for batch in (graphs, children, graphs + children):
        o1 = fast.predict_all(batch)
        o2 = legacy.predict_all(batch)
        for t in fast.heads:
            np.testing.assert_array_equal(o1[t], o2[t])
    want = world["ref"].predict_all(world["r_graphs"])
    got = fast.predict_all(graphs)
    for t in want:
        np.testing.assert_allclose(got[t], want[t], rtol=TOL, atol=TOL)


def test_delta_splice_equals_fresh_encode(world):
    fast, graphs = world["make"](), world["graphs"]
    fast.predict_all(graphs)             # parents' ids now cached
    spliced = 0
    for c in _rewrite_children(graphs):
        got = fast._delta_ids(c)
        if got is not None:
            fresh_ids, n_tok = fast._fresh_ids(c)
            np.testing.assert_array_equal(got[0], fresh_ids)
            assert got[1] == n_tok
            spliced += 1
    assert spliced > 10                  # the delta path really fired


def test_cache_hit_skips_tokenization(world):
    fast = world["make"]()
    g = world["graphs"][0]
    fast.predict_all([g])
    before = fast.phase_stats()["full_encodes"]
    for _ in range(3):                   # repeats: key-first LRU hits
        fast.predict_all([g])
    assert fast.phase_stats()["full_encodes"] == before


def test_server_submit_key_first_parity(world):
    fast, graphs = world["make"](), world["graphs"]
    direct = fast.predict_all(graphs)
    with CostModelServer(fast, max_batch=16, flush_us=500) as server:
        before = fast.phase_stats()["full_encodes"]
        via = server.predict_all(graphs)     # all LRU hits at submit
        assert fast.phase_stats()["full_encodes"] == before
        for t in fast.heads:
            np.testing.assert_array_equal(via[t], direct[t])


# ------------------------------------------------------ truncation counter
@pytest.mark.parametrize("fast_encode", [True, False])
def test_truncation_counter(world, fast_encode):
    """A graph longer than the only bucket counts one truncation on
    either encode path; on the fast path a repeat is an LRU hit that
    encodes nothing, so it adds none (the legacy path re-lexes every
    call). The reference's service counts the same."""
    svc = world["make"](max_seq=32, buckets=(32,), fast_encode=fast_encode)
    ref = R_SVC.CostModelService(
        "conv1d", CFG, world["ref"].params, world["ref"].vocab, STATS,
        mode="ops", max_seq=32, buckets=(32,), fast_encode=fast_encode)
    big, r_big = _big_bert(TOK, samplers), _big_bert(R_TOK, R_SMP)
    assert svc.truncations == 0
    for n in (1, 2):
        svc.predict_all([big])
        ref.predict_all([r_big])
        if n == 1 or fast_encode:
            assert svc.truncations == 1
        assert svc.cache_stats()["truncations"] == svc.truncations
        assert svc.truncations == ref.truncations
