"""The port's copies of the numpy-only modules (graph IR, samplers,
analyzers, printer, augment, tokenizer, dataset, the architecture
configs) give exactly what the reference modules give for the same
seed."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as R_CFG
from repro.core import augment as R_AUG
from repro.core import tokenizer as R_TOK
from repro.data import pipeline as R_PIPE
from repro.ir import analyzers as R_AN
from repro.ir import dataset as R_DS
from repro.ir import printer as R_PR
from repro.ir import samplers as R_SMP
from repro_torch import configs as T_CFG
from repro_torch.core import augment as T_AUG
from repro_torch.core import tokenizer as T_TOK
from repro_torch.data import pipeline as T_PIPE
from repro_torch.ir import analyzers as T_AN
from repro_torch.ir import dataset as T_DS
from repro_torch.ir import printer as T_PR
from repro_torch.ir import samplers as T_SMP


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("mode", ["ops", "ops_operands"])
def test_build_dataset_identical(layout, mode):
    kw = dict(mode=mode, max_seq=128, vocab_size=512, seed=3,
              augment_factor=2, layout=layout)
    ref = R_DS.build_dataset(60, **kw)
    got = T_DS.build_dataset(60, **kw)
    assert got.vocab.token_to_id == ref.vocab.token_to_id
    assert set(got.targets) == set(ref.targets)
    for k in ref.targets:
        np.testing.assert_array_equal(got.targets[k], ref.targets[k])
    np.testing.assert_array_equal(got.seq_lens, ref.seq_lens)
    np.testing.assert_array_equal(got.dense_ids(), ref.dense_ids())
    if layout == "bucketed":
        assert set(got.bucket_ids) == set(ref.bucket_ids)
        for b in ref.bucket_ids:
            np.testing.assert_array_equal(got.bucket_ids[b],
                                          ref.bucket_ids[b])
            np.testing.assert_array_equal(got.bucket_rows[b],
                                          ref.bucket_rows[b])


def test_dataset_texts_split_and_normalize():
    ref = R_DS.build_dataset(30, max_seq=64, vocab_size=256, seed=5,
                             keep_texts=True)
    got = T_DS.build_dataset(30, max_seq=64, vocab_size=256, seed=5,
                             keep_texts=True)
    assert got.texts == ref.texts
    (g_tr, g_te), (r_tr, r_te) = got.split(0.2, seed=1), ref.split(0.2,
                                                                  seed=1)
    np.testing.assert_array_equal(g_tr.ids, r_tr.ids)
    np.testing.assert_array_equal(g_te.ids, r_te.ids)
    heads = ("register_pressure", "latency_us")
    g_y, g_st = T_DS.normalize_targets_multi(got.targets, heads)
    r_y, r_st = R_DS.normalize_targets_multi(ref.targets, heads)
    assert g_st == r_st
    for t in heads:
        np.testing.assert_array_equal(g_y[t], r_y[t])
    assert T_DS.default_buckets(256) == R_DS.default_buckets(256)


@pytest.mark.parametrize("family", sorted(R_SMP.SAMPLERS))
def test_sampled_graphs_identical(family):
    r_rng, t_rng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(4):
        rg = R_SMP.sample_graph(r_rng, family)
        tg = T_SMP.sample_graph(t_rng, family)
        assert tg.struct_key() == rg.struct_key()
        assert T_PR.to_mlir(tg) == R_PR.to_mlir(rg)
        assert T_AN.analyze(tg) == R_AN.analyze(rg)
        for mode in ("ops", "ops_operands"):
            assert T_TOK.graph_tokens(tg, mode) == \
                R_TOK.graph_tokens(rg, mode)
        # augmentation consumes the generator identically too
        ra, ta = R_AUG.augment(rg, r_rng), T_AUG.augment(tg, t_rng)
        assert ta.struct_key() == ra.struct_key()
    assert list(T_AN.TARGETS) == list(R_AN.TARGETS)


def test_vocab_encode_identical():
    rng = np.random.default_rng(2)
    seqs = [R_TOK.graph_tokens(R_SMP.sample_graph(rng), "ops")
            for _ in range(12)]
    from collections import Counter
    counts = Counter(t for s in seqs for t in s)
    rv = R_TOK.vocab_from_counts(counts, max_size=64, n_unk_buckets=4)
    tv = T_TOK.vocab_from_counts(counts, max_size=64, n_unk_buckets=4)
    assert tv.token_to_id == rv.token_to_id
    np.testing.assert_array_equal(tv.encode_many(seqs, 48),
                                  rv.encode_many(seqs, 48))


@pytest.mark.parametrize("width", [3, 8, 12])
def test_fit_width_identical(width):
    arr = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    np.testing.assert_array_equal(T_PIPE.fit_width(arr, width),
                                  R_PIPE.fit_width(arr, width))


# fields only the port's configs have, each with the value that keeps
# the reference's behaviour
PORT_ONLY = {"rope": True, "hybrid": {"inner_norms": False}}


def _reference_fields(cfg):
    """``asdict(cfg)`` without the port-only fields, each checked to hold
    its default."""
    d = dataclasses.asdict(cfg)
    assert d.pop("rope") is PORT_ONLY["rope"]
    if d["hybrid"] is not None:
        assert d["hybrid"].pop("inner_norms") is \
            PORT_ONLY["hybrid"]["inner_norms"]
    return d


@pytest.mark.parametrize("name", sorted(R_CFG.ARCHS))
def test_arch_configs_identical(name):
    """Every registered architecture and its reduced widths, field for
    field, and every (arch, shape) eligibility."""
    ref, got = R_CFG.get_arch(name), T_CFG.get_arch(name)
    assert _reference_fields(got) == dataclasses.asdict(ref)
    assert _reference_fields(got.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert got.resolved_head_dim == ref.resolved_head_dim
    for shape in sorted(R_CFG.SHAPES):
        assert T_CFG.shape_eligible(got, T_CFG.SHAPES[shape]) == \
            R_CFG.shape_eligible(ref, R_CFG.SHAPES[shape])


def test_arch_registry_and_shapes_identical():
    assert sorted(T_CFG.ARCHS) == sorted(R_CFG.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in T_CFG.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_CFG.SHAPES.items()}
    assert set(T_CFG.__all__) == set(R_CFG.__all__)
    with pytest.raises(KeyError, match="unknown arch"):
        T_CFG.get_arch("no-such-arch")
