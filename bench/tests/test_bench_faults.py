"""Whole harness runs on the CPU with the timed path broken underneath:
each fault the cell can have makes ``correct`` come out false.

* serving and search: an answer altered where it is produced (K1's
  plain version, which the service runs on the CPU, returns each
  batch's first row moved);
* training: a step that returns its state unchanged, and half of the
  batch left out of the loss (the mean taken over the rest)."""
import pytest

import benchtest_util  # noqa: F401
from benchtest_util import run_small

torch = pytest.importorskip("torch")


@pytest.fixture
def altered_answer(monkeypatch):
    from repro_torch.kernels import conv1d_stack
    plain = conv1d_stack.REF.conv_forward_fused_ref

    def moved(*args):
        out = plain(*args).clone()
        out[0] += 0.01
        return out
    monkeypatch.setattr(conv1d_stack.REF, "conv_forward_fused_ref", moved)


@pytest.mark.parametrize("cell", ["base-serve-open", "base-search"])
def test_sound_run_is_correct(cell):
    out = run_small(cell, seed=901)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("cell", ["base-serve-open", "base-search"])
def test_altered_answer_is_not_correct(cell, altered_answer):
    out = run_small(cell, seed=902)
    assert not out["correct"], out["check"]
    assert out["check"]["pred_rel_err"]["value"] > \
        out["check"]["pred_rel_err"]["limit"]


def test_unchanged_state_is_not_correct(monkeypatch):
    from repro_torch.optim import adamw
    apply = adamw.apply_updates

    def unchanged(params, grads, state, cfg):
        _, new_state, met = apply(params, grads, state, cfg)
        return params, new_state, met
    monkeypatch.setattr(adamw, "apply_updates", unchanged)
    out = run_small("base-train", seed=903)
    assert not out["correct"], out["check"]
    assert out["check"]["delta3_med_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct(monkeypatch):
    from repro_torch.core import trainer
    make = trainer.make_loss_fn

    def half(apply_fn, heads=None):
        loss_fn = make(apply_fn, heads)

        def halved(params, ids, y):
            n = ids.shape[0] // 2
            return loss_fn(params, ids[:n], y[:n])
        return halved
    monkeypatch.setattr(trainer, "make_loss_fn", half)
    out = run_small("base-train", seed=904)
    assert not out["correct"], out["check"]
