"""One train step of each of the ten registered architectures, reduced,
in the port against the reference's on the same numpy params and batch,
at ``cdt=float32`` (the fixtures and helpers are
``test_torch_lm_archs.py``'s; this file runs on a test worker of its
own, since the reference compiles each arch's gradient)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import steps as RSTEPS
from repro.optim import adamw as R_ADAMW
from repro_torch import params as P
from repro_torch.models import steps as TSTEPS
from repro_torch.optim import adamw as T_ADAMW
# the fixtures one_torch_thread and world are found by name
from test_torch_lm_archs import (  # noqa: F401
    NAMES, STATE_RTOL, batch_np, float32_steps, jbatch, one_torch_thread,
    tbatch, tree_rel, world)

# At AdamW's default eps of 1e-8 the first step moves every component
# by ~lr whatever its gradient's size, so a component whose gradient is
# rounding noise moves by +-lr in either package (starcoder2's k bias:
# 2.9e-5 of the largest param apart), and a wrong gradient would pass
# unseen. eps 1e-5 keeps the step proportional to such gradients.
OPT = dict(lr=1e-3, total_steps=5, warmup_steps=0, eps=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name, world):
    rcfg, tcfg, tree = world(name)
    b = batch_np(rcfg)
    with float32_steps():
        rstep = jax.jit(RSTEPS.make_train_step(
            rcfg, R_ADAMW.AdamWConfig(**OPT)))
        rp, _, rm = rstep(tree, R_ADAMW.init_state(tree), jbatch(b))
        tstep = TSTEPS.make_train_step(tcfg, T_ADAMW.AdamWConfig(**OPT))
        tp = P.lm_from_numpy(tree, tcfg, "cpu")
        gp, gs, gm = tstep(tp, T_ADAMW.init_state(tp), tbatch(b))
    assert sorted(gm) == sorted(rm)
    for k in ("total_loss", "loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[k]), float(rm[k]), rtol=1e-5,
                                   atol=1e-7)
    assert tree_rel(rp, gp) <= STATE_RTOL
    assert int(gs["count"]) == 1
    # the inputs are not modified
    np.testing.assert_array_equal(P.to_numpy(tp)["embed"]["table"],
                                  tree["embed"]["table"])
