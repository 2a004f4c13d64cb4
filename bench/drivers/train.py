"""``train``: maintainers training the served model with
``TrainEngine``, and the training check's numbers."""
from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np

from bench.harness import graphs as G
from bench.harness import model as M
from bench.harness import spec as SP


class _Recorder:
    """The first steps of a ``TrainEngine.fit``, as the optimizer and
    the loss see them: installed around ``optim.adamw.apply_updates``
    and ``core.trainer.make_loss_fn`` for ``n`` steps, then taken out
    (the loss's is a counter check a step)."""

    def __init__(self, n: int):
        self.n = n
        self.losses: List = []
        self.params: List = []      # params after steps 1..n
        self.m1 = None              # first moments after step 1

    def install(self):
        from repro_torch.core import trainer
        from repro_torch.optim import adamw
        self._adamw, self._trainer = adamw, trainer
        self._apply, self._make_loss = adamw.apply_updates, \
            trainer.make_loss_fn
        adamw.apply_updates = self.apply_updates
        trainer.make_loss_fn = self.make_loss_fn

    def uninstall(self):
        self._adamw.apply_updates = self._apply
        self._trainer.make_loss_fn = self._make_loss

    def apply_updates(self, params, grads, state, cfg):
        new_p, new_s, met = self._apply(params, grads, state, cfg)
        self.params.append(_clone_tree(new_p))
        if self.m1 is None:
            self.m1 = _clone_tree(new_s["m"])
        if len(self.params) >= self.n:
            self._adamw.apply_updates = self._apply
        return new_p, new_s, met

    def make_loss_fn(self, apply_fn, heads=None):
        loss_fn = self._make_loss(apply_fn, heads)
        losses, n = self.losses, self.n

        def recorded(params, ids, y):
            loss = loss_fn(params, ids, y)
            if len(losses) < n:
                losses.append(loss.detach().clone())
            return loss
        return recorded


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.detach().clone()


def _targets(graphs, heads, seed: int) -> Dict[str, np.ndarray]:
    """Positive float32 targets a head from each graph's size (ops and
    log elements), with seeded coefficients and noise: learnable, and
    what the trainer normalizes."""
    rng = np.random.default_rng([seed, 13])
    n_ops = np.log1p([len(g.ops) for g in graphs])
    elems = np.log1p([sum(float(np.prod(v.shape)) for v in g.values)
                      for g in graphs]) / 10.0
    out = {}
    for t in heads:
        a, b, c = rng.uniform(1.0, 3.0), rng.uniform(0.2, 1.0), \
            rng.uniform(0.2, 1.0)
        noise = rng.normal(0.0, 0.1, len(graphs))
        out[t] = np.exp(a + b * n_ops + c * elems + noise).astype(np.float32)
    return out


class Driver:
    """Maintainers training the served model: ``TrainEngine`` on conv1d
    with the three heads jointly over a corpus built in set-up, the
    bucketed loader, AdamW, no checkpoint. Set-up is the engine's first
    ``warmup_steps`` steps (the first three recorded for the check); the
    window is the same ``fit`` call's later steps, ended through the
    engine's preemption path."""
    kind = "train"

    def setup(self, run) -> dict:
        from repro_torch.core import tokenizer as TOK
        from repro_torch.core.trainer import TrainEngine
        from repro_torch.ir.dataset import CostDataset
        from bench.reference import tokenizer as RT
        cfg, tr = run.cfg, run.traffic
        rng = random.Random(f"corpus/{run.seed}")
        graphs = [G.sample(rng, M.families(tr))
                  for _ in range(tr["corpus_graphs"])]
        toks = [RT.graph_tokens(g, cfg["mode"]) for g in graphs]
        ids = np.stack([RT.encode(t, run.vocab, cfg["max_seq"])
                        for t in toks]).astype(np.int32)
        lens = np.asarray([min(len(t), cfg["max_seq"]) for t in toks],
                          np.int32)
        targets = _targets(graphs, cfg["heads"], run.seed)
        data = CostDataset(ids=ids.copy(), targets={
            t: v.copy() for t, v in targets.items()},
            vocab=TOK.Vocab(dict(run.vocab)), mode=cfg["mode"],
            max_seq=cfg["max_seq"], seq_lens=lens.copy())
        engine = TrainEngine(
            cfg["kind"], SP.model(cfg["kind"]).port_config(cfg),
            tuple(cfg["heads"]),
            steps=tr["total_steps"], batch_size=tr["batch_size"],
            lr=tr["lr"], weight_decay=tr["weight_decay"],
            seed=run.seed % (2 ** 32), log_every=tr["total_steps"],
            install_sigterm=True, device=str(run.device))
        init = M.tree_to(run.params, run.device)
        engine.init_fn = lambda c, heads=None, *, generator: init
        widths: List[int] = []
        batches: List = []
        make_loader = engine.make_loader

        def loader(train, y):
            ld = make_loader(train, y)
            iterate = ld._iterate

            def recorded():
                for b in iterate():
                    widths.append(b["ids"].shape[1])
                    if len(batches) < 3:
                        batches.append({k: v.copy() for k, v in b.items()})
                    yield b
            ld._iterate = recorded
            return ld
        engine.make_loader = loader
        return {"engine": engine, "data": data, "ids": ids, "lens": lens,
                "targets": targets, "widths": widths, "batches": batches,
                "recorder": _Recorder(3)}

    def window(self, run, st) -> dict:
        import os
        import signal
        import torch
        tr, dev = run.traffic, run.device
        k0, n_trace = tr["warmup_steps"], tr["trace_steps"]
        mark: Dict[str, float] = {}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def on_step(step, dt):
            if step == k0:
                st["recorder"].uninstall()
                sync()
                mark["start"] = time.perf_counter()
                run.setup_s = mark["start"] - run.t0
                run.tracer.start()
                mark["start"] = time.perf_counter()
            elif step == k0 + n_trace and run.trace:
                run.tracer.stop()
            if step > k0 and "end" not in mark and \
                    time.perf_counter() >= mark["start"] + run.seconds:
                sync()
                mark["end"], mark["steps"] = time.perf_counter(), step - k0
                os.kill(os.getpid(), signal.SIGTERM)   # the preemption path

        st["recorder"].install()
        prev = signal.getsignal(signal.SIGTERM)
        try:
            st["engine"].fit(st["data"], on_step=on_step)
        finally:
            signal.signal(signal.SIGTERM, prev)
            st["recorder"].uninstall()
        if "end" not in mark:
            raise RuntimeError(f"the window did not close within "
                               f"{tr['total_steps']} steps")
        return {"n": mark["steps"], "failed": 0,
                "seconds": mark["end"] - mark["start"],
                "rows": mark["steps"] * tr["batch_size"]}

    def work(self, run, st, win):
        """Three forwards a trained row, at its batch's width, for the
        traced steps."""
        k0, n = run.traffic["warmup_steps"], run.traffic["trace_steps"]
        rows = run.traffic["batch_size"]
        row_flops = SP.model(run.cfg["kind"]).row_flops
        return [(3 * rows * row_flops(run.cfg, w), 0)
                for w in st["widths"][k0:k0 + n]]

    def stop(self, st) -> None:
        st.pop("engine", None)

    def answers(self, run, st, win):
        rec = st["recorder"]
        return {"losses": [float(x) for x in rec.losses],
                "m1": rec.m1, "params": rec.params,
                "batches": st["batches"], "ids": st["ids"],
                "lens": st["lens"], "targets": st["targets"]}

    def check(self, run, ans, precision: str = "ieee",
              keep_rows: float = 1.0) -> Dict[str, float]:
        return train_numbers(run, ans, precision, keep_rows)

    def end_to_end(self, run, win) -> Dict[str, float]:
        return {"train_graphs_per_s": win["rows"] / win["seconds"]}

    def attempted(self, win) -> int:
        return win["n"]

    def report(self, win) -> str:
        return (f"steps in window {win['n']} over {win['seconds']} s, "
                f"{win['rows']} rows")


def train_numbers(run, ans, precision: str = "ieee",
                  keep_rows: float = 1.0) -> Dict[str, float]:
    """The training check's numbers. The loader's first three batches
    are found row by row in the benchmark's corpus (by normalized
    target) and held to it; the reference then runs the same three steps
    from the same weights on its own copy of those rows.

    * ``loader_mismatch``: rows of the first three batches that are not
      the corpus's rows at the batch's bucket width, or repeat;
    * ``loss1_rel_err`` and ``loss_rel_err``: the relative gap of the
      first step's loss and the largest over the three steps;
    * ``grad1_med_gap`` (compared) and ``grad1_gap`` (reported): the
      median and the worst leaf's gap between the norms of the first
      gradient as the optimizer got it (its first moment over 1 - b1)
      and the reference's, over the larger of that leaf's reference norm
      and the median leaf's;
    * ``delta3_med_gap`` (compared) and ``delta3_gap`` (reported): the
      same for each leaf's change over three steps, leaving out leaves
      whose reference gradient is under a thousandth of the median
      leaf's (they move by round-off alone).

    A max-pool near-tie that the two sides' sums break differently sends
    a row's gradient to another position (see ``PERF.md``): the worst
    leaf's gaps swing with it from seed to seed, the median leaf's less.

    ``precision`` and ``keep_rows`` put the reference, run that way, in
    the program's place: the lower-precision control and the planted
    half-batch fault."""
    import torch
    from bench.reference import tokenizer as RT
    from bench.reference import train as RTR
    cfg, tr, dev = run.cfg, run.traffic, run.device
    heads = cfg["heads"]
    y_all = RTR.normalize(ans["targets"], heads)
    where = {y_all[i].tobytes(): i for i in range(len(y_all))}
    bad, seen, ref_batches = 0, set(), []
    for b in ans["batches"]:
        width = b["ids"].shape[1]
        rows = [where.get(np.asarray(r, np.float32).tobytes(), -1)
                for r in b["y"]]
        want = max(RT.bucket_of(int(ans["lens"][i]), cfg)
                   for i in rows if i >= 0) if any(
            i >= 0 for i in rows) else -1
        for r, i in zip(b["ids"], rows):
            if i < 0 or i in seen or width != want or \
                    (ans["ids"][i, width:] != 0).any() or \
                    not np.array_equal(r, ans["ids"][i, :width]):
                bad += 1
            seen.add(i)
        ok = [i for i in rows if i >= 0]
        ref_batches.append((
            torch.from_numpy(ans["ids"][ok, :width].astype(np.int64)).to(dev),
            torch.from_numpy(y_all[ok]).to(dev)))
    opt = RTR.AdamW(lr=tr["lr"], weight_decay=tr["weight_decay"],
                    warmup_steps=min(50, tr["total_steps"] // 10),
                    total_steps=tr["total_steps"])
    forward = SP.reference(cfg["kind"]).forward
    ref_losses, ref_g1, ref_p3 = RTR.run_steps(run.params, ref_batches, opt,
                                               forward=forward)
    if precision != "ieee" or keep_rows != 1.0:
        losses, g1, p3 = RTR.run_steps(run.params, ref_batches, opt,
                                       precision, keep_rows, forward)
    else:
        losses = ans["losses"]
        g1 = [x / (1 - opt.b1) for _, x in RTR.leaves(ans["m1"])]
        p3 = [x for _, x in RTR.leaves(ans["params"][2])] \
            if len(ans["params"]) >= 3 else []
    p0 = [x for _, x in RTR.leaves(run.params)]

    def norms(xs):
        return np.asarray([float(torch.linalg.vector_norm(x.double()))
                           for x in xs])

    def gaps(got, ref, keep):
        if len(got) != len(ref):
            return np.full(1, np.inf)
        den = np.maximum(ref, np.median(ref))
        return (np.abs(got - ref) / den)[keep]

    ref_gn = norms(ref_g1)
    keep = ref_gn >= 1e-3 * np.median(ref_gn)
    loss_err = max((abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                   default=float("inf")) if len(losses) == len(ref_losses) \
        else float("inf")
    loss1 = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]) \
        if losses else float("inf")
    g = gaps(norms(g1) if g1 is not None else np.zeros(0), ref_gn,
             np.ones_like(keep))
    d = gaps(norms([a - b for a, b in zip(p3, p0)]),
             norms([a - b for a, b in zip(ref_p3, p0)]), keep)
    return {
        "loader_mismatch": float(bad),
        "loss1_rel_err": float(loss1),
        "loss_rel_err": float(loss_err),
        "grad1_med_gap": float(np.median(g)), "grad1_gap": float(g.max()),
        "delta3_med_gap": float(np.median(d)), "delta3_gap": float(d.max())}
