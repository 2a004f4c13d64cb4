"""``lmtrain``: a language model trained through the port's LM step,
``models/steps.make_train_step``, and the training check's numbers.

Each step takes a fresh batch of ``batch_size`` rows of ``seq_len + 1``
seeded uniform token ids over the whole vocabulary (tokens the first
``seq_len``, labels the next token), drawn on the card from the seed and
the step's index. Set-up is the first ``warmup_steps`` steps: the first
three are recorded for the check, at ``optim.adamw.apply_updates`` and
at the step's ``loss``. What the check reads of the params is each
leaf's norm, so the recorder takes the norms on the card, where the
steps ran, and keeps nothing else: of the first moments after step 1,
and of the change of the params over three steps, against the first
params drawn again from the seed. The reference starts from the params
drawn again too, after the window. The driver turns the card's
expandable segments on before the runner draws the weights: the
training step's peak fragments the cache without them.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np

from bench.harness import model as M
from bench.harness import spec as SP
from bench.reference import train as RTR

N_CHECKED = 3
NORM_CHUNK = 1 << 26    # entries a slice of a leaf's float64 norm
# the controls: the reference's faults, and the first half of each
# batch's rows alone
CONTROLS = ("bf16_scan", "no_inner_norms", "chunk_reset", "half_batch")


def batch(run, k: int, device=None) -> Dict:
    """Step ``k``'s (0-based) tokens and labels, from the seed."""
    import torch
    tr = run.traffic
    dev = run.device if device is None else device
    seed = int(np.random.SeedSequence([run.seed % 2 ** 63, 17, k])
               .generate_state(2, np.uint32).view(np.uint64)[0] >> 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, run.cfg["vocab_size"],
                        (tr["batch_size"], tr["seq_len"] + 1),
                        generator=gen, device=dev)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def first_params(run):
    """The first params, drawn from the seed as the runner draws them and
    finished as the configuration's kind finishes them."""
    p = M.seeded_params(run.cfg, run.seed, run.device)
    SP.model(run.cfg["kind"]).finish(p)
    return p


def _norms(xs, base=None) -> np.ndarray:
    """Each leaf's float64 norm (of ``x - base`` with ``base``), taken
    where the leaf is, a slice of ``NORM_CHUNK`` entries at a time."""
    import torch
    out = []
    for i, x in enumerate(xs):
        x = x.detach().reshape(-1)
        b = None if base is None else base[i].detach().reshape(-1)
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for k in range(0, x.numel(), NORM_CHUNK):
            seg = x[k:k + NORM_CHUNK].double()
            if b is not None:
                seg = seg - b[k:k + NORM_CHUNK].double()
            total += seg.square().sum()
        out.append(total)
    if not out:
        return np.zeros(0)
    return np.sqrt(torch.stack(out).cpu().numpy())


def _flat(tree) -> list:
    return [x for _, x in RTR.leaves(tree)]


class _Recorder:
    """Around ``optim.adamw.apply_updates`` for the first three steps:
    each leaf's norm of the first gradient as the optimizer got it (the
    first moments after step 1 over 1 - b1), and of its change over the
    three steps (the params after step 3 less ``first()``, the first
    params)."""

    def __init__(self, b1: float, first):
        self.b1, self.first = b1, first
        self.n = 0
        self.gn = None
        self.dn = None

    def install(self):
        from repro_torch.optim import adamw
        self._adamw, self._apply = adamw, adamw.apply_updates
        adamw.apply_updates = self.apply_updates

    def uninstall(self):
        self._adamw.apply_updates = self._apply

    def apply_updates(self, params, grads, state, cfg):
        new_p, new_s, met = self._apply(params, grads, state, cfg)
        self.n += 1
        if self.n == 1:
            self.gn = _norms(_flat(new_s["m"])) / (1 - self.b1)
        if self.n == N_CHECKED:
            self.dn = _norms(_flat(new_p), _flat(self.first()))
            self.uninstall()
        return new_p, new_s, met


class _ScanRecorder:
    """Around ``models.mamba.selective_scan`` for its first call (the
    first Mamba layer of step 1): its inputs and its output, on the
    host."""

    def __init__(self):
        self.seen = None

    def install(self):
        from repro_torch.models import mamba
        self._mamba, self._scan = mamba, mamba.selective_scan
        mamba.selective_scan = self.selective_scan

    def uninstall(self):
        self._mamba.selective_scan = self._scan

    def selective_scan(self, *ins):
        y = self._scan(*ins)
        if self.seen is None:
            self.seen = [_host(t) for t in ins + (y,)]
            self.uninstall()
        return y


def _opt(tr: dict):
    """The program's and the reference's AdamW, as the mix sets it."""
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=tr["lr"], weight_decay=tr["weight_decay"],
                             warmup_steps=tr["warmup"],
                             total_steps=tr["total_steps"])


class Driver:
    """Trainers of a hybrid LM at its published widths: the port's LM
    train step (f32 master weights and AdamW state, bf16 products,
    per-slot recomputation) on seeded batches, no checkpoint."""
    kind = "lmtrain"

    def __init__(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:True")

    def setup(self, run) -> dict:
        import torch
        from repro_torch.models import steps
        from repro_torch.optim import adamw
        kind = SP.model(run.cfg["kind"])
        kind.finish(run.params)
        # the runner's draw: the program's own from here (the check
        # draws the first params again)
        params, run.params = run.params, None
        arch = kind.port_config(run.cfg)
        opt_state = adamw.init_state(params)
        step = steps.make_train_step(arch, _opt(run.traffic), remat=True)
        rec = _Recorder(_opt(run.traffic).b1, lambda: first_params(run))
        scan = _ScanRecorder()
        rec.install()
        scan.install()
        losses, batches = [], []
        try:
            for k in range(run.traffic["warmup_steps"]):
                b = batch(run, k)
                params, opt_state, met = step(params, opt_state, b)
                if k < N_CHECKED:
                    losses.append(float(met["loss"]))
                    batches.append(b["tokens"].cpu())
        finally:
            if rec.n < N_CHECKED:
                rec.uninstall()
            if scan.seen is None:
                scan.uninstall()
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        # the runner freezes what set-up leaves for the window: no cyclic
        # garbage holding the card's memory among it
        gc.collect()
        return {"params": params, "opt_state": opt_state, "step": step,
                "rec": rec, "scan": scan.seen, "losses": losses,
                "batches": batches, "arch": arch}

    def window(self, run, st) -> dict:
        import torch
        from repro_torch.kernels import selective_scan as SS
        tr, dev = run.traffic, run.device
        k0 = tr["warmup_steps"]

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        params, opt_state, step = st.pop("params"), st.pop("opt_state"), \
            st["step"]
        sync()
        start = time.perf_counter()
        run.setup_s = start - run.t0
        run.tracer.start()
        start, wall0 = time.perf_counter(), time.time()
        launches0, n, traced = SS.selective_scan.launches, 0, 0
        while True:
            params, opt_state, _ = step(params, opt_state,
                                        batch(run, k0 + n))
            n += 1
            if run.trace and n == tr["trace_steps"]:
                run.tracer.stop()
                traced = n
            if time.perf_counter() >= start + run.seconds and \
                    (traced or not run.trace):
                break
        sync()
        end = time.perf_counter()
        st["params"], st["opt_state"] = params, opt_state
        return {"n": n, "failed": 0, "seconds": end - start,
                "rows": n * tr["batch_size"], "traced": traced,
                "wall": (wall0, time.time()),
                "scan_launches": SS.selective_scan.launches - launches0,
                "rows_per_step": tr["batch_size"], "seq": tr["seq_len"],
                "d_inner": st["arch"].hybrid.expand * st["arch"].d_model,
                "d_state": st["arch"].hybrid.d_state}

    def work(self, run, st, win):
        """A traced step's model operations, once a traced step."""
        f = SP.model(run.cfg["kind"]).step_flops(
            run.cfg, run.traffic["batch_size"], run.traffic["seq_len"])
        return [(f, 0)] * win["traced"]

    def stop(self, st) -> None:
        st.clear()

    def answers(self, run, st, win):
        rec = st["rec"]
        return {"losses": st["losses"], "gn": rec.gn, "dn": rec.dn,
                "batches": st["batches"], "scan": st["scan"]}

    def check(self, run, ans, fault: Optional[str] = None
              ) -> Dict[str, float]:
        return lm_numbers(run, ans, fault)

    def end_to_end(self, run, win) -> Dict[str, float]:
        return {"train_graphs_per_s": win["rows"] / win["seconds"]}

    def attempted(self, win) -> int:
        return win["n"]

    def report(self, win) -> str:
        return (f"steps in window {win['n']} over {win['seconds']} s, "
                f"{win['rows']} rows, {win['scan_launches']} scan launches")


def _gaps(got, ref, keep) -> np.ndarray:
    if got is None or len(got) != len(ref):
        return np.full(1, np.inf)
    den = np.maximum(ref, np.median(ref))
    return (np.abs(got - ref) / den)[keep]


def _ref_steps(run, pairs, fault: Optional[str] = None):
    """The reference's steps on ``pairs`` from the first params, with
    ``fault`` (``reference/jamba.py``'s): the losses, and each leaf's
    norm of the first (clipped) gradient and of the change."""
    p0 = first_params(run)
    ref = SP.reference(run.cfg["kind"])
    losses, g1, p3 = ref.run_steps(p0, pairs, _ref_opt(run.traffic),
                                   SP.model(run.cfg["kind"]).dims(run.cfg),
                                   run.device, fault=fault)
    gn = _norms(g1)
    del g1
    return losses, gn, _norms(p3, _flat(p0))


def _reference(run, ans) -> dict:
    """The reference's three steps, computed once an answer and kept in
    it."""
    if "_ref" not in ans:
        losses, gn, dn = _ref_steps(run, _pairs(run))
        ans["_ref"] = {"losses": losses, "gn": gn, "dn": dn}
    return ans["_ref"]


def _pairs(run):
    return [(b["tokens"], b["labels"])
            for b in (batch(run, k) for k in range(N_CHECKED))]


def _ref_opt(tr: dict) -> RTR.AdamW:
    p = _opt(tr)
    return RTR.AdamW(lr=p.lr, weight_decay=p.weight_decay,
                     warmup_steps=p.warmup_steps, total_steps=p.total_steps,
                     b1=p.b1, b2=p.b2, eps=p.eps, clip_norm=p.clip_norm,
                     min_lr_ratio=p.min_lr_ratio)


def lm_numbers(run, ans, fault: Optional[str] = None) -> Dict[str, float]:
    """The training check's numbers, as ``bench/drivers/train.py``'s
    ``train_numbers`` defines them, against ``bench/reference/jamba.py``
    run on the same three batches from the same weights:

    * ``batch_mismatch``: rows of the first three batches the program
      trained on that are not the seed's;
    * ``loss1_rel_err``, ``loss_rel_err``: the first step's loss's
      relative gap and the largest of the three;
    * ``grad1_med_gap``, ``grad1_gap``: the median and the worst leaf's
      gap between the norms of the first gradient as the optimizer got
      it (its first moment over 1 - b1) and the reference's, over the
      larger of that leaf's reference norm and the median leaf's;
    * ``delta3_med_gap``, ``delta3_gap``: the same for each leaf's
      change over three steps, leaving out leaves whose reference
      gradient is under a thousandth of the median leaf's;
    * ``scan_rel_err``: the first Mamba layer's scan output in step 1
      (the kernel's, on the card) against the reference's recurrence on
      the same inputs, the largest gap over the largest output.

    The whole-step numbers carry the program's bfloat16 activations
    against the reference's float32 ones; the scan's number sees the
    scan alone, in float32 on both sides.

    ``fault``, one of ``CONTROLS``, puts the reference with that fault
    (``reference/jamba.py``'s ``FAULTS``), or the reference on the first
    half of each batch's rows (``"half_batch"``), in the program's
    place."""
    import torch
    tr = run.traffic
    cpu = torch.device("cpu")
    pairs = _pairs(run)
    bad = sum(int((a.to(cpu) != t.to(cpu)).any(dim=1).sum())
              for a, (t, _) in zip(ans["batches"], pairs))
    bad += tr["batch_size"] * (N_CHECKED - len(ans["batches"]))
    r = _reference(run, ans)
    if fault == "half_batch":
        half = tr["batch_size"] // 2
        losses, gn, dn = _ref_steps(run, [(t[:half], y[:half])
                                          for t, y in pairs])
    elif fault is not None:
        losses, gn, dn = _ref_steps(run, pairs, fault)
    else:
        losses, gn, dn = ans["losses"], ans["gn"], ans["dn"]
    scan_err = _scan_err(run, ans, fault if fault != "half_batch" else None)
    keep = r["gn"] >= 1e-3 * np.median(r["gn"])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, r["losses"])]
    g = _gaps(gn, r["gn"], np.ones_like(keep))
    d = _gaps(dn, r["dn"], keep)
    return {
        "batch_mismatch": float(bad),
        "loss1_rel_err": float(rel[0]) if rel else float("inf"),
        "loss_rel_err": float(max(rel)) if len(rel) == len(r["losses"])
        else float("inf"),
        "grad1_med_gap": float(np.median(g)), "grad1_gap": float(g.max()),
        "delta3_med_gap": float(np.median(d)), "delta3_gap": float(d.max()),
        "scan_rel_err": scan_err}


def _scan_err(run, ans, fault: Optional[str]) -> float:
    """The recorded scan's output (or, with ``fault``, the reference's
    with that fault) against the reference's, on the recorded inputs."""
    import torch
    if ans["scan"] is None:
        return float("inf")
    ref = SP.reference(run.cfg["kind"])
    x, dt, A, Bm, Cm, D, y = (t.to(run.device) for t in ans["scan"])
    with torch.no_grad(), ref.ieee():
        want = ref.scan(x, dt, A, Bm, Cm) + D * x
        if fault is not None:
            y = ref.scan(x, dt, A, Bm, Cm, fault) + D * x
    return float((y - want).abs().max() / want.abs().max())
