"""Supervised training for the cost models (paper §3-4) — one engine.

:class:`TrainEngine` owns the port's ONE training step loop; callers build
an engine and call :meth:`TrainEngine.fit` (or the :func:`train_model`
wrapper). The engine wires the full substrate every time:

* a prefetching :class:`repro_torch.data.pipeline.Loader` (deterministic,
  resumable cursor), **bucket-aware** by default: batches are grouped by
  power-of-two sequence bucket (the same ladder serving uses, including
  the conv1d pad-slack rule), so a step runs at its bucket's width
  instead of the global ``max_seq``;
* optional int8 error-feedback gradient compression;
* a :class:`~repro_torch.runtime.fault.TrainSupervisor` step loop:
  periodic + on-preemption atomic checkpoints carrying the loader cursor,
  and automatic resume — or, with ``ckpt_dir=None``, the same loop with
  persistence disabled. The checkpoints are the reference's files, so
  either side resumes the other's run.

The step is autograd over the plain apply of :func:`~repro_torch.core.
models.get_model` (no fused kernel has a backward), then AdamW
(:mod:`repro_torch.optim.adamw`). The loss stays on the device between
log points. Training runs on the card unless ``device="cpu"``.

On one card (a CUDA device and no mesh) the step's device work, forward,
backward, compression and AdamW, is captured as one CUDA graph per
batch shape and replayed (:class:`_StepGraphs`): the host then makes
one launch a step where it made some 300. The params, the optimizer
state and the compression's error state live in tensors the engine
owns, and each step writes its results into them in place, so a
replayed step is the eager step's arithmetic. The CPU and the mesh run
the step eagerly.

On a mesh (``mesh_data * mesh_model > 1``) the engine runs inside a
default process group of exactly that many ranks (one process a rank;
``launch.train`` spawns them). It builds the ``(data, model)`` mesh,
places the params, optimizer state and error state as DTensors by the
family's logical axes (:func:`~repro_torch.core.models.get_axes`, as
the reference places them), and splits each global batch ``Shard(0)``
over ``data``: every rank's Loader draws the same global batch and keeps
its own rows. DTensor then computes the reference's global step (the
gradient all-reduce and weight gathers are its collectives), so
``compress_grads`` composes as in the reference. Rank 0 writes the
checkpoints and every rank restores its shards; ``fit`` returns the full
params on every rank.

On the card two things make a step nondeterministic: the embedding
gather's backward (an accumulating scatter) and some of cuDNN's
weight-gradient algorithms. A run that must equal another bit for bit,
such as a resume check, runs under ``torch.use_deterministic_algorithms
(True)`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the first
cuBLAS call; the engine sets neither.

Metrics match the paper: relative RMSE ("5-7% range") and %-exact for
register pressure (Fig. 6: ~75% exact).

``target`` may be a single name (legacy scalar head) or a sequence of
names, which trains one shared encoder with a per-target head dict under
a joint MSE (mean of per-target MSEs in normalized space). Multi-target
results carry per-target ``norm_stats`` and ``evaluate`` reports metrics
per target.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import params as P
from repro_torch.core import models as CM
from repro_torch.core.service import pad_slack
from repro_torch.data import pipeline as PIPE
from repro_torch.ir import dataset as DS
from repro_torch.kernels import _build as KB
from repro_torch.obs import trace as OBS
from repro_torch.optim import adamw, compress
from repro_torch.runtime import fault
from repro_torch.runtime import sharding as SH

TargetSpec = Union[str, Sequence[str]]


@dataclass
class TrainResult:
    params: Any
    stats: Dict[str, float]
    history: list = field(default_factory=list)
    # single-target: {"mu": ..., "sigma": ...}; multi-target: {target: {...}}
    norm_stats: Dict[str, Any] = field(default_factory=dict)
    heads: Optional[Tuple[str, ...]] = None


def make_loss_fn(apply_fn, heads: Optional[Tuple[str, ...]] = None):
    """MSE loss. With ``heads``, ``y`` is (B, n_heads) column-per-target
    and the loss is the mean of per-target MSEs (joint training)."""
    def loss_fn(params, ids, y):
        pred = apply_fn(params, ids)
        if heads:
            per = [torch.mean(torch.square(pred[t] - y[:, i]))
                   for i, t in enumerate(heads)]
            return torch.mean(torch.stack(per))
        return torch.mean(torch.square(pred - y))
    return loss_fn


def value_and_grad(loss_fn, params, ids, y):
    """(loss, grads tree) of ``loss_fn`` at ``params``; neither carries
    an autograd graph."""
    return _grads(params, *_loss_and_leaves(loss_fn, params, ids, y))


def _loss_and_leaves(loss_fn, params, ids, y):
    """The forward half of :func:`value_and_grad`: the loss, with its
    graph, and the leaves it was taken at."""
    flat = [p.detach().requires_grad_(True) for p in P.tree_flatten(params)]
    return loss_fn(P.tree_unflatten(params, flat), ids, y), flat


def _grads(params, loss, flat):
    """The backward half of :func:`value_and_grad`."""
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), P.tree_unflatten(params, grads)


def _copy_into(dst, src) -> None:
    """``d.copy_(s)`` for each pair, as one ``_foreach_copy_`` a dtype:
    a list of one dtype takes the fused multi-tensor route, where a
    mixed one (the float32 leaves with AdamW's int32 count) copies each
    pair on its own."""
    groups: Dict[torch.dtype, Tuple[list, list]] = {}
    for d, s in zip(dst, src):
        group = groups.setdefault(d.dtype, ([], []))
        group[0].append(d)
        group[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def make_sgd_step(apply_fn, opt_cfg, grad_transform=None,
                  heads: Optional[Tuple[str, ...]] = None):
    """Single-step builder for custom/external loops (notebooks, tests).

    The TrainEngine composes the same pieces itself because its step also
    threads the compression error state; this stays the minimal public
    building block."""
    loss_fn = make_loss_fn(apply_fn, heads)

    def step(params, opt_state, ids, y):
        loss, grads = value_and_grad(loss_fn, params, ids, y)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with torch.no_grad():
            params, opt_state, _ = adamw.apply_updates(params, grads,
                                                       opt_state, opt_cfg)
        return params, opt_state, loss
    return step


@dataclass(frozen=True)
class EngineConfig:
    """Every knob of the unified step loop."""
    steps: int = 300
    batch_size: int = 64
    lr: float = 1e-3
    weight_decay: float = 0.01
    seed: int = 0
    log_every: int = 100
    verbose: bool = False
    # batching: per-bucket pad widths. "batch_max" keeps the global
    # shuffle and is gradient-identical to max_seq padding;
    # "homogeneous" maximizes the step-time win but length-correlates
    # batch composition (see data/pipeline.py).
    bucketed: bool = True
    bucket_mode: str = "batch_max"
    min_bucket: int = 32
    drop_remainder: bool = True
    # mesh / sharding: a product above 1 runs in a process group of that
    # many ranks
    mesh_data: int = 1
    mesh_model: int = 1
    # substrate
    compress_grads: bool = False
    ckpt_dir: Optional[str] = None     # None -> loop without persistence
    save_every: int = 100
    keep: int = 3
    check_treedef: bool = True
    install_sigterm: bool = False   # checkpoint + stop on SIGTERM
    shard_index: int = 0
    num_shards: int = 1
    prefetch: int = 2
    # torch device for params and steps; None means "cuda"
    device: Optional[str] = None


@dataclass
class _Shape:
    """One batch shape's device buffers, its eager steps so far and,
    once captured, its graph with the kernel launches it counts."""
    ids: torch.Tensor
    y: torch.Tensor
    eager: int = 0
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Dict[object, int] = field(default_factory=dict)


class _StepGraphs:
    """A training step on one card, captured as one CUDA graph per batch
    shape and replayed.

    ``run_step(ids, y, ctx)`` runs one step from device buffers, writes
    its results into tensors made before any capture (the engine's state
    and a loss) and returns that loss tensor; ``ctx`` is the step's trace
    context for its phase spans, None inside a capture. :meth:`inputs`
    copies a batch into its shape's own ``ids`` and ``y`` buffers (a
    blocking copy from the loader's pageable arrays: where the host
    waits for the card). The first ``WARMUP`` steps of a shape run
    ``run_step`` eagerly, as real steps, on the side stream a capture
    then uses, so cuDNN's, cuBLAS's and the allocator's lazy start-up
    happen outside the graph; the next step of that shape captures it
    (span ``trainer.capture``, the price of a new shape) and replays
    it, as does every later one. The graphs share one memory pool: they
    never run at once. A capture runs nothing on the card, so the kernel
    launches it counts (``kernels._build.launch_counts``) are taken back
    and added again at each replay: a kernel's ``launches`` stays the
    number of times it ran.

    ``WARMUP`` is at least the number of steps the benchmark's training
    check records (``bench/drivers/train.py``'s ``_Recorder(3)``, which
    wraps ``adamw.apply_updates`` and the loss function and clones what
    they return): a clone made inside a capture would be a buffer of
    the graph's pool, empty until a replay writes it and overwritten by
    every later one, so the check would read no step it could trust."""

    WARMUP = 3      # torch.cuda.make_graphed_callables' default

    def __init__(self, run_step: Callable, device: torch.device, tracer):
        self.run_step = run_step
        self.device = device
        self.tracer = tracer
        self.side = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.shapes: Dict[Tuple[int, ...], _Shape] = {}
        self.loss: Optional[torch.Tensor] = None

    def inputs(self, ids: torch.Tensor, y: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device buffers of ``ids``' batch shape, holding the host
        tensors ``ids`` and ``y``."""
        shape = self.shapes.get(tuple(ids.shape))
        if shape is None:
            shape = self.shapes[tuple(ids.shape)] = _Shape(*(
                torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for t in (ids, y)))
        shape.ids.copy_(ids)
        shape.y.copy_(y)
        return shape.ids, shape.y

    def step(self, ids: torch.Tensor, y: torch.Tensor, ctx
             ) -> Tuple[torch.Tensor, bool]:
        """One training step on the buffers :meth:`inputs` gave: (the
        loss tensor, whether a graph ran it)."""
        shape = self.shapes[tuple(ids.shape)]
        if shape.graph is None and shape.eager < self.WARMUP:
            shape.eager += 1
            main = torch.cuda.current_stream(self.device)
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side):
                loss = self.run_step(ids, y, ctx)
            main.wait_stream(self.side)
            return loss, False
        tr = self.tracer
        if shape.graph is None:
            with tr.span("trainer.capture", ctx):
                before = KB.launch_counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.side):
                    self.loss = self.run_step(ids, y, None)
                shape.launches = KB.moved_since(before)
                for counted, n in shape.launches.items():
                    KB.count(counted, -n)
                shape.graph = graph
        with tr.span("trainer.replay", ctx):
            shape.graph.replay()
        for counted, n in shape.launches.items():
            KB.count(counted, n)
        return self.loss, True

    def drop(self) -> None:
        """Release every graph and the pool's hold on their memory."""
        for shape in self.shapes.values():
            if shape.graph is not None:
                shape.graph.reset()
        self.shapes.clear()
        self.pool = None


class TrainEngine:
    """The one way to train a cost model (see module docstring).

    >>> engine = TrainEngine("conv1d", cfg, ("latency_us",), steps=500)
    >>> result = engine.fit(train_ds)

    ``init_fn(cfg, heads=None, *, generator)`` makes the initial params
    (on the CPU; :meth:`fit` moves them to the device); replace it to
    start from given params.

    Each :meth:`fit` records one trace into ``tracer`` (default
    :func:`repro_torch.obs.trace.default_tracer`): a root ``trainer.fit``
    whose children are ``trainer.prepare`` (from the call to the first
    step) and a ``trainer.step`` (tags ``step``, counted from 1 as
    ``on_step`` counts, and ``profiled``, whether a torch profiler
    recorded it; and ``graphed``, whether a CUDA graph ran it) for each
    sampled step. An eager step has five children: ``trainer.batch``
    (the wait on the loader), ``trainer.copy_in`` (the batch's copies to
    the device, which wait for the card from pageable memory),
    ``trainer.forward``, ``trainer.backward`` and ``trainer.optimizer``.
    A graphed step has ``trainer.batch``, ``trainer.copy_in``, then
    ``trainer.capture`` if it captures its shape's graph, and
    ``trainer.replay`` (the graph's launch). The run's first step is
    always sampled, a later one when ``tracer.sample()`` hits or while a
    torch profiler records (:func:`repro_torch.obs.trace.profiling`)."""

    def __init__(self, kind: str, cfg, target: TargetSpec,
                 engine: Optional[EngineConfig] = None, *,
                 tracer: Optional[OBS.Tracer] = None, **overrides):
        self.kind = kind
        self.cfg = cfg
        self.heads = None if isinstance(target, str) else tuple(target)
        self.target = target
        self.ecfg = dataclasses.replace(engine or EngineConfig(),
                                        **overrides)
        n_mesh = self.ecfg.mesh_data * self.ecfg.mesh_model
        if n_mesh > 1:
            world = dist.get_world_size() if dist.is_initialized() else None
            if world != n_mesh:
                raise ValueError(
                    f"a {self.ecfg.mesh_data} x {self.ecfg.mesh_model} mesh "
                    f"has {n_mesh} places; TrainEngine runs it inside a "
                    f"process group of {n_mesh} ranks, and the group here "
                    f"has {world if world else 'no'} ranks "
                    f"(launch.train --mesh-data/--mesh-model spawns them)")
        self.device = torch.device(self.ecfg.device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TrainEngine(device={self.ecfg.device!r}) needs a CUDA "
                f"card and torch.cuda.is_available() is False; pass "
                f"device='cpu' to train on the CPU")
        if n_mesh > 1 and self.device.type == "cuda" and \
                self.device.index is None:
            self.device = torch.device(
                "cuda", dist.get_rank() % torch.cuda.device_count())
        self.init_fn, self.apply_fn = CM.get_model(kind)
        self.axes_fn = CM.get_axes(kind)
        self.tracer = tracer or OBS.default_tracer()

    # ------------------------------------------------------------- pipeline
    def bucket_assignments(self, train: DS.CostDataset
                           ) -> Optional[np.ndarray]:
        """Per-row train bucket length, honoring the serving-side pad-slack
        rule (conv1d needs slack so bucketing is prediction-preserving)."""
        if not self.ecfg.bucketed:
            return None
        # ladder from the DATASET width (the unbucketed path feeds ids at
        # dataset width too)
        buckets = DS.default_buckets(train.max_seq, self.ecfg.min_bucket)
        return DS.bucket_lengths(train.get_seq_lens(), buckets,
                                 pad_slack(self.kind, self.cfg))

    def make_loader(self, train: DS.CostDataset, y: np.ndarray
                    ) -> PIPE.Loader:
        e = self.ecfg
        if train.ids is not None:
            src = PIPE.ArraySource(ids=train.ids, y=y)
        else:
            # bucket-grouped storage: materialize rows on demand at the
            # widest width a batch could need; the Loader trims per bucket
            width = max(train.bucket_ids) if e.bucketed else train.max_seq
            src = PIPE.FnSource(train.n, lambda idx: {
                "ids": train.row_ids(idx, width), "y": y[idx]})
        return PIPE.Loader(src, e.batch_size, seed=e.seed,
                           shard_index=e.shard_index,
                           num_shards=e.num_shards,
                           drop_remainder=e.drop_remainder,
                           prefetch=e.prefetch,
                           bucket_by=self.bucket_assignments(train),
                           bucket_mode=e.bucket_mode)

    # ------------------------------------------------------------------ fit
    def fit(self, train: DS.CostDataset, *,
            on_step: Optional[Callable] = None) -> TrainResult:
        tr = self.tracer
        with tr.span("trainer.fit", tr.sample(force=True)) as root:
            return self._fit(train, on_step, root.ctx)

    def _fit(self, train, on_step, fit_ctx) -> TrainResult:
        e = self.ecfg
        tr = self.tracer
        prepare = tr.start("trainer.prepare", fit_ctx)
        dev = self.device
        gen = torch.Generator().manual_seed(e.seed)
        if self.heads:
            params = self.init_fn(self.cfg, heads=self.heads, generator=gen)
            y, norm_stats = DS.stacked_normalized_targets(train.targets,
                                                          self.heads)
        else:
            params = self.init_fn(self.cfg, generator=gen)
            y, norm_stats = DS.normalize_targets(train.targets[self.target])
            y = y.astype(np.float32)
        params = P.from_numpy(params, dev)
        loader = self.make_loader(train, y)
        rules = self.mesh_rules()
        graphed = dev.type == "cuda" and rules is None
        if graphed:
            # the graphed step updates its state in place: the params
            # must be the engine's own, not the caller's tensors
            params = P.tree_map(torch.clone, params)

        opt_cfg = adamw.AdamWConfig(lr=e.lr, total_steps=e.steps,
                                    warmup_steps=min(50, e.steps // 10),
                                    weight_decay=e.weight_decay)
        err0 = compress.init_error_state(params) if e.compress_grads \
            else None
        loss_fn = make_loss_fn(self.apply_fn, self.heads)

        def train_step(state, ids, yy, ctx):
            params, opt_state, err = state
            forward = tr.start("trainer.forward", ctx)
            batch = SH.place_batch(rules, {"ids": ids, "y": yy})
            with SH.step_scope(rules):
                loss, flat = _loss_and_leaves(loss_fn, params, batch["ids"],
                                              batch["y"])
                tr.end(forward)
                with tr.span("trainer.backward", ctx):
                    loss, grads = _grads(params, loss, flat)
                    if rules is not None:
                        grads = P.tree_unflatten(grads, SH.like(
                            P.tree_flatten(grads), P.tree_flatten(params)))
                        loss = loss.full_tensor()
                with tr.span("trainer.optimizer", ctx), torch.no_grad():
                    if err is not None:
                        grads, err = compress.compress_grads(grads, err)
                    params, opt_state, _ = adamw.apply_updates(
                        params, grads, opt_state, opt_cfg)
            return (params, opt_state, err), loss

        sup = fault.TrainSupervisor(e.ckpt_dir, save_every=e.save_every,
                                    keep=e.keep)
        if e.install_sigterm:
            sup.install_signal_handler()
        state = (params, adamw.init_state(params), err0)
        shardings = None
        if rules is not None:
            shardings = SH.tree_shardings(
                rules, self.state_axes(e.compress_grads), state)
            state = SH.place_tree(state, shardings)
        state, start, extra = sup.try_restore(
            state, shardings=shardings, check_treedef=e.check_treedef)
        if start and "loader" in extra:
            loader.state = PIPE.LoaderState(**extra["loader"])

        it = iter(loader)
        history = []
        last = [torch.tensor(float("nan"))]
        graphs = None
        if graphed:
            # the state the supervisor restored (or made) is the one the
            # graphs read and write, for the whole fit
            fixed_state = state
            fixed = P.tree_flatten(state) + [
                torch.zeros((), dtype=torch.float32, device=dev)]

            def step_in_place(ids, yy, ctx):
                new, loss = train_step(fixed_state, ids, yy, ctx)
                with torch.no_grad():
                    _copy_into(fixed, P.tree_flatten(new) + [loss])
                return fixed[-1]
            graphs = _StepGraphs(step_in_place, dev, tr)

        def step_fn(state, step):
            profiled = OBS.profiling()
            sampled = tr.sample(force=step == start or profiled)
            with tr.span("trainer.step",
                         fit_ctx if sampled is not None else None,
                         {"step": step + 1, "profiled": profiled}) as sp:
                ctx = sp.ctx if sp is not None else None
                with tr.span("trainer.batch", ctx):
                    batch = next(it)
                with tr.span("trainer.copy_in", ctx):
                    ids = torch.from_numpy(batch["ids"])
                    yy = torch.from_numpy(batch["y"])
                    ids, yy = (ids.to(dev), yy.to(dev)) if graphs is None \
                        else graphs.inputs(ids, yy)
                if graphs is None:
                    state, loss = train_step(state, ids, yy, ctx)
                    replayed = False
                else:
                    loss, replayed = graphs.step(ids, yy, ctx)
                if sp is not None:
                    sp.tags["graphed"] = replayed
            last[0] = loss     # device value; sync only at log points
            return state

        def _on_step(step, dt):
            if step % e.log_every == 0 or step == e.steps:
                history.append((step, float(last[0])))
                if e.verbose:
                    print(f"  step {step}: mse={float(last[0]):.4f} "
                          f"({dt * 1e3:.0f} ms)")
            if on_step is not None:
                on_step(step, dt)

        heads_extra = list(self.heads) if self.heads else [self.target]
        tr.end(prepare)
        t0 = time.perf_counter()
        try:
            state = sup.run(
                state, step_fn, e.steps, start_step=start,
                extra_fn=lambda: {"loader": loader.state.as_dict(),
                                  "norm_stats": norm_stats,
                                  "heads": heads_extra},
                on_step=_on_step)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            if graphs is not None:
                graphs.drop()
        wall = time.perf_counter() - t0
        steps_run = max(e.steps - start, 0)
        # a resume that finds the run already complete executes 0 steps:
        # final_loss is then NaN (nothing ran) and steps_per_s 0 by design
        stats = {"final_loss": float(last[0]),
                 "steps": float(steps_run),
                 "wall_time_s": wall,
                 "steps_per_s": steps_run / max(wall, 1e-9)}
        params = state[0]
        if rules is not None:
            params = P.tree_map(lambda x: x.full_tensor(), params)
        return TrainResult(params=params, stats=stats, history=history,
                           norm_stats=norm_stats, heads=self.heads)

    # ----------------------------------------------------------------- mesh
    def mesh_rules(self) -> Optional[SH.ShardingRules]:
        """The ``(data, model)`` mesh's rules when ``mesh_data *
        mesh_model > 1`` (the batch split over ``data`` only), else
        None."""
        e = self.ecfg
        if e.mesh_data * e.mesh_model == 1:
            return None
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(e.mesh_data, e.mesh_model)
        return SH.ShardingRules(mesh, overrides={"batch": ("data",)})

    def state_axes(self, compressed: bool):
        """Logical axes of the train state ``(params, opt_state, err)``."""
        axes = self.axes_fn(self.cfg, heads=self.heads) if self.heads \
            else self.axes_fn(self.cfg)
        return (axes, {"m": axes, "v": axes, "count": ()},
                axes if compressed else None)


def train_model(kind: str, cfg, train: DS.CostDataset, target: TargetSpec,
                *, steps: int = 300, batch_size: int = 64,
                lr: float = 1e-3, seed: int = 0, log_every: int = 100,
                verbose: bool = False, **engine_overrides) -> TrainResult:
    """Compatibility wrapper: a TrainEngine with in-memory defaults."""
    return TrainEngine(kind, cfg, target, steps=steps,
                       batch_size=batch_size, lr=lr, seed=seed,
                       log_every=log_every, verbose=verbose,
                       **engine_overrides).fit(train)


def _target_metrics(pred_n: np.ndarray, true: np.ndarray,
                    stats: Dict[str, float]) -> Dict[str, float]:
    """Paper metrics: relative RMSE (%), normalized RMSE, %-exact (rounded)."""
    pred = DS.denormalize(pred_n, stats)
    rel = (pred - true) / np.maximum(np.abs(true), 1e-6)
    # normalized-space RMSE against the train normalization
    true_n = (np.log1p(true) - stats["mu"]) / stats["sigma"]
    return {
        "rmse_rel_pct": float(np.sqrt(np.mean(np.square(rel))) * 100),
        "mape_pct": float(np.mean(np.abs(rel)) * 100),
        "rmse_norm": float(np.sqrt(np.mean(np.square(pred_n - true_n)))),
        "exact_pct": float(np.mean(np.round(pred) == np.round(true)) * 100),
        "within5_pct": float(np.mean(np.abs(rel) <= 0.05) * 100),
    }


def evaluate(kind: str, cfg, result: TrainResult, test: DS.CostDataset,
             target: Optional[TargetSpec] = None, batch_size: int = 256
             ) -> Dict[str, Any]:
    """Evaluate a TrainResult on the device its params are on.

    Single-head result + target name -> flat metrics dict (legacy).
    Multi-head result -> {target: metrics} for every requested target
    (default: all heads); passing a single name returns that head's flat
    metrics dict.
    """
    _, apply_fn = CM.get_model(kind)
    dev = P.tree_flatten(result.params)[0].device
    test_ids = test.dense_ids()
    preds = []
    with torch.inference_mode():
        for i in range(0, len(test_ids), batch_size):
            ids = torch.from_numpy(test_ids[i:i + batch_size]).to(dev)
            out = apply_fn(result.params, ids)
            preds.append(P.to_numpy(out))
    if result.heads:
        pred_n = {t: np.concatenate([p[t] for p in preds])
                  for t in result.heads}
        if isinstance(target, str):
            return _target_metrics(pred_n[target], test.targets[target],
                                   result.norm_stats[target])
        wanted = tuple(target) if target is not None else result.heads
        return {t: _target_metrics(pred_n[t], test.targets[t],
                                   result.norm_stats[t])
                for t in wanted}
    if not isinstance(target, str):
        raise ValueError("single-head evaluate needs a target name")
    pred_n = np.concatenate(preds)
    return _target_metrics(pred_n, test.targets[target], result.norm_stats)
