#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    PYTHONPATH=src python3 chip_smoke.py     # (src/ is also added here)

Phases, each printing JSON lines:

1. ``device``  — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints them (that raw line is printed too).
2. ``build``   — builds the four CUDA kernel libraries from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, all started
   together; K1 and K3 share ``conv_tile.cuh``) and reports each one's
   seconds and ptxas register and spill lines.
3. ``kernels`` — holds the fused conv forward kernel (K1) against its
   plain PyTorch version on the card (TF32 off), with ragged ids and one
   all-PAD row, both head layouts: COSTMODEL_BASE widths at S in {32,
   256}, B in {1, 5, 64}; tile edges (S=200, not a multiple of the
   tile, and COSTMODEL_OPERAND's (16,16,8,8,2,1) filter mix at S=1024,
   B in {1, 5}: 12 tiles a row with a halo of 45); bf16 params; and
   bit-identical rows for every batch size of the service's ladder up to
   its max_batch of 256, along which the tile changes. Params are drawn
   from a seed with every bias nonzero and the embedding scaled so the
   limit is tight, and the phase checks that the plain version with any
   group of biases zeroed, or with a pool that drops the last tile's
   positions, misses the limit by 10x, so the parity checks can fail.
   The ladder check moves each row one position in its batch, so B=1
   holds a real row. The serve and optimize CLIs' own widths (vocab
   4096, S in {64, 128, 160}: the buckets of their max_seq 160, whose
   last tile is short), and the ingest CLI's (``ingest_f32``: vocab
   2048, embedding 32, 3 layers of fs=2 and 32 channels, FC 64, at its
   buckets S in {32, 64, 128, 192}); each case prints the tile plan it
   ran. Times the kernel and the plain version in turns with CUDA
   events at B in {64, 4, 1} (``ms``, as since K1 was ported), beside
   them the card's time alone and the host's (``device_ms``,
   ``host_ms``), prints each B's tile plan and the kernel's ptxas
   registers and spills, and reports how far a TF32 plain version
   lands.
4. ``serve``   — the Conv1D main path: ``build_dataset`` (300 graphs),
   random COSTMODEL_BASE multi-head params from a seed, a
   ``CostModelService(use_kernel=True)`` on the card behind a
   ``CostModelServer``, 256 requests from 8 client threads (half of them
   repeats). Checks that the kernel ran once for every batch the server
   flushed after warm-up, that rows are finite, equal a direct plain
   forward of the same ids and a direct ``predict_all`` bit for bit, and
   that the LRU answered; reports the service's forward time a batch.
5. ``kernels_lstm`` — the LSTM recurrence kernel (K2) against its plain
   version through both entries (``lstm_scan_fused`` on gates and a
   mask, ``lstm_scan_ids`` on the projection table and ids, which must
   agree bit for bit): the reference's test shapes; H in {8, 16, 33, 64,
   65, 119, 120, 128} (both plans, odd H, a warp of idle lanes) at B in
   {0, 1, 5, 64, 256}, with
   stacked heads; COSTMODEL_BASE (H=128) through its projection at S in
   {32, 256}, B in {1, 5, 64}; f32 and bf16, ragged masks, one all-PAD
   row that must come out exactly 0; an id outside the table reads as
   PAD; plain versions with the forget-gate +1 dropped, the gate bias
   zeroed, the mask ignored or each block's units blind to the peer's
   half of h must miss by more than 10x the limit; bf16 vs f32 params
   keep each head's ranking; rows bit-identical across the ladder (up
   to 256) for both entries and for ``lstm_forward_apply``. Times the
   ids entry beside its plain version (``ms``, as K2 has been timed
   since it was ported), the two entries beside each other, and the
   served forward beside cuDNN's LSTM (``torch.nn.LSTM`` on packed
   prefix sequences, the yardstick ``library_ms``).
6. ``serve_lstm`` — the LSTM main path: the serve phase's dataset,
   requests and checks with ``CostModelService("lstm", use_kernel=True)``;
   every served batch is one launch of the ids entry, and the xw entry
   never runs.
7. ``tower``   — the tower kernel (K3, masked max-pool) against
   ``conv1d_stack_ref(mask)``, and ``conv_tower_apply(use_kernel=True)``
   against the plain tower path: COSTMODEL_BASE and COSTMODEL_OPERAND
   widths, the tile edges of the kernels phase, the reference tests'
   filter mixes, f32 and bf16, all-masked rows, the ladder up to 256; an
   unmasked pool, or one without the last tile's positions, must miss by
   more than 10x the limit. Timed as K1 at B in {64, 1}. Its launches
   are counted over one ``conv_tower_apply`` run.
8. ``kernels_embed`` — the conv1d lookup's backward kernel (E1,
   ``embed_grad``) against its plain version in float64 at
   base-train-b512's shapes (B=512, S in {32, 64, 128, 256}, vocab
   8,192, E=64), float32 and bf16, ragged rows of 14-94 real tokens,
   the same with one id in 90% of them, and 95% PAD: within the
   kernel's longest chain of adds x 2^-23 x each id's sum of |rows|
   (a bf16 result one rounding more), which the plain version without
   one chunk of the most frequent id must miss by 10x; PAD's row and
   absent ids zero; two launches the same bits. Times the op (sort and
   two launches, ``ms``) and the two launches alone in turns with the
   plain version, ``aten.embedding_dense_backward`` (``library_ms``) and
   autograd's ``index_put_`` that it replaced, at S in {64, 128}, and
   the op's and the library's card time alone and host time
   (``device_ms``, ``host_ms``); the bound is the real rows, the ids and
   the table over the memory rate, its share of the op's card time
   ``roofline_pct``.
9. ``train``   — ``TrainEngine`` on the card, COSTMODEL_BASE multi-head,
   the serve phases' dataset (split 0.1), B=64, bucketed. With the TF32
   switches at torch's defaults for that step only: a default
   (``use_kernel=False``) card service within 2e-4 of a CPU service, and
   one loss's gradients within TRAIN_GRAD_RTOL of the CPU's, which the
   plain conv without its precision guard (TF32) must miss. Then 200
   steps under deterministic algorithms with checkpoints every 50; a
   second run killed at step 120 and resumed from step 100 must land on
   its params (rtol 1e-6, atol 1e-7), E1 launched once a step of the
   first run (``embed_grad_launches``: a replay of a step's CUDA graph
   adds the launches its capture counted); the last loss below half the
   first; ``evaluate`` finite for every head; 10 steps at
   ``base-train-b512``'s shapes (B=512, the ``batch_max`` loader over
   the training rows repeated to 2,048 or more), graphed, against an
   eager loop of ``make_sgd_step`` over the same batches under
   deterministic algorithms: params, both moments, the count and every
   loss bit for bit, with at least one step a graph's replay
   (``graphed_vs_eager``); the first 10 losses within
   TRAIN_LOSS_RTOL of the same engine on the CPU (stopped at step 10 by
   the supervisor's SIGTERM preemption). The trained params are served
   through K1 (conv1d) and, after 20 LSTM steps, K2: rows within 2e-4
   of the plain card forward, one launch a batch. Reports ms a step for
   both (conv1d after 50 steps of warm-up).
10. ``compiler`` — the compiler's path at COSTMODEL_BASE: trains conv1d
   on the rewrite-augmented corpus (``build_dataset(600,
   rewrite_factor=1, seed=9)``, split 0.1; 250 steps of 128, lr 2e-3:
   the reference's opt-test settings), then serves the trained params
   through K1 (``CostModelService(use_kernel=True)``, directly and
   behind a ``CostModelServer``) beside a plain CPU service. Front door:
   the printer's MLIR of 64 graphs outside the corpus and the affine
   example through ``predict_text`` of the service (every text a
   ``TextPrediction``, K1 launched once for each forward batch the
   service ran; LRU hits launch nothing) and of the server from 8
   threads (bit for bit the service's); card rows within 2e-4 of the
   CPU's and predictions within 1e-3 relative; 200 fuzzed texts with
   no error at the ``predict`` stage and not all degraded; a stopped
   server answers ``IngestError("predict")``. Advisors (fusion,
   unroll, recompile) through a server, within 1e-3 of the CPU
   service's. Closed loop: ``evaluate_search`` over 20 graphs of all
   samplers (beam 3, 4 steps, 128 candidates) meets the reference's
   oracle bar, and K1's launches over the whole phase equal the
   forward batches. Reports ms a training step, host us a text for
   ingest and encode, ``predict_text`` p50/p99, the search's seconds,
   calls and launches a graph, how many best graphs the CPU service
   also picks, and the card's busy share over one profiled search.
11. ``replicated`` — the replicated serving tier on the card, the serve
   phases' params and vocabulary. A ``ServiceSpec`` of a K1 service
   (``use_kernel=True``) spawns 4 replicas (``start_replicas``, the
   kernel library built in this process first); 512 requests (half
   repeats) from 8 threads on 3 ``ReplicaClient`` objects: rows bit for
   bit a direct K1 ``predict_all``, every replica's stats name the card,
   report no ``nvcc`` run and K1 launches equal to its forward batches
   (read from the children before and after), at least 3 replicas
   serve; with the replica LRUs cleared a client without its own LRU
   is answered from the shared cache with no forward; 32 traced
   requests assemble complete span trees across processes. A
   ``FleetDriver`` of 4 search workers over 16 graphs of all samplers
   (beam 3, 4 steps, 128 candidates): every pass's best graph and cost
   equal ``search_pool`` over the direct K1 service, no worker
   initialises CUDA; steady candidates/s beside the reference bench's
   thread fleet on a K1 server. 2 LSTM replicas through K2's ids
   entry: rows bit for bit a direct K2 service's, launches equal to
   forward batches, no launch of the xw entry. The reference bench's
   chaos plan (corrupt, kill, wedge, drop, delay, dup, unwedge) through
   a ``FaultyTransport`` on 2 K1 replicas under a
   ``ReplicaSupervisor``, held to the reference gate's checks
   (availability >= 0.99, no non-degraded round off the fault-free one,
   kill and wedge applied, the plan exhausted, >= 2 recoveries within
   120 s, a clean final round, the counters in the ``MetricsRegistry``
   snapshot), and the respawned children ran no ``nvcc``. Reports the
   card's free memory before and after each tier starts, start and
   respawn seconds, and the phase's seconds.

12. ``families`` — the FC (bag-of-tokens) and transformer families at
   COSTMODEL_BASE widths (embedding 64, FC 256/64; 2 blocks of 4 heads
   of 16), params from a seed with every bias, the position table and
   the LayerNorm gains drawn. With torch's default precision switches:
   the plain card forward within 2e-4 of the CPU's at S in {32, 256}, B
   in {1, 5, 64}, ragged ids with an all-PAD row that must be finite,
   both head layouts; bf16 params against f32 keep each head's ranking
   (Spearman >= 0.99). A plain card ``CostModelService`` behind a
   ``CostModelServer`` for each family, 256 requests from 8 threads:
   rows within 2e-4 of a direct plain forward and within 1e-5 of a
   service padding every row to max_seq. ``TrainEngine`` on the card,
   100 steps at B=64: the loss below half its first value, the first
   10 losses within TRAIN_LOSS_RTOL of the CPU's. Reports the forward
   ms at B=64, S=256 (f32 beside bf16) and ms a training step.
13. ``cli`` — the port's CLIs on the card, each called as
   ``main(argv)`` in this process with its output captured.
   ``launch.train --preset base --target all`` for each of the four
   ``--model``s, 30 steps into a temporary ``--ckpt-dir``: a second call
   reports the run complete, and ``--eval-only --device cpu`` on the
   same directory gives metrics within 1e-3 relative of the card's.
   ``launch.serve --kernel`` (256 requests, the LRU, the advisors) and
   ``launch.optimize --kernel`` (8 graphs): K1's launches over each call
   equal the warm-up shapes and forward batches of its card services,
   and every row a call's service served through K1 (its LRU), with a
   ragged batch of each bucket, is within 2e-4 of a plain card service
   on the same params, vocabulary and stats.
   ``launch.serve --kernel --replicas 2 --supervise --obs`` (every
   request traced): both replicas on the card with no ``nvcc`` run and
   K1 launches equal to their warm-up shapes and forward batches, then
   ``launch.obs report`` on its JSONL exits 0 with every trace
   complete.
14. ``ingest`` — the port's StableHLO lowering and the ingest CLI on
   the card. ``ir.stablehlo.lower_arch_corpus`` over all ten
   architectures, timed: 43 texts, each parsed by the front door into
   a graph with ops. ``launch.ingest --arch all --fuzz 200 --kernel``
   called as ``main(argv)``: 43 predictions, ``unk_rate`` 0 on every
   one, no uncaught exception over the 200 fuzzed texts, K1's launches
   equal to its card service's warm-up shapes and forward batches, and
   every row that service served (with a ragged batch of each bucket)
   within 2e-4 of a plain card service on the same params. The card
   against the CPU, within 1e-3 relative for every arch text: the same
   call with ``--train-steps 0`` with ``--kernel`` and with ``--device
   cpu`` (the plain path; both at the seeded untrained params), and the
   card-trained service rebuilt on the CPU's plain path (two trainings
   are two models: AdamW amplifies the devices' rounding). Reports the lowering's seconds, texts a
   second through ``predict_text`` (a fresh K1 service, cold LRU), K1's
   launches and the phase's seconds.
15. ``lm`` — the LLM substrate (``repro_torch.models``) on the card,
   plain PyTorch: no kernel lies on this path, and the phase line says
   so. qwen3-0.6b at its published widths (28 layers, d_model 1024, 16
   query and 8 KV heads of 128, vocab 151,936), params from the port's
   ``init_params`` with a seeded generator (float32 master weights,
   bf16 compute): 10 training steps at B=8, S=512 on
   ``synthetic_lm_batches(seed=0)`` with remat and AdamW (lr 1e-3, 5
   warm-up steps): every loss and grad norm finite, the last loss below
   the first; ms a step, tokens a second and the peak of
   ``torch.cuda.max_memory_allocated``. Then a prefill of 2 x 512 and,
   through ``make_decode_step`` on a bf16 KV cache of 1024, the prompt
   fed token by token and 32 greedy tokens (prefill ms, ms a prompt
   token, ms a decoded token). At float32, the decode path's logits at
   every prompt position within LM_REL of the prefill's, and its greedy
   tokens equal to the prefill's argmax wherever the prefill's top-2 gap
   exceeds twice the two paths' largest difference (closer: a tie,
   counted). A forward of 2 x 64 at float32 under torch's default
   switches within LM_REL of the CPU's, and the same forward with TF32
   matmuls, which must miss that limit or the line says the limit
   cannot tell them apart. The attention's route timed at the training
   shape beside the one not taken (bf16 products rounded to bf16). All
   ten architectures, reduced, with params through
   ``params.lm_from_numpy``: the float32 forward within LM_REL of the
   CPU's, a finite bf16 forward, one train step and 8 decode steps.
   Profiles one training step and 8 decode steps (the card's time and
   busy share, launches, the top kernels) and records what shares the
   host at the phase's start (threads, child processes, a fixed Python
   loop's seconds): the step and decode are host-bound.

16. ``mesh`` — the mesh tooling. (a) qwen3-0.6b at its published widths
   on a one-rank NCCL mesh (``launch.mesh.make_single_device_mesh``):
   params and optimizer state placed as DTensors by the reference's
   rules, one train step at B=8, S=512 through ``make_train_step(rules=
   ...)`` against the ``rules=None`` step on the same params and batch
   (loss and params within MESH_REL, bit-identical reported), ms a step
   both ways, then 8 greedy decode steps on a bf16 cache of 1024 with
   and without rules (tokens equal, caches within MESH_REL). (b) conv1d
   at COSTMODEL_BASE with int8 gradient compression on 2 spawned gloo
   ranks of the CPU (NCCL takes one rank a card and this machine has
   one card, so these ranks are CPU ranks by design), mesh (2, 1), 50
   steps, against one CPU rank: the first 10 losses within
   TRAIN_LOSS_RTOL; the 2-rank params then served through K1 on the
   card, its launches equal to the service's warm-up shapes and forward
   batches, and every row it served (with a ragged batch of each
   bucket) within 2e-4 of a plain card service. (c) ``python -m
   repro_torch.launch.dryrun`` for qwen3-0.6b at ``train_4k`` and
   ``decode_32k`` on a fake 16x16 group, in a child process each:
   status ok, the model flops as ``model_flops_for``, the train flops
   ratio within MESH_DRYRUN_RATIO, the argument and temporary bytes a
   rank within the card's memory (a tensor left whole on every rank
   would not fit); the three roofline terms (H100 data-sheet
   constants), the bottleneck, the memory a rank and the seconds.

Then one ``{"kernels": [...]}`` line (K1's and K2's ``launches`` add
the replicated phase's, counted in the replicas, and K1's the cli,
ingest and mesh phases', under ``launches_by_path``; E1's are the train
phase's first 200-step run's), and the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0 and no result line is printed; so does a machine without
a CUDA card, or a directory without the repository's ``src/``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

TOL = 2e-4              # float32 parity: accumulation order differs
# the LSTM kernel at the reference's own test shapes: the reference
# holds its kernel to 1e-5 there (tests/test_kernels.py)
TOL_LSTM_SMALL = 1e-5
# a bf16 output is the f32 result rounded to nearest: within 2^-8
# relative of it, so 2^-7 of the f32 plain result, plus float32's own
# accumulation-order noise
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5
SPEARMAN_MIN = 0.99     # bf16 params vs float32 params
# train phase, card against CPU, both float32 summing in other orders
# (cuDNN and cuBLAS against oneDNN). One loss's gradients as a relative
# L2 distance over all leaves, on the dataset's rows (measured on the
# card: 5.1e-7 in IEEE float32, 6.0e-4 with TF32 convolutions). Where a
# ReLU input lies within rounding of 0 its gate opens on one side only,
# whatever the precision: a batch of random tokens did that (the card's
# float32 1.5e-3 from its own float64), which this check cannot tell
# from TF32. The first 10 training losses, relative: AdamW's first steps
# move each component by about lr whatever its size, so a component
# whose gradient is rounding noise steps either way (measured: 1.4e-7 at
# step 2 growing to 9.5e-5 at step 9).
TRAIN_GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-3
# conv_init's 0.02-scale embedding leaves COSTMODEL_BASE's outputs small;
# x100 brings them to a few tenths, where 2e-4 is tight enough that a
# TF32 plain version misses it (the sensitivity line reports by how much)
EMB_SCALE = 100.0
# lstm_init's embedding x50 gives input gates of about unit size
LSTM_EMB_SCALE = 50.0
# the service's batch ladder up to its max_batch; K1's and K3's tile
# changes with B along it
LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 128, 256)
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12            # HBM3
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/conv_forward.cu"
TPU_KERNEL = "src/repro/kernels/conv1d_stack.py:171"
LSTM_SOURCE = "src/repro_torch/kernels/csrc/lstm_scan.cu"
LSTM_TPU_KERNEL = "src/repro/kernels/lstm_scan.py:62"
TOWER_SOURCE = "src/repro_torch/kernels/csrc/conv_tower.cu"
TOWER_TPU_KERNEL = "src/repro/kernels/conv1d_stack.py:98"
EMBED_SOURCE = "src/repro_torch/kernels/csrc/embed_grad.cu"
# base-train-b512's lookup: B=512 rows in a bucket of the ladder, the
# 8,192-id vocabulary, E=64; rows of 14-94 real tokens, as `ops`
EG_B, EG_V, EG_E, EG_LENS = 512, 8192, 64, (14, 94)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def ragged_ids(rng, B: int, S: int, vocab: int):
    """Random ids with ragged valid lengths and row 0 all PAD."""
    import numpy as np
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    ids[0] = 0
    return ids.astype(np.int32)


def seeded_params(cfg, heads, seed: int):
    """COSTMODEL-shaped params from a seed: conv_init's shapes and
    scales, the embedding scaled by EMB_SCALE so the 2e-4 limit is
    tight, and every bias drawn N(0, 0.1) where
    conv_init leaves it 0, so a kernel that drops a bias, or pads a
    layer's input with relu(bias), misses the limit."""
    import torch
    from repro_torch import params as P
    g = torch.Generator().manual_seed(seed)
    p = P.conv_init(cfg, heads, generator=g)
    p["emb"] = p["emb"] * EMB_SCALE
    for lyr in [*p["convs"], *p["fc"], *p.get("heads", {}).values()]:
        lyr["b"] = torch.randn(lyr["b"].shape, generator=g) * 0.1
    return p


def seeded_lstm_params(cfg, heads, seed: int):
    """lstm_init's shapes and scales from a seed, the embedding scaled by
    LSTM_EMB_SCALE, and the gate bias and the head biases drawn
    N(0, 0.1) where lstm_init leaves them 0."""
    import torch
    from repro_torch import params as P
    g = torch.Generator().manual_seed(seed)
    p = P.lstm_init(cfg, heads, generator=g)
    p["emb"] = p["emb"] * LSTM_EMB_SCALE
    p["b"] = torch.randn(p["b"].shape, generator=g) * 0.1
    for lyr in [*p.get("heads", {}).values(), *([p["head"]] if "head" in p
                                                else [])]:
        lyr["b"] = torch.randn(lyr["b"].shape, generator=g) * 0.1
    return p


def mixed_ids(rng, B: int, S: int, vocab: int):
    """ragged_ids, except that a single row is a real one (a batch of
    one all-PAD row checks nothing)."""
    return ragged_ids(rng, B, S, vocab) if B > 1 else \
        long_ids(rng, 1, S, vocab)


def long_ids(rng, B: int, S: int, vocab: int):
    """Ids whose valid prefixes fill more than half of S, as the rows of
    the service's S bucket do; no all-PAD row."""
    import numpy as np
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(S // 2 + 1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    return ids.astype(np.int32)


def spearman(a, b) -> float:
    import numpy as np

    def ranks(x):
        r = np.empty(len(x))
        r[np.argsort(x, kind="stable")] = np.arange(len(x))
        return r
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def pool_cut_ref(ids, args, keep: int):
    """The plain fused forward with a fault: its max-pool sees only the
    first ``keep`` positions, as a kernel that lost the last tile's
    partial would."""
    import torch
    from repro_torch.kernels import ref as REF
    emb, conv_ws, conv_bs, fc_ws, fc_bs, head_w, head_b = args
    h = emb[ids] * (ids != 0)[..., None].to(emb.dtype)
    for w, b in zip(conv_ws, conv_bs):
        h = torch.relu(REF.conv1d_same(h, w, b))
    h = h[:, :keep].amax(dim=1)
    for w, b in zip(fc_ws, fc_bs):
        h = torch.relu(h @ w + b)
    return h @ head_w + head_b


def bound_ms(ids, args) -> tuple:
    """Least time the card could take for one fused forward on ``ids``:
    the larger of operations over the float32 peak and bytes over the
    memory rate. Bytes: ids, the embedding rows these ids gather, every
    other param and the output, each once."""
    import torch
    emb, conv_ws, conv_bs, fc_ws, fc_bs, head_w, head_b = args
    B, S = ids.shape
    flops = sum(2 * S * w.shape[0] * w.shape[1] * w.shape[2]
                for w in conv_ws)
    flops += sum(2 * w.shape[0] * w.shape[1] for w in [*fc_ws, head_w])
    flops *= B
    n_rows = int(torch.unique(ids[ids != 0]).numel())
    others = sum(t.numel() * t.element_size() for t in
                 [*conv_ws, *conv_bs, *fc_ws, *fc_bs, head_w, head_b])
    nbytes = ids.numel() * 4 + n_rows * emb.shape[1] * emb.element_size() \
        + others + B * head_w.shape[1] * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def time_pair(fa, fb, n_samples: int = 21, reps: int = 10) -> tuple:
    """Median ms per call of fa and fb, timed in turns with CUDA events
    (each sample is ``reps`` back-to-back calls)."""
    import numpy as np
    import torch

    def sample(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for _ in range(3):                              # warm-up
        fa(), fb()
    ta, tb = [], []
    for i in range(n_samples):
        for fn, acc in ((fa, ta), (fb, tb)) if i % 2 == 0 else \
                ((fb, tb), (fa, ta)):
            acc.append(sample(fn))
    return float(np.median(ta)), float(np.median(tb))


def phase_device() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return {"name": name, "nvidia_smi": smi}


def ptxas_usage(lib: str) -> dict:
    """Registers and spill bytes of each kernel entry in ``lib``'s build,
    from nvcc's ptxas report, keyed "f32" / "bf16" (entries with another
    template argument keep their mangled name)."""
    import re
    from repro_torch.kernels import _build
    usage, name = {}, None
    for ln in _build.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            name = "f32" if "IfE" in name else \
                "bf16" if "bfloat16" in name else name
            usage.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def phase_build() -> None:
    from repro_torch.kernels import _build, conv1d_stack, embed_grad, \
        lstm_scan
    libs = [conv1d_stack.LIB, lstm_scan.LIB, conv1d_stack.TOWER_LIB,
            embed_grad.LIB]
    secs = _build.build_all(libs)
    ptxas = {lib: [ln.strip() for ln in _build.build_log(lib).splitlines()
                   if "registers" in ln or "spill" in ln] for lib in libs}
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas,
          "usage": {lib: ptxas_usage(lib) for lib in
                    (conv1d_stack.LIB, conv1d_stack.TOWER_LIB)}})


def phase_kernels() -> dict:
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import (COSTMODEL_BASE,
                                               COSTMODEL_OPERAND,
                                               CostModelConfig)
    from repro_torch.core.models import DEFAULT_HEADS
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels.conv_tile_probe import time_queued

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = 0.0
    # launch.serve's and launch.optimize's conv1d
    CLI_CFG = CostModelConfig(name="cli", vocab_size=4096, max_seq=160,
                              embed_dim=64, conv_channels=(64,) * 6,
                              fc_dims=(256, 64))
    # launch.ingest's: embedding 32, 3 layers of fs=2 and 32 channels
    # (conv_channels zips the six default filters down to three), FC 64
    INGEST_CFG = CostModelConfig(name="ingest", vocab_size=2048,
                                 max_seq=192, embed_dim=32,
                                 conv_channels=(32,) * 3, fc_dims=(64,))

    def params_for(cfg, heads, dtype=None):
        return P.from_numpy(seeded_params(cfg, heads, 1), dev, dtype)

    def base_plan(B, S):
        cfg = COSTMODEL_BASE
        return K.plan(B, S, cfg.embed_dim, cfg.conv_filters,
                      cfg.conv_channels, cfg.fc_dims)

    def compare(cfg, heads, S, B, dtype=None, label=""):
        nonlocal max_err
        p = params_for(cfg, heads, dtype)
        args, _ = ops.fused_args(p)
        ids = torch.from_numpy(ragged_ids(rng, B, S, cfg.vocab_size)).to(dev)
        got = K.conv_forward_fused(ids, *args)
        want = REF.conv_forward_fused_ref(ids, *args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.isfinite(got).all().item(), f"{label} finite")
        check(err <= TOL, f"{label} {cfg.name} S={S} B={B} err {err}")
        max_err = max(max_err, err)
        return {"case": label, "config": cfg.name, "heads": len(heads or
                (0,)), "S": S, "B": B, "max_abs_err": err,
                "plan": K.plan(B, S, args[0].shape[1],
                               [w.shape[0] for w in args[1]],
                               [w.shape[2] for w in args[1]],
                               [w.shape[1] for w in args[3]])}

    cases = []
    for heads in (DEFAULT_HEADS, None):
        for S in (32, 256):
            for B in (1, 5, 64):
                cases.append(compare(COSTMODEL_BASE, heads, S, B,
                                     label="base_f32"))
        # tile edges: S=200 is not a multiple of the tile (16 positions
        # at B <= 16), and the operand mix alone in its batch (12 tiles of
        # 90 positions with a halo of 45)
        for B in (1, 5, 64):
            cases.append(compare(COSTMODEL_BASE, heads, 200, B,
                                 label="base_f32_ragged_tiles"))
        for B in (1, 5):
            cases.append(compare(COSTMODEL_OPERAND, heads, 1024, B,
                                 label="operand_f32"))
        # the serve and optimize CLIs' config: its buckets below 256,
        # S=160's last tile holding 4 positions at B <= 16
        for S in (64, 128, 160):
            for B in (1, 5, 64):
                cases.append(compare(CLI_CFG, heads, S, B,
                                     label="cli_f32"))
        # the ingest CLI's config at each of its buckets; 192 is no
        # power of two, so its last tile is short
        for S in (32, 64, 128, 192):
            for B in (1, 5, 64):
                cases.append(compare(INGEST_CFG, heads, S, B,
                                     label="ingest_f32"))
        cases.append(compare(COSTMODEL_BASE, heads, 256, 64,
                             torch.bfloat16, label="base_bf16"))
        cases.append(compare(COSTMODEL_OPERAND, heads, 1024, 5,
                             torch.bfloat16, label="operand_bf16"))
    for c in cases:
        emit({"phase": "kernels", **c})

    # the limit can fail: zeroing any group of biases in the plain
    # version moves it far outside 2e-4 of the kernel
    ids = torch.from_numpy(ragged_ids(rng, 64, 256, 8192)).to(dev)
    args, _ = ops.fused_args(params_for(COSTMODEL_BASE, DEFAULT_HEADS))
    got = K.conv_forward_fused(ids, *args)
    miss = {}
    for name, idx in (("conv", (2,)), ("fc", (4,)), ("head", (6,))):
        cut = list(args)
        for i in idx:
            cut[i] = [torch.zeros_like(b) for b in cut[i]] \
                if isinstance(cut[i], list) else torch.zeros_like(cut[i])
        miss[name] = float((REF.conv_forward_fused_ref(ids, *cut)
                            - got).abs().max())
        check(miss[name] > 10 * TOL, f"zeroed {name} biases only miss by "
              f"{miss[name]}: the parity limit cannot catch it")
    # TF32 in the plain version, against the kernel
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = float((REF.conv_forward_fused_ref(ids, *args) - got).abs().max())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # ... and so does a plain version whose pool drops the last tile's
    # positions, on rows with no PAD (each position may hold a max)
    full_ids = torch.from_numpy(rng.integers(1, 8192, (64, 256))
                                .astype(np.int32)).to(dev)
    plan = base_plan(64, 256)
    keep = (plan["n_tiles"] - 1) * plan["tile"]
    miss["last_tile_dropped"] = float((pool_cut_ref(full_ids, args, keep)
                                       - K.conv_forward_fused(full_ids, *args))
                                      .abs().max())
    check(miss["last_tile_dropped"] > 10 * TOL, f"a pool without the last "
          f"tile misses by only {miss['last_tile_dropped']}")
    emit({"phase": "kernels", "case": "sensitivity",
          "zeroed_biases_err": miss, "tf32_plain_err": tf32,
          "positions_kept": keep, "out_abs_max": float(got.abs().max())})

    # bf16 params keep the f32 ranking of rows, per head
    ids = torch.from_numpy(ragged_ids(rng, 64, 256, 8192)).to(dev)
    a32, _ = ops.fused_args(params_for(COSTMODEL_BASE, DEFAULT_HEADS))
    a16, _ = ops.fused_args(params_for(COSTMODEL_BASE, DEFAULT_HEADS,
                                   torch.bfloat16))
    o32 = K.conv_forward_fused(ids, *a32).cpu().numpy()
    o16 = K.conv_forward_fused(ids, *a16).cpu().numpy()
    rho = [spearman(o32[1:, i], o16[1:, i]) for i in range(o32.shape[1])]
    check(min(rho) >= SPEARMAN_MIN, f"bf16 Spearman {rho}")
    emit({"phase": "kernels", "case": "bf16_spearman", "spearman": rho})

    # each row is bit-identical for every batch size of the ladder, at
    # another position in its batch (row 0 of the full batch is all PAD,
    # so B=1 holds a real row)
    for S in (32, 256):
        ids = torch.from_numpy(ragged_ids(rng, LADDER[-1] + 1, S,
                                          8192)).to(dev)
        full = K.conv_forward_fused(ids, *a32)
        same = all(torch.equal(K.conv_forward_fused(
            ids[1:b + 1].contiguous(), *a32), full[1:b + 1])
            for b in LADDER)
        tiles = {b: base_plan(b, S)["tile"] for b in LADDER}
        check(same, f"rows bit-identical across the batch ladder, S={S}")
        emit({"phase": "kernels", "case": "bit_identity", "S": S,
              "ladder": list(LADDER), "tile": tiles, "identical": same})

    # times at the main path's widths, kernel and plain version in turns
    timings = {}
    usage = ptxas_usage(K.LIB)
    for B in (64, 4, 1):
        ids = torch.from_numpy(ragged_ids(rng, B, 256, 8192)).to(dev)
        with torch.inference_mode():
            k_ms, p_ms = time_pair(lambda: K._launch(ids, *a32),
                                   lambda: REF.conv_forward_fused_ref(
                                       ids, *a32))
            # the wrapper as the service calls it (ids checked on the
            # host) and with its device id check, which waits for the card
            w_ms, wc_ms = time_pair(
                lambda: K.conv_forward_fused(ids, *a32, check_ids=False),
                lambda: K.conv_forward_fused(ids, *a32))
            # beside them: the card's time alone, and the host's
            q_ms, h_ms = time_queued(lambda: K._launch(ids, *a32))
        b_ms, by, flops, nbytes = bound_ms(ids, a32)
        timings[B] = {"B": B, "S": 256, "ms": k_ms, "plain_ms": p_ms,
                      "device_ms": q_ms, "host_ms": h_ms,
                      "wrapper_ms": w_ms, "checked_wrapper_ms": wc_ms,
                      "bound_ms": b_ms, "bound_by": by,
                      "flops": flops, "bytes": nbytes,
                      "plan": base_plan(B, 256),
                      "ptxas": usage.get("f32")}
        emit({"phase": "kernels", "case": "timing", **timings[B]})
    return {"max_abs_err": max_err, "timings": timings}


def lstm_bound_ms(ids, table, wh, n_heads: int) -> tuple:
    """Least time the card could take for one recurrence of the ids
    entry on these inputs: operations of the valid steps only (a PAD step
    does no work) and the heads; bytes of the ids, the table rows these
    ids need, wh, the heads and the output, each once."""
    import torch
    valid = ids[(ids > 0) & (ids < table.shape[0])]
    H = wh.shape[0]
    flops = float(valid.numel()) * 2 * H * 4 * H + ids.shape[0] * 2 * H * \
        n_heads
    nbytes = ids.numel() * 4 + int(torch.unique(valid).numel()) * 4 * H * \
        table.element_size() + wh.numel() * wh.element_size() + \
        (H + 1) * n_heads * wh.element_size() + ids.shape[0] * n_heads * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def scan_inputs(rng, B: int, S: int, H: int, V: int, dtype, dev):
    """A (V, 4H) gate table, ids with ragged valid lengths (row 0 all PAD
    when B > 1), the gates and mask they give the xw entry, and wh (the
    reference test's 0.3 scale for H <= 16, else 1/sqrt(H))."""
    import numpy as np
    import torch
    table = torch.tensor(rng.normal(size=(V, 4 * H)) * 0.5, dtype=dtype,
                         device=dev)
    ids = torch.from_numpy(mixed_ids(rng, B, S, V) if B else
                           np.zeros((0, S), np.int32)).to(dev)
    scale = 0.3 if H <= 16 else H ** -0.5
    wh = torch.tensor(rng.normal(size=(H, 4 * H)) * scale, dtype=dtype,
                      device=dev)
    return table, ids, table[ids].contiguous(), (ids != 0).float(), wh


def phase_kernels_lstm() -> dict:
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import models as CM
    from repro_torch.kernels import lstm_scan as K2
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    cfg = COSTMODEL_BASE
    heads = CM.DEFAULT_HEADS
    max_err = 0.0

    def params_for(dtype=None, hs=heads):
        return P.from_numpy(seeded_lstm_params(cfg, hs, 1), dev, dtype)

    def project(p, ids):
        return p["emb"][ids] @ p["wx"] + p["b"], (ids != 0).float()

    def compare(xw, mask, wh, limit, label, **info):
        nonlocal max_err
        got = K2.lstm_scan_fused(xw, mask, wh)
        want = REF.lstm_scan_ref(xw, mask, wh)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.isfinite(got).all().item(), f"{label} finite")
        check(err <= limit, f"{label} {info} err {err} > {limit}")
        pad = mask.sum(1) == 0
        check(bool(pad.any()) == (xw.shape[0] > 1) and
              bool((got[pad] == 0).all()),
              f"{label} {info}: the all-PAD row is exactly 0")
        max_err = max(max_err, err)
        emit({"phase": "kernels_lstm", "case": label, **info,
              "max_abs_err": err, "limit": limit})

    def compare_entries(table, ids, xw, mask, wh, limit, label, **info):
        """Both entries against their plain versions, bit for bit against
        each other, with the stacked heads too; the all-PAD row 0."""
        nonlocal max_err
        B, H = ids.shape[0], wh.shape[0]
        hw = torch.tensor(rng.normal(size=(H, 3)) * H ** -0.5,
                          dtype=wh.dtype, device=dev)
        hb = torch.tensor(rng.normal(size=(3,)) * 0.1, dtype=wh.dtype,
                          device=dev)
        n_ids, n_xw = K2.lstm_scan_ids.launches, K2.lstm_scan_fused.launches
        got = K2.lstm_scan_ids(table, ids, wh)
        got_xw = K2.lstm_scan_fused(xw, mask, wh)
        pred = K2.lstm_scan_ids(table, ids, wh, hw, hb)
        pred_xw = K2.lstm_scan_fused(xw, mask, wh, hw, hb)
        want = REF.lstm_scan_ids_ref(table, ids, wh)
        want_pred = REF.lstm_scan_ids_ref(table, ids, wh, hw, hb)
        torch.cuda.synchronize()
        check(got.shape == (B, H) and pred.shape == (B, 3),
              f"{label} {info} shapes")
        check(K2.lstm_scan_ids.launches - n_ids == 2 * (B > 0) and
              K2.lstm_scan_fused.launches - n_xw == 2 * (B > 0),
              f"{label} {info}: one launch a call, none at B=0")
        err = float((got - want).abs().max()) if B else 0.0
        err_pred = float((pred - want_pred).abs().max()) if B else 0.0
        check(bool(torch.isfinite(got).all()), f"{label} {info} finite")
        check(max(err, err_pred) <= limit,
              f"{label} {info} err {err} / heads {err_pred} > {limit}")
        check(torch.equal(got, got_xw) and torch.equal(pred, pred_xw),
              f"{label} {info}: the two entries differ")
        if B > 1:
            check(not got[0].any(), f"{label} {info}: all-PAD row not 0")
        max_err = max(max_err, err, err_pred)
        return {"case": label, **info, "max_abs_err": err,
                "heads_max_abs_err": err_pred, "limit": limit,
                "entries_identical": True}

    # the reference's test shapes and inputs: random masks, row 0 masked
    # (but for B=1)
    for B, S, H in ((1, 16, 8), (5, 32, 16), (8, 64, 16)):
        xw = rng.normal(size=(B, S, 4 * H)) * 0.5
        m = (rng.random((B, S)) < 0.8).astype(np.float32)
        if B > 1:
            m[0] = 0
        wh = rng.normal(size=(H, 4 * H)) * 0.3
        mask = torch.from_numpy(m).to(dev)
        for dt, limit in ((torch.float32, TOL_LSTM_SMALL),
                          (torch.bfloat16, TOL)):
            compare(torch.tensor(xw, dtype=dt, device=dev), mask,
                    torch.tensor(wh, dtype=dt, device=dev), limit,
                    "reference_shape", B=B, S=S, H=H, dtype=str(dt))
            # the ids entry on the same mask: a table row for each valid
            # step, PAD elsewhere
            V = 97
            table = torch.tensor(rng.normal(size=(V, 4 * H)) * 0.5,
                                 dtype=dt, device=dev)
            ids = torch.from_numpy((rng.integers(1, V, (B, S)) * m)
                                   .astype(np.int32)).to(dev)
            emit({"phase": "kernels_lstm", **compare_entries(
                table, ids, table[ids].contiguous(), (ids != 0).float(),
                torch.tensor(wh, dtype=dt, device=dev), limit,
                "reference_shape_entries", B=B, S=S, H=H, dtype=str(dt))})
    # the two plans and both sides of each edge (odd H, the one-block
    # limit 64, the earlier kernel's shared-memory limit 119/120,
    # kMaxHidden; at H=65 block 1 has a whole warp of idle lanes), every
    # batch size from none to the service's max_batch (several waves)
    plans = {}
    for H in (8, 16, 33, 64, 65, 119, 120, 128):
        plans[H] = K2.plan(H)
        for B in (0, 1, 5, 64, 256):
            for dt in (torch.float32, torch.bfloat16):
                limit = TOL_LSTM_SMALL if H <= 16 and \
                    dt == torch.float32 else TOL
                args = scan_inputs(rng, B, 48, H, 300, dt, dev)
                emit({"phase": "kernels_lstm", **compare_entries(
                    *args, limit, "grid", B=B, S=48, H=H, dtype=str(dt))})
    emit({"phase": "kernels_lstm", "case": "plans", "plans": plans})
    check(plans[128]["ctas"] == 2 and plans[64]["ctas"] == 1,
          f"plans {plans}")
    # COSTMODEL_BASE through its projection: ragged prefix masks
    for dt in (torch.float32, torch.bfloat16):
        p = params_for(dt)
        for S in (32, 256):
            for B in (1, 5, 64):
                ids = torch.from_numpy(mixed_ids(rng, B, S,
                                                 cfg.vocab_size)).to(dev)
                xw, mask = project(p, ids)
                compare(xw, mask, p["wh"], TOL, "base", B=B, S=S,
                        H=cfg.lstm_hidden, dtype=str(dt))
    # the slice as a whole, both head layouts: lstm_forward_apply (the ids
    # entry) against the plain model
    for hs in (heads, None):
        p = params_for(hs=hs)
        ids = torch.from_numpy(ragged_ids(rng, 64, 256,
                                          cfg.vocab_size)).to(dev)
        got = ops.lstm_forward_apply(p, ids)
        want = CM.lstm_apply(p, ids)
        got, want = ((torch.stack([d[t] for t in hs], 1) if hs else d)
                     for d in (got, want))
        err = float((got - want).abs().max())
        check(err <= TOL, f"lstm_forward_apply heads={hs} err {err}")
        max_err = max(max_err, err)
        emit({"phase": "kernels_lstm", "case": "forward_vs_lstm_apply",
              "heads": len(hs or (0,)), "max_abs_err": err,
              "out_abs_max": float(got.abs().max())})

    # an id outside the table reads as PAD: never read, its step skipped
    p32 = params_for()
    H = cfg.lstm_hidden
    table = ops.lstm_xw_table(p32)
    ids = torch.from_numpy(long_ids(rng, 4, 64, cfg.vocab_size)).to(dev)
    bad = ids.clone()
    for r, (pos, v) in enumerate(((0, -1), (5, cfg.vocab_size),
                                  (63, 1 << 30), (17, -(1 << 30)))):
        bad[r, pos] = v
    pad = torch.where((bad >= 0) & (bad < cfg.vocab_size), bad,
                      torch.zeros_like(bad))
    same = torch.equal(K2.lstm_scan_ids(table, bad, p32["wh"]),
                       K2.lstm_scan_ids(table, pad, p32["wh"]))
    check(same, "an out-of-range id reads as PAD")
    check(not torch.equal(pad, ids), "the out-of-range ids replaced ids")
    emit({"phase": "kernels_lstm", "case": "out_of_range_id_as_pad",
          "identical": same})

    # the limit can fail: the plain version without the forget-gate +1,
    # with the gate bias zeroed, ignoring the mask, or with each block's
    # units blind to the other block's half of h misses the kernel
    ids = torch.from_numpy(ragged_ids(rng, 64, 256, cfg.vocab_size)).to(dev)
    xw, mask = project(p32, ids)
    got = K2.lstm_scan_fused(xw, mask, p32["wh"])
    forget = torch.zeros(4 * H, device=dev)
    forget[H:2 * H] = 1.0
    units = plans[H]["units"]
    block = torch.arange(H, device=dev) // units       # block of a unit
    own = block[:, None] == block.repeat(4)[None, :]   # (k, gate column)
    miss = {name: float((REF.lstm_scan_ref(a, m, w) - got).abs().max())
            for name, a, m, w in (
                ("forget_bias_dropped", xw - forget, mask, p32["wh"]),
                ("gate_bias_zeroed", xw - p32["b"], mask, p32["wh"]),
                ("mask_ignored", xw, torch.ones_like(mask), p32["wh"]),
                ("peer_half_of_h_zeroed", xw, mask, p32["wh"] * own))}
    for name, e in miss.items():
        check(e > 10 * TOL, f"plain version with {name} misses by only "
              f"{e}: the parity limit cannot catch it")
    emit({"phase": "kernels_lstm", "case": "sensitivity", "miss": miss,
          "h_abs_max": float(got.abs().max())})

    # bf16 params keep the f32 ranking of rows, per head
    def forward(p, ids):
        out = ops.lstm_forward_apply(p, ids)
        return torch.stack([out[t] for t in heads], 1)
    p16 = params_for(torch.bfloat16)
    o32 = forward(p32, ids).cpu().numpy()
    o16 = forward(p16, ids).cpu().numpy()
    rho = [spearman(o32[1:, i], o16[1:, i]) for i in range(o32.shape[1])]
    check(min(rho) >= SPEARMAN_MIN, f"LSTM bf16 Spearman {rho}")
    emit({"phase": "kernels_lstm", "case": "bf16_spearman", "spearman": rho,
          "out_abs_max": float(np.abs(o32).max())})

    # each row is bit-identical for every batch size of the ladder, at
    # another position in its batch: both entries alone, and the forward
    # with its table and heads (row 0 of the full batch is all PAD)
    ladder = {}
    for S in (32, 256):
        ids = torch.from_numpy(ragged_ids(rng, LADDER[-1] + 1, S,
                                          cfg.vocab_size)).to(dev)
        xw, mask = project(p32, ids)
        full = K2.lstm_scan_fused(xw, mask, p32["wh"])
        ladder[f"kernel_S{S}"] = all(torch.equal(K2.lstm_scan_fused(
            xw[1:b + 1].contiguous(), mask[1:b + 1].contiguous(),
            p32["wh"]), full[1:b + 1]) for b in LADDER)
        full = K2.lstm_scan_ids(table, ids, p32["wh"])
        ladder[f"ids_kernel_S{S}"] = all(torch.equal(K2.lstm_scan_ids(
            table, ids[1:b + 1].contiguous(), p32["wh"]), full[1:b + 1])
            for b in LADDER)
        for name, p in (("f32", p32), ("bf16", p16)):
            full = forward(p, ids)
            ladder[f"forward_{name}_S{S}"] = all(torch.equal(
                forward(p, ids[1:b + 1].contiguous()), full[1:b + 1])
                for b in LADDER)
    emit({"phase": "kernels_lstm", "case": "bit_identity",
          "ladder": list(LADDER), "identical": ladder})
    for name, same in ladder.items():
        check(same, f"LSTM rows bit-identical across the ladder: {name}")

    # times at the main path's widths, each pair in turns: the ids entry
    # (the main path's launch) and its plain version, 7 samples of 3
    # launches (``ms`` and ``plain_ms``: K2's yardstick since it was
    # ported); the two entries, 21 samples of 10; the served forward
    # (ops.lstm_forward_apply on the service's precomputed table and
    # heads) and cuDNN's LSTM on packed prefix sequences from embedded x
    # (the yardstick; the port never calls it), 21 samples of 10
    # (ids from a generator of their own, so that a check added above
    # does not change what is timed)
    timings = {}
    served = ops.lstm_serving_params(p32)
    head_w, head_b, _ = served["stacked_heads"]
    timing_rng = np.random.default_rng(20)
    for B in (64, 1):
        ids = torch.from_numpy(long_ids(timing_rng, B, 256,
                                        cfg.vocab_size)).to(dev)
        xw, mask = project(p32, ids)
        wh = p32["wh"]
        lstm = torch.nn.LSTM(cfg.embed_dim, H, batch_first=True).to(dev)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(p32["wx"].T)
            lstm.weight_hh_l0.copy_(wh.T)
            lstm.bias_ih_l0.copy_(p32["b"] + forget)
            lstm.bias_hh_l0.zero_()
        lstm.flatten_parameters()
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            p32["emb"][ids], mask.sum(1).long().cpu(), batch_first=True,
            enforce_sorted=False)
        with torch.inference_mode():
            k_ms, p_ms = time_pair(
                lambda: K2._launch_ids(table, ids, wh, head_w, head_b),
                lambda: REF.lstm_scan_ids_ref(table, ids, wh, head_w,
                                              head_b),
                n_samples=7, reps=3)
            ids_ms, xw_ms = time_pair(
                lambda: K2._launch_ids(table, ids, wh, head_w, head_b),
                lambda: K2._launch(xw, mask, wh, head_w, head_b))
            f_ms, lib_ms = time_pair(
                lambda: ops.lstm_forward_apply(served, ids, check_ids=False),
                lambda: lstm(packed))
            lib_h = lstm(packed)[1][0][0]
            lib_err = float((lib_h - K2._launch_ids(table, ids, wh))
                            .abs().max())
        check(lib_err <= TOL, f"cuDNN LSTM yardstick computes another "
              f"function: err {lib_err}")
        b_ms, by, flops, nbytes = lstm_bound_ms(ids, table, wh,
                                                head_w.shape[1])
        longest = int(mask.sum(1).max())
        timings[B] = {"B": B, "S": 256, "H": H, "ms": k_ms, "plain_ms": p_ms,
                      "ms_per_step": k_ms / longest, "longest_row": longest,
                      "entries_ms": {"ids": ids_ms, "xw": xw_ms},
                      "forward_ms": f_ms, "library_ms": lib_ms,
                      "library_max_abs_err": lib_err, "bound_ms": b_ms,
                      "bound_by": by, "flops": flops, "bytes": nbytes}
        emit({"phase": "kernels_lstm", "case": "timing", **timings[B]})
    return {"max_abs_err": max_err, "timings": timings, "plan": plans[H]}


def phase_tower() -> dict:
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import (COSTMODEL_BASE,
                                               COSTMODEL_OPERAND)
    from repro_torch.core.models import DEFAULT_HEADS
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels.conv_tile_probe import time_queued

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    max_err = 0.0

    def embedded(cfg, B, S, dtype, ids=None, heads=DEFAULT_HEADS):
        p = P.from_numpy(seeded_params(cfg, heads, 1), dev, dtype)
        if ids is None:
            ids = torch.from_numpy(mixed_ids(rng, B, S,
                                             cfg.vocab_size)).to(dev)
        mask = (ids != 0).float()
        x = p["emb"][ids] * mask[..., None].to(p["emb"].dtype)
        return (x, [lyr["w"] for lyr in p["convs"]],
                [lyr["b"] for lyr in p["convs"]], mask), p, ids

    def plan_of(B, S, x, ws):
        return K.tower_plan(B, S, x.shape[2], [w.shape[0] for w in ws],
                            [w.shape[2] for w in ws])

    def compare(args, label, **info):
        nonlocal max_err
        x, ws, bs, mask = args
        got = K.conv1d_stack_fused(x, ws, bs, mask)
        want = REF.conv1d_stack_ref(x.float(), [w.float() for w in ws],
                                    [b.float() for b in bs], mask)
        torch.cuda.synchronize()
        check(got.dtype == x.dtype, f"{label} output dtype {got.dtype}")
        err = float((got.float() - want).abs().max())
        if x.dtype == torch.float32:
            check(err <= TOL, f"{label} {info} err {err}")
            max_err = max(max_err, err)
        else:
            bad = (got.float() - want).abs() > BF16_REL * want.abs() + \
                BF16_ABS
            check(not bool(bad.any()), f"{label} {info}: bf16 output "
                  f"beyond 2^-7 of the f32 plain result (err {err})")
        pad = mask.sum(1) == 0
        check(bool(pad.any()) == (x.shape[0] > 1) and
              bool((got[pad] == 0).all()),
              f"{label} {info}: the all-masked row pools to 0")
        emit({"phase": "tower", "case": label, **info, "max_abs_err": err,
              "out_abs_max": float(want.abs().max())})

    for dt in (torch.float32, torch.bfloat16):
        for S in (32, 256):
            for B in (1, 5, 64):
                compare(embedded(COSTMODEL_BASE, B, S, dt)[0], "base", B=B,
                        S=S, dtype=str(dt))
        # tile edges, as in the kernels phase: S=200 is not a multiple of
        # the tile, and the operand mix alone in its batch
        for B in (1, 5):
            compare(embedded(COSTMODEL_BASE, B, 200, dt)[0],
                    "base_ragged_tiles", B=B, S=200, dtype=str(dt))
            compare(embedded(COSTMODEL_OPERAND, B, 1024, dt)[0], "operand",
                    B=B, S=1024, dtype=str(dt))
        # the reference tests' filter mixes on random x: every position
        # nonzero, pads included, so only the mask keeps them out
        for fs_list in ((2, 2, 2), (16, 16, 8, 8, 2, 1), (3, 5), (1,)):
            C = 16

            def seeded(*shape, scale=1.0):
                return torch.tensor(rng.normal(size=shape) * scale,
                                    dtype=dt, device=dev)
            x = seeded(5, 64, C)
            mask = torch.from_numpy(
                (rng.random((5, 64)) < 0.85).astype(np.float32)).to(dev)
            mask[:, 0] = 1.0
            mask[0] = 0.0
            ws = [seeded(fs, C, C, scale=0.2) for fs in fs_list]
            bs = [seeded(C, scale=0.1) for _ in fs_list]
            compare((x, ws, bs, mask), "filters", filters=list(fs_list),
                    dtype=str(dt))

    # the path as a whole, both head layouts, and a pool that ignored the
    # mask would miss
    for heads in (DEFAULT_HEADS, None):
        args, p, ids = embedded(COSTMODEL_BASE, 64, 256, None, heads=heads)
        got = ops.conv_tower_apply(p, ids)
        want = ops.conv_tower_apply(p, ids, use_kernel=False)
        got, want = ((torch.stack([d[t] for t in heads], 1) if heads
                      else d) for d in (got, want))
        err = float((got - want).abs().max())
        check(err <= TOL, f"conv_tower_apply heads={heads} err {err}")
        max_err = max(max_err, err)
        emit({"phase": "tower", "case": "conv_tower_apply",
              "heads": len(heads or (0,)), "max_abs_err": err,
              "out_abs_max": float(want.abs().max())})
    x, ws, bs, mask = args
    unmasked = float((REF.conv1d_stack_ref(x, ws, bs) -
                      K.conv1d_stack_fused(x, ws, bs, mask)).abs().max())
    check(unmasked > 10 * TOL, f"an unmasked pool misses by only "
          f"{unmasked}: the masked-pool check cannot fail")
    # a pool that lost the last tile's partial would miss too
    plan = plan_of(64, 256, x, ws)
    keep = (plan["n_tiles"] - 1) * plan["tile"]
    cut = mask.clone()
    cut[:, keep:] = 0
    dropped = float((REF.conv1d_stack_ref(x, ws, bs, cut) -
                     K.conv1d_stack_fused(x, ws, bs, mask)).abs().max())
    check(dropped > 10 * TOL, f"a pool without the last tile misses by "
          f"only {dropped}")
    emit({"phase": "tower", "case": "sensitivity",
          "unmasked_pool_err": unmasked, "last_tile_dropped_err": dropped,
          "positions_kept": keep})

    # each row is bit-identical for every batch size of the ladder, at
    # another position in its batch (row 0 of the full batch is all PAD)
    for S in (32, 256):
        x, ws, bs, mask = embedded(COSTMODEL_BASE, LADDER[-1] + 1, S,
                                   None)[0]
        full = K.conv1d_stack_fused(x, ws, bs, mask)
        same = all(torch.equal(K.conv1d_stack_fused(
            x[1:b + 1].contiguous(), ws, bs, mask[1:b + 1].contiguous()),
            full[1:b + 1]) for b in LADDER)
        tiles = {b: plan_of(b, S, x, ws)["tile"] for b in LADDER}
        check(same, f"tower rows bit-identical across the ladder, S={S}")
        emit({"phase": "tower", "case": "bit_identity", "S": S,
              "ladder": list(LADDER), "tile": tiles, "identical": same})

    # times at the main shape, kernel and plain version in turns
    timings = {}
    usage = ptxas_usage(K.TOWER_LIB)
    for B in (64, 1):
        ids = torch.from_numpy(long_ids(rng, B, 256, 8192)).to(dev)
        (x, ws, bs, mask), _, _ = embedded(COSTMODEL_BASE, B, 256, None,
                                           ids=ids)
        with torch.inference_mode():
            k_ms, p_ms = time_pair(
                lambda: K._launch_tower(x, ws, bs, mask),
                lambda: REF.conv1d_stack_ref(x, ws, bs, mask))
            q_ms, h_ms = time_queued(
                lambda: K._launch_tower(x, ws, bs, mask))
        flops = B * sum(2 * 256 * w.shape[0] * w.shape[1] * w.shape[2]
                        for w in ws)
        nbytes = x.numel() * x.element_size() + mask.numel() * 4 + sum(
            t.numel() * t.element_size() for t in [*ws, *bs]) \
            + B * ws[-1].shape[2] * x.element_size()
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        timings[B] = {"B": B, "S": 256, "ms": k_ms, "plain_ms": p_ms,
                      "device_ms": q_ms, "host_ms": h_ms,
                      "bound_ms": max(t_ops, t_bytes) * 1e3,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "flops": flops, "bytes": nbytes,
                      "plan": plan_of(B, 256, x, ws),
                      "ptxas": usage.get("f32")}
        emit({"phase": "tower", "case": "timing", **timings[B]})

    # the tower path: conv_tower_apply at the main shape, counted alone
    _, p, ids = embedded(COSTMODEL_BASE, 64, 256, None)
    K.conv1d_stack_fused.launches = 0
    out = ops.conv_tower_apply(p, ids)
    torch.cuda.synchronize()
    launches = K.conv1d_stack_fused.launches
    check(launches > 0 and all(bool(torch.isfinite(v).all())
                               for v in out.values()),
          f"conv_tower_apply ran the tower kernel ({launches} launches)")
    emit({"phase": "tower", "case": "path", "launches": launches})
    return {"max_abs_err": max_err, "timings": timings, "launches": launches}


@functools.lru_cache(maxsize=None)
def serve_world():
    """The serve phases' dataset (for its vocab), norm stats and the 128
    graphs their clients ask for, built once."""
    import numpy as np
    from repro_torch.core.models import DEFAULT_HEADS
    from repro_torch.ir import dataset as DS
    from repro_torch.ir import samplers
    ds = DS.build_dataset(300, mode="ops", max_seq=256, vocab_size=8192,
                          seed=0)
    _, stats = DS.normalize_targets_multi(ds.targets, DEFAULT_HEADS)
    rng = np.random.default_rng(1)
    graphs = [samplers.sample_graph(rng) for _ in range(128)]
    return ds, stats, graphs


def drive_clients(server, graphs, n_threads: int = 8) -> tuple:
    """``n_threads`` client threads, each submitting its share of
    ``graphs`` (the same number each) twice over, the second pass
    repeats, one request at a time. Returns ({graph index: row},
    latencies in s, wall s)."""
    per = len(graphs) // n_threads
    rows, lat = {}, []
    lock = threading.Lock()
    errors = []

    def client(k: int) -> None:
        mine = list(range(per * k, per * k + per))
        try:
            for i in mine + mine:                  # second pass: repeats
                ts = time.perf_counter()
                row = server.submit(graphs[i]).result(timeout=120)
                dt = time.perf_counter() - ts
                with lock:
                    rows[i] = row
                    lat.append(dt)
        except Exception as e:                     # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "client threads ended")
    check(not errors, f"client errors {errors[:3]}")
    return rows, lat, wall


def run_serve(phase: str, kind: str, params, kernel, plain,
              card: str) -> dict:
    """A main path: ``CostModelService(kind, use_kernel=True)`` on the
    card behind a ``CostModelServer``, 256 requests from 8 client threads
    (half of them repeats). ``kernel`` is the wrapper whose ``launches``
    must equal the batches the server flushed after warm-up; ``plain``
    (f32 params on the card, ids) -> {head: (B,)} is the plain forward
    the served rows must equal within TOL."""
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core.server import CostModelServer
    from repro_torch.core.service import CostModelService

    t0 = time.perf_counter()
    ds, stats, graphs = serve_world()
    setup_s = time.perf_counter() - t0

    def service():
        return CostModelService(kind, COSTMODEL_BASE, params, ds.vocab,
                                stats, mode="ops", max_seq=256,
                                max_batch=64, use_kernel=True)
    svc = service()
    server = CostModelServer(svc, max_batch=64, flush_us=2000)
    t1 = time.perf_counter()
    server.start(warmup=True)
    warm_s = time.perf_counter() - t1
    kernel.launches = 0                     # served batches from here on
    forward_s0 = svc.phase_stats()["forward_s"]
    rows, lat, wall = drive_clients(server, graphs)
    forward_s = svc.phase_stats()["forward_s"] - forward_s0
    preds = server.predict_all(graphs[:8])
    snap = server.metrics_snapshot()
    server.stop()
    launches = kernel.launches

    check(len(rows) == len(graphs), "every graph answered")
    got = np.stack([rows[i] for i in range(len(graphs))])
    check(bool(np.isfinite(got).all()), "served rows finite")
    check(all(np.isfinite(v).all() for v in preds.values()),
          "denormalized predictions finite")
    check(snap["cache_hits"] > 0, f"LRU hits {snap['cache_hits']}")
    check(launches > 0 and launches == snap["batches"],
          f"{phase}: one launch per served batch: {launches} launches, "
          f"{snap['batches']} batches")

    # served rows == a direct plain forward of the same ids (TF32 off)
    dev_p = P.from_numpy(params, "cuda")
    by_len = {}
    entries = [svc.entry(g) for g in graphs]
    for i, (_, ids) in enumerate(entries):
        by_len.setdefault(len(ids), []).append((i, ids))
    err = 0.0
    with torch.inference_mode():
        for group in by_len.values():
            idx = [i for i, _ in group]
            ids = torch.from_numpy(np.stack([x for _, x in group])).cuda()
            want = plain(dev_p, ids)
            want = torch.stack([want[t] for t in svc.heads], 1).cpu().numpy()
            err = max(err, float(np.abs(got[idx] - want).max()))
    check(err <= TOL, f"{phase}: served rows vs plain forward err {err}")
    # ... and a direct predict of another service, in other batches, bit
    # for bit
    direct = service().predict_entries(entries)
    identical = bool(np.array_equal(got, direct))
    check(identical, f"{phase}: served rows bit-identical to direct")
    lat_ms = np.asarray(lat) * 1e3
    out = {"phase": phase, "kind": kind, "requests": len(lat),
           "requests_per_s": len(lat) / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "server_p50_us": snap["latency_p50_us"],
           "server_p99_us": snap["latency_p99_us"],
           "cache_hits": snap["cache_hits"], "batches": snap["batches"],
           "batch_occupancy": snap["batch_occupancy"],
           "launches": launches, "max_abs_err_vs_plain": err,
           "identical_to_direct": identical,
           "setup_s": setup_s, "warmup_s": warm_s,
           "phase_forward_s": snap["phase_forward_s"],
           "forward_ms_per_batch": forward_s * 1e3 / snap["batches"],
           "card": card}
    emit(out)
    return out


def phase_serve(card: str) -> dict:
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core.models import DEFAULT_HEADS
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.kernels import ref as REF
    return run_serve("serve", "conv1d",
                     seeded_params(COSTMODEL_BASE, DEFAULT_HEADS, 0),
                     K.conv_forward_fused, REF.conv_forward_ref, card)


def phase_serve_lstm(card: str) -> dict:
    """The LSTM main path: every served batch is one launch of K2's ids
    entry, and the xw entry (with its (B, S, 4H) gates) never runs."""
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import models as CM
    from repro_torch.kernels import lstm_scan as K2
    K2.lstm_scan_fused.launches = 0
    out = run_serve("serve_lstm", "lstm",
                    seeded_lstm_params(COSTMODEL_BASE, CM.DEFAULT_HEADS, 0),
                    K2.lstm_scan_ids, CM.lstm_apply, card)
    check(K2.lstm_scan_fused.launches == 0,
          f"serve_lstm launched the xw entry "
          f"{K2.lstm_scan_fused.launches} times")
    return out


def tf32_conv1d(x, w, b):
    """models.conv1d without its precision guard: cuDNN under the
    process's switches, the plain conv path as it was before the TF32
    repair (the train phase's sensitivity case)."""
    import torch.nn.functional as F
    fs = w.shape[0]
    xc = F.pad(x.transpose(1, 2), ((fs - 1) // 2, fs // 2))
    return F.conv1d(xc, w.permute(2, 1, 0)).transpose(1, 2) + b


def grad_distance(a, b) -> float:
    """Relative L2 distance of two gradient trees, all leaves together."""
    from repro_torch import params as P
    fa = [x.double().cpu() for x in P.tree_flatten(a)]
    fb = [x.double().cpu() for x in P.tree_flatten(b)]
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(fa, fb))
    return (num / sum(float((y ** 2).sum()) for y in fb)) ** 0.5


def params_equal(a, b, rtol: float, atol: float) -> float:
    """Largest |a - b| over two param trees; raises past rtol/atol."""
    import numpy as np
    from repro_torch import params as P
    worst = 0.0
    for x, y in zip(P.tree_flatten(a), P.tree_flatten(b)):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        worst = max(worst, float(np.abs(x - y).max()))
        check(bool(np.allclose(y, x, rtol=rtol, atol=atol)),
              f"resumed params differ from the uninterrupted run's by "
              f"{float(np.abs(x - y).max())}")
    return worst


def serve_trained(kind: str, result, kernel, plain) -> dict:
    """The trained params through ``CostModelService(kind,
    use_kernel=True)`` on the serve phases' 128 graphs, one batch a
    bucket: rows within TOL of ``plain`` (the plain card forward), and
    ``kernel`` launched once a batch."""
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core.service import CostModelService
    ds, _, graphs = serve_world()
    svc = CostModelService(kind, COSTMODEL_BASE, result.params, ds.vocab,
                           result.norm_stats, mode="ops", max_seq=256,
                           max_batch=128, use_kernel=True)
    entries = [svc.entry(g) for g in graphs]
    groups = {}
    for e in entries:
        groups.setdefault(len(e[1]), []).append(e)
    kernel.launches = 0
    rows = [svc.forward_entries(g) for g in groups.values()]
    launches = kernel.launches
    check(launches == len(groups), f"serve trained {kind}: {launches} "
          f"launches for {len(groups)} batches")
    dev_p = P.from_numpy(result.params, "cuda")
    err = 0.0
    with torch.inference_mode():
        for got, group in zip(rows, groups.values()):
            ids = torch.from_numpy(np.stack([i for _, i in group])).cuda()
            want = plain(dev_p, ids)
            want = torch.stack([want[t] for t in svc.heads], 1)
            check(bool(np.isfinite(got).all()), "served rows finite")
            err = max(err, float(np.abs(got - want.cpu().numpy()).max()))
    check(err <= TOL, f"serve trained {kind}: rows vs plain err {err}")
    return {"launches": launches, "batches": len(groups),
            "rows": len(entries), "max_abs_err_vs_plain": err}


def eager_sgd_loop(engine, train, steps: int) -> tuple:
    """``engine``'s step as a plain eager loop of ``make_sgd_step`` on
    the card over the engine's loader's batches (with compression, the
    same pieces with the error state threaded). Returns (params, opt
    state, error state, losses, batch shapes)."""
    import torch
    from repro_torch import params as P
    from repro_torch.core import trainer as TR
    from repro_torch.ir import dataset as DS
    from repro_torch.optim import adamw, compress
    e = engine.ecfg
    params = P.from_numpy(engine.init_fn(
        engine.cfg, heads=engine.heads,
        generator=torch.Generator().manual_seed(e.seed)), "cuda")
    y, _ = DS.stacked_normalized_targets(train.targets, engine.heads)
    opt_cfg = adamw.AdamWConfig(lr=e.lr, total_steps=e.steps,
                                warmup_steps=min(50, e.steps // 10),
                                weight_decay=e.weight_decay)
    state = adamw.init_state(params)
    err = compress.init_error_state(params) if e.compress_grads else None
    step = TR.make_sgd_step(engine.apply_fn, opt_cfg, heads=engine.heads)
    loss_fn = TR.make_loss_fn(engine.apply_fn, engine.heads)
    losses, shapes = [], []
    for _, b in zip(range(steps), engine.make_loader(train, y)):
        ids = torch.from_numpy(b["ids"]).cuda()
        yy = torch.from_numpy(b["y"]).cuda()
        shapes.append(tuple(ids.shape))
        if err is None:
            params, state, loss = step(params, state, ids, yy)
        else:
            loss, grads = TR.value_and_grad(loss_fn, params, ids, yy)
            grads, err = compress.compress_grads(grads, err)
            with torch.no_grad():
                params, state, _ = adamw.apply_updates(params, grads,
                                                       state, opt_cfg)
        losses.append(float(loss))
    return params, state, err, losses, shapes


def graphed_vs_eager(train, heads, steps: int = 10) -> dict:
    """``steps`` steps of conv1d at ``base-train-b512``'s shapes (B=512,
    the ``batch_max`` loader) on the card, graphed, against
    :func:`eager_sgd_loop` on the same batches, under deterministic
    algorithms (the caller's): params, both moments, the count and the
    losses must be the same bits, and at least one step a replay."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import trainer as TR
    from repro_torch.obs import trace as OBS
    rows = train.take(np.resize(np.arange(len(train.ids)),
                                -(-2048 // len(train.ids)) * len(train.ids)))
    tracer = OBS.Tracer(sample_every=1, proc="trainer")
    with tempfile.TemporaryDirectory() as tmp:
        engine = TR.TrainEngine("conv1d", COSTMODEL_BASE, heads, steps=steps,
                                batch_size=512, seed=7, log_every=1,
                                ckpt_dir=tmp, tracer=tracer)
        got = engine.fit(rows)
        params, state, err, losses, shapes = eager_sgd_loop(engine, rows,
                                                            steps)
        saved, at, _ = ckpt.restore(tmp, (params, state, err))
    replayed = sum(s["tags"]["graphed"] for s in tracer.recorder.snapshot()
                   if s["name"] == "trainer.step")
    check(at == steps, f"the graphed fit saved step {at}, not {steps}")
    check(replayed >= 1, f"{replayed} of {steps} steps replayed a graph")
    check([v for _, v in got.history] == losses,
          "graphed losses are not the eager loop's bits")
    for name, a, b in (("params", got.params, params),
                       ("state", saved, (params, state, err))):
        for x, w in zip(P.tree_flatten(a), P.tree_flatten(b)):
            check(x.dtype == w.dtype and x.shape == w.shape and
                  torch.equal(x.cpu(), w.cpu()),
                  f"graphed {name} are not the eager loop's bits")
    return {"steps": steps, "replayed": replayed,
            "shapes": sorted(set(shapes)), "rows": len(rows.ids)}


def profile_steps(engine, train, start: int) -> dict:
    """Fit ``engine`` with the profiler on from step ``start`` to the
    end: the wall time a step (host clock, the card synchronized at both
    ends), the card's kernel time a step and their ratio (the card's busy
    share), kernel launches a step, and the five kernels with the most
    card time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    t = {}

    def on_step(step, dt):
        if step == start:
            torch.cuda.synchronize()
            prof.start()
            t["0"] = time.perf_counter()
    engine.fit(train, on_step=on_step)      # synchronizes at its end
    wall_s = time.perf_counter() - t["0"]
    prof.stop()
    n = engine.ecfg.steps - start
    busy_us, launches, top = kernel_times(prof, 5)
    return {"steps": n, "wall_ms_per_step": wall_s * 1e3 / n,
            "card_ms_per_step": busy_us / 1e3 / n,
            "card_busy_share": busy_us / 1e6 / wall_s,
            "launches_per_step": launches / n,
            "top_kernels_ms_per_step": {
                k[:60]: us / 1e3 / n for k, us in top}}


def kernel_times(prof, n_top: int) -> tuple:
    """A profile's card time (us) summed over its kernels, its kernel
    launches, and its ``n_top`` kernels with the most card time as
    (name, us) pairs."""
    import torch
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n_top]
    return (sum(e.self_device_time_total for e in kernels),
            sum(e.count for e in kernels),
            [(e.key, e.self_device_time_total) for e in top])


def phase_train(card: str) -> dict:
    """Train the Conv1D and LSTM cost models on the card, then serve
    what was trained through K1 and K2 (see the module docstring)."""
    import signal
    import tempfile
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import models as CM
    from repro_torch.core import trainer as TR
    from repro_torch.core.service import CostModelService
    from repro_torch.ir import dataset as DS
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.kernels import embed_grad as EG
    from repro_torch.kernels import lstm_scan as K2
    t_phase = time.perf_counter()
    heads = CM.DEFAULT_HEADS
    ds, stats, graphs = serve_world()
    tr, te = ds.split(0.1)

    # 1. F1 end to end, with the TF32 switches at torch's defaults
    params = seeded_params(COSTMODEL_BASE, heads, 0)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def service(device):
            return CostModelService("conv1d", COSTMODEL_BASE, params,
                                    ds.vocab, stats, mode="ops",
                                    max_seq=256, max_batch=128,
                                    device=device)
        entries = [service("cpu").entry(g) for g in graphs]
        rows_cpu = service("cpu").predict_entries(entries)
        rows_card = service(None).predict_entries(entries)
        serve_err = float(np.abs(rows_card - rows_cpu).max())
        with mock.patch.object(CM, "conv1d", tf32_conv1d):
            tf32_serve_err = float(np.abs(
                service(None).predict_entries(entries) - rows_cpu).max())
        ids = torch.from_numpy(tr.ids[:64])
        y, _ = DS.stacked_normalized_targets(
            {t: v[:64] for t, v in tr.targets.items()}, heads)
        y = torch.from_numpy(y)
        loss_fn = TR.make_loss_fn(CM.conv_apply, heads)
        _, g_cpu = TR.value_and_grad(loss_fn, P.from_numpy(params, "cpu"),
                                     ids, y)

        def card_grads():
            return TR.value_and_grad(loss_fn, P.from_numpy(params, "cuda"),
                                     ids.cuda(), y.cuda())[1]
        grad_err = grad_distance(card_grads(), g_cpu)
        with mock.patch.object(CM, "conv1d", tf32_conv1d):
            tf32_grad_err = grad_distance(card_grads(), g_cpu)
        # reported, not checked: a batch of random tokens, where a ReLU
        # input lies within rounding of 0 and its gate opens in one
        # arithmetic only: the card's float32 misses its own float64 by
        # as much as TF32 misses the CPU, so no limit tells them apart
        rng = np.random.default_rng(9)
        r_ids = torch.from_numpy(ragged_ids(rng, 64, 256, 8192))
        r_y = torch.from_numpy(rng.standard_normal((64, 3))
                               .astype(np.float32))
        _, r_cpu = TR.value_and_grad(loss_fn, P.from_numpy(params, "cpu"),
                                     r_ids, r_y)

        def random_grads(dtype=torch.float32):
            p = P.from_numpy(params, "cuda", dtype)
            return TR.value_and_grad(loss_fn, p, r_ids.cuda(),
                                     r_y.to("cuda", dtype))[1]
        random_tokens = {"grad_rel_l2": grad_distance(random_grads(),
                                                      r_cpu),
                         "card_f32_vs_f64": grad_distance(
                             random_grads(), random_grads(torch.float64))}
        with mock.patch.object(CM, "conv1d", tf32_conv1d):
            random_tokens["tf32_grad_rel_l2"] = grad_distance(
                random_grads(), r_cpu)
        switches_kept = bool(torch.backends.cudnn.allow_tf32)
        t0 = time.perf_counter()
        for _ in range(1000):
            with CM.ieee_convolutions():
                pass
        guard_us = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cudnn.allow_tf32 = False     # the f32 yardsticks
        torch.backends.cuda.matmul.allow_tf32 = False
    check(serve_err <= TOL, f"default card service vs CPU err {serve_err}")
    check(grad_err <= TRAIN_GRAD_RTOL, f"card gradients {grad_err} off "
          f"the CPU's (limit {TRAIN_GRAD_RTOL})")
    check(tf32_grad_err > TRAIN_GRAD_RTOL, f"TF32 gradients only "
          f"{tf32_grad_err} off: the gradient check cannot fail")
    check(switches_kept, "the precision guard lost cuDNN's TF32 switch")
    f1 = {"phase": "train", "case": "f1_tf32_defaults",
          "serve_max_abs_err": serve_err,
          "tf32_serve_max_abs_err": tf32_serve_err,
          "grad_rel_l2": grad_err, "tf32_grad_rel_l2": tf32_grad_err,
          "grad_limit": TRAIN_GRAD_RTOL, "rows": len(entries),
          "random_tokens": random_tokens, "guard_host_us": guard_us}
    emit(f1)

    # 2. conv1d, 200 steps, deterministic; killed at 120 and resumed
    class Kill(Exception):
        pass

    def kill_at(n):
        def on_step(step, dt):
            if step == n:
                raise Kill()
        return on_step
    kw = dict(steps=200, batch_size=64, bucketed=True, save_every=50,
              log_every=1)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            EG.embed_grad.launches = 0      # E1: one a training step
            full = TR.TrainEngine("conv1d", COSTMODEL_BASE, heads,
                                  ckpt_dir=os.path.join(tmp, "full"),
                                  **kw).fit(tr)
            full_s = time.perf_counter() - t0
            e1_launches = EG.embed_grad.launches
            check(e1_launches == kw["steps"], f"embed_grad ran "
                  f"{e1_launches} times in {kw['steps']} steps")
            d = os.path.join(tmp, "killed")
            try:
                TR.TrainEngine("conv1d", COSTMODEL_BASE, heads, ckpt_dir=d,
                               **kw).fit(tr, on_step=kill_at(120))
                check(False, "the run to kill was not killed")
            except Kill:
                pass
            resumed = TR.TrainEngine("conv1d", COSTMODEL_BASE, heads,
                                     ckpt_dir=d, **kw).fit(tr)
        replayed_vs_eager = graphed_vs_eager(tr, heads)
    finally:
        torch.use_deterministic_algorithms(False)
    emit({"phase": "train", "case": "graphed_vs_eager", "bit_equal": True,
          **replayed_vs_eager})
    check(resumed.stats["steps"] == 100.0,
          f"resumed {resumed.stats['steps']} steps, not 100")
    resume_err = params_equal(full.params, resumed.params, 1e-6, 1e-7)
    first, last = full.history[0][1], full.history[-1][1]
    check(last < 0.5 * first, f"loss {first} -> {last}: not below half")
    metrics = TR.evaluate("conv1d", COSTMODEL_BASE, full, te)
    check(set(metrics) == set(heads) and all(
        np.isfinite(list(m.values())).all() for m in metrics.values()),
        f"evaluate gave {metrics}")
    emit({"phase": "train", "case": "conv1d", "steps": 200,
          "batch_size": 64, "first_loss": first, "last_loss": last,
          "resumed_steps": resumed.stats["steps"],
          "resume_max_abs_diff": resume_err, "seconds": full_s,
          "embed_grad_launches": e1_launches,
          "eval": {t: {k: metrics[t][k] for k in ("rmse_norm",
                                                  "rmse_rel_pct")}
                   for t in heads}})

    # 3. the first 10 losses against the same engine on the CPU, stopped
    # there by the supervisor's preemption path
    def preempt_at(n):
        def on_step(step, dt):
            if step == n:
                os.kill(os.getpid(), signal.SIGTERM)
        return on_step
    prev = signal.getsignal(signal.SIGTERM)
    try:
        cpu = TR.TrainEngine("conv1d", COSTMODEL_BASE, heads, device="cpu",
                             install_sigterm=True, **kw).fit(
                                 tr, on_step=preempt_at(10))
    finally:
        signal.signal(signal.SIGTERM, prev)
    card_l = np.array([v for _, v in full.history[:10]])
    cpu_l = np.array([v for _, v in cpu.history])
    check(len(cpu_l) == 10, f"CPU run stopped after {len(cpu_l)} steps")
    loss_err = float(np.max(np.abs(card_l - cpu_l) / np.abs(cpu_l)))
    check(loss_err <= TRAIN_LOSS_RTOL, f"card losses {loss_err} off the "
          f"CPU's (limit {TRAIN_LOSS_RTOL})")
    emit({"phase": "train", "case": "card_vs_cpu_losses",
          "card": card_l.tolist(), "cpu": cpu_l.tolist(),
          "max_rel_err": loss_err, "limit": TRAIN_LOSS_RTOL})

    # 4. serve the trained conv1d params through K1
    conv_serve = serve_trained("conv1d", full, K.conv_forward_fused,
                               CM.conv_apply)
    emit({"phase": "train", "case": "serve_trained_conv1d", **conv_serve})

    # 5. lstm, 20 steps, served through K2
    marks = {}

    def mark(n):
        def on_step(step, dt):
            if step == n:
                torch.cuda.synchronize()
                marks["t"] = time.perf_counter()
        return on_step
    t0 = time.perf_counter()
    lstm = TR.TrainEngine("lstm", COSTMODEL_BASE, heads, steps=20,
                          batch_size=64, log_every=20).fit(
                              tr, on_step=mark(5))
    lstm_ms = (time.perf_counter() - marks["t"]) * 1e3 / 15
    lstm_s = time.perf_counter() - t0
    check(np.isfinite(lstm.stats["final_loss"]), "lstm loss finite")
    lstm_serve = serve_trained("lstm", lstm, K2.lstm_scan_ids,
                               CM.lstm_apply)
    emit({"phase": "train", "case": "lstm", "steps": 20, "batch_size": 64,
          "final_loss": lstm.stats["final_loss"], "seconds": lstm_s,
          "ms_per_step": lstm_ms, "serve": lstm_serve, "card": card})

    # 6. conv1d's time a step, bucketed, after 50 steps of warm-up
    t0 = time.perf_counter()
    TR.TrainEngine("conv1d", COSTMODEL_BASE, heads, steps=150,
                   batch_size=64, log_every=150).fit(tr, on_step=mark(50))
    conv_ms = (time.perf_counter() - marks["t"]) * 1e3 / 100
    timed_s = time.perf_counter() - t0
    busy = profile_steps(TR.TrainEngine("conv1d", COSTMODEL_BASE, heads,
                                        steps=40, batch_size=64,
                                        log_every=40), tr, 20)
    out = {"phase": "train", "case": "times", "conv1d_ms_per_step": conv_ms,
           "conv1d_steps_per_s": 1e3 / conv_ms, "lstm_ms_per_step": lstm_ms,
           "batch_size": 64, "bucketed": True,
           "conv1d_timed_run_s": timed_s, "conv1d_profiled": busy,
           "phase_seconds": time.perf_counter() - t_phase, "card": card}
    emit(out)
    return {**out, "f1": f1, "conv_serve": conv_serve,
            "lstm_serve": lstm_serve, "e1_launches": e1_launches}


def lookup_ids(rng, case: str, S: int):
    """(EG_B, S) int32 ids of a bucket of width S: rows of EG_LENS real
    tokens then PAD (``ragged``), the same with one id in 90% of the real
    positions (``hot``: an op name that fills the batch), or uniform ids
    with 95% PAD (``pad95``)."""
    import numpy as np
    ids = rng.integers(1, EG_V, (EG_B, S))
    if case == "pad95":
        ids[rng.random(ids.shape) < 0.95] = 0
        return ids.astype(np.int32)
    if case == "hot":
        ids[rng.random(ids.shape) < 0.9] = 7
    lens = rng.integers(EG_LENS[0], min(EG_LENS[1], S) + 1, (EG_B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    return ids.astype(np.int32)


def lookup_limit(exact, count, mass, dtype, chunk: int):
    """How far the kernel's sums may land from float64 ones: its longest
    chain of dependent adds for an id of ``count`` rows (a chunk, one of
    4 groups' share of the segment's chunks, the join of the groups)
    x 2^-23 (twice float32's unit roundoff) x the id's sum of |rows|,
    and for a bfloat16 result one rounding more, 2^-8 of the value."""
    import torch
    chain = chunk + torch.ceil((torch.ceil(count / chunk) + 1) / 4) + 5
    tol = chain[:, None] * 2.0 ** -23 * mass
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (exact.abs() + tol)
    return tol


def phase_kernels_embed() -> dict:
    """E1, the conv1d lookup's backward (``embed_grad``), against its
    plain version at base-train-b512's shapes, and its times beside the
    plain version, PyTorch's embedding backward and autograd's
    ``index_put_`` (the path it replaced)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import embed_grad as EG
    from repro_torch.kernels.conv_tile_probe import time_queued
    dev = torch.device("cuda")
    rng = np.random.default_rng(30)
    worst = 0.0
    for S in (32, 64, 128, 256):
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("ragged", "hot", "pad95"):
                ids = torch.from_numpy(lookup_ids(rng, case, S))
                grad = torch.randn((EG_B, S, EG_E),
                                   generator=torch.Generator().manual_seed(
                                       S)).to(dtype)
                got = EG.embed_grad(grad.to(dev), ids.to(dev), EG_V).cpu()
                # the plain version in float64: exact at these counts
                exact = EG.embed_grad_ref(grad.double(), ids, EG_V)
                flat = ids.reshape(-1).long()
                keep = flat != 0
                count = torch.bincount(flat[keep], minlength=EG_V).double()
                mass = EG.embed_grad_ref(grad.double().abs(), ids, EG_V)
                tol = lookup_limit(exact, count, mass, dtype, EG.CHUNK)
                err = float(((got.double() - exact).abs() / tol.clamp_min(
                    1e-300)).max())
                check(err <= 1.0 and not got[count == 0].any(),
                      f"embed_grad S={S} {dtype} {case}: {err} of its limit")
                # the limit can fail: the most frequent id without one chunk
                top = int(count.argmax())
                pos = (flat == top).nonzero().reshape(-1)[:EG.CHUNK]
                dropped = grad.reshape(-1, EG_E)[pos].double().sum(0)
                miss = float((dropped.abs() / tol[top]).max())
                check(miss > 10.0, f"embed_grad S={S} {dtype} {case}: a "
                      f"dropped chunk only {miss} of the limit")
                again = EG.embed_grad(grad.to(dev), ids.to(dev), EG_V).cpu()
                check(torch.equal(again, got), f"embed_grad S={S} {dtype} "
                      f"{case}: two launches differ")
                worst = max(worst, err)
                c = {"S": S, "dtype": str(dtype).split(".")[-1],
                     "case": case, "err_over_limit": err,
                     "dropped_chunk_over_limit": miss,
                     "top_id_rows": int(count[top]),
                     "real_rows": int(keep.sum())}
                emit({"phase": "kernels_embed", **c})

    # times on the card, in turns, at the buckets the cell's rows fill
    timings = {}
    usage = ptxas_usage(EG.LIB)
    for S in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            ids = torch.from_numpy(lookup_ids(rng, "ragged", S)).to(dev)
            grad = torch.randn((EG_B, S, EG_E), device=dev).to(dtype)
            flat = ids.reshape(-1).long()
            masked = (grad * (ids != 0).to(dtype)[..., None]).reshape(
                -1, EG_E)
            keys, perm = torch.sort(ids.reshape(-1), stable=True)
            out = torch.zeros((EG_V, EG_E), dtype=dtype, device=dev)
            work = torch.empty(-(-ids.numel() // EG.CHUNK) * 2 * EG_E,
                               device=dev)
            entry = _build.bind(_build.load(EG.LIB), EG._ENTRY[dtype],
                                EG._ARGS)

            def kernels_only():
                stream = torch.cuda.current_stream().cuda_stream
                entry(grad.data_ptr(), keys.data_ptr(), perm.data_ptr(),
                      ids.numel(), EG_E, EG_V, out.data_ptr(),
                      work.data_ptr(), work.nbytes, stream)

            def index_put():
                return torch.zeros((EG_V, EG_E), dtype=dtype,
                                   device=dev).index_put_(
                    (flat,), masked, accumulate=True)

            def library():                  # padding_idx 0
                return torch.ops.aten.embedding_dense_backward(
                    grad, flat.view(ids.shape), EG_V, 0, False)

            def op():
                return EG.embed_grad(grad, ids, EG_V)
            ms, plain_ms = time_pair(op, lambda: EG.embed_grad_ref(
                grad, ids, EG_V))
            k_ms, lib_ms = time_pair(kernels_only, library)
            _, put_ms = time_pair(op, index_put, n_samples=5, reps=2)
            # the card's time alone and the host's
            dev_ms, host_ms = time_queued(op)
            lib_dev_ms, lib_host_ms = time_queued(library)
            # least bytes: the real positions' rows, the ids, the table
            n_real = int((ids != 0).sum())
            nbytes = (n_real * EG_E + EG_V * EG_E) * grad.element_size() \
                + ids.numel() * ids.element_size()
            b_ms = nbytes / PEAK_BYTES * 1e3
            t = {"S": S, "dtype": str(dtype).split(".")[-1], "ms": ms,
                 "kernel_ms": k_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, "index_put_ms": put_ms,
                 "device_ms": dev_ms, "host_ms": host_ms,
                 "library_device_ms": lib_dev_ms,
                 "library_host_ms": lib_host_ms,
                 "bound_ms": b_ms, "bound_by": "bytes", "bytes": nbytes,
                 "roofline_pct": 100.0 * b_ms / dev_ms, "real_rows": n_real,
                 "ptxas": usage}
            timings[(S, t["dtype"])] = t
            emit({"phase": "kernels_embed", "case": "timing", **t})
    return {"max_err_over_limit": worst, "timings": timings}


# compiler phase: the reference fixture's corpus and training settings
# (tests/test_opt.py's trained model) at COSTMODEL_BASE's widths
COMPILER_GRAPHS, COMPILER_STEPS = 600, 250
RTOL_DEN = 1e-3         # denormalized predictions, card against CPU


def count_batches(svc) -> list:
    """Count the forward batches ``svc`` dispatches (a K1 service
    launches K1 once for each); returns the one-item counter."""
    n = [0]
    dispatch = svc.forward_dispatch

    def counted(ids):
        n[0] += 1
        return dispatch(ids)
    svc.forward_dispatch = counted
    return n


def chain_graph():
    """The three-op elementwise chain of the reference's opt tests."""
    from repro_torch.ir.graph import Graph, Tensor
    t = Tensor((8, 128))
    g = Graph(name="chain")
    x = g.add_arg(t)
    for op in ("relu", "tanh", "sigmoid"):
        x = g.add_op(op, [x], t)
    g.outputs = [x]
    return g


def rel_err(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def phase_compiler(card: str) -> dict:
    """The compiler's path (see the module docstring): MLIR text in
    through the front door, rewrite advice out of the optimizer, every
    forward through K1 on the card."""
    from unittest import mock
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import augment as AUG
    from repro_torch.core import models as CM
    from repro_torch.core import service as SVC
    from repro_torch.core import trainer as TR
    from repro_torch.core.server import CostModelServer
    from repro_torch.ir import dataset as DS
    from repro_torch.ir import frontdoor as FD
    from repro_torch.ir import printer, samplers
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.opt import evaluate as OE
    from repro_torch.opt import search as SE
    t_phase = time.perf_counter()
    heads = CM.DEFAULT_HEADS
    fams = sorted(samplers.SAMPLERS)

    # 1. train on the rewrite-augmented corpus
    t0 = time.perf_counter()
    ds = DS.build_dataset(COMPILER_GRAPHS, mode="ops", max_seq=256,
                          vocab_size=8192, rewrite_factor=1, seed=9)
    corpus_s = time.perf_counter() - t0
    tr, _ = ds.split(0.1)
    marks = {}

    def mark(step, dt):
        if step == 50:
            torch.cuda.synchronize()
            marks["t"] = time.perf_counter()
    t0 = time.perf_counter()
    result = TR.TrainEngine("conv1d", COSTMODEL_BASE, heads,
                            steps=COMPILER_STEPS, batch_size=128, lr=2e-3,
                            seed=9, log_every=10).fit(tr, on_step=mark)
    t1 = time.perf_counter()
    step_ms = (t1 - marks["t"]) * 1e3 / (COMPILER_STEPS - 50)
    first, last = result.history[0][1], result.history[-1][1]
    check(np.isfinite(last) and last < first,
          f"compiler: loss {first} -> {last}")
    emit({"phase": "compiler", "case": "train", "rows": len(ds),
          "train_rows": len(tr), "vocab": len(ds.vocab.token_to_id),
          "corpus_s": corpus_s, "steps": COMPILER_STEPS,
          "batch_size": 128, "first_loss": first, "last_loss": last,
          "train_s": t1 - t0, "ms_per_step": step_ms, "card": card})

    # 2. serve: K1 services on the card (one direct, one behind the
    # server), a plain CPU service, all from the same numpy params
    params = P.to_numpy(result.params)

    def service(**kw):
        return SVC.CostModelService("conv1d", COSTMODEL_BASE, params,
                                    ds.vocab, result.norm_stats, mode="ops",
                                    max_seq=256, max_batch=64, **kw)
    direct = service(use_kernel=True)
    served = service(use_kernel=True)
    cpu = service(device="cpu")
    direct.warmup()
    server = CostModelServer(served, max_batch=64, flush_us=500).start(
        warmup=True)
    batches = [count_batches(direct), count_batches(served)]
    K.conv_forward_fused.launches = 0        # the path from here on

    # 3. the front door: printer texts of 64 graphs outside the corpus
    # (another seed) and the affine example
    rng = np.random.default_rng(77)
    held = [samplers.sample_graph(rng, fams[i % len(fams)])
            for i in range(64)]
    texts = [printer.to_mlir(g) for g in held] + [FD.AFFINE_EXAMPLE]
    t0 = time.perf_counter()
    ents = [cpu.ingest_text(t) for t in texts]    # no forward
    ingest_us = (time.perf_counter() - t0) * 1e6 / len(texts)
    bad = [e for e in ents if not isinstance(e, FD.TextEntry)]
    check(not bad, f"compiler: ingest errors {bad[:3]}")
    svc_out = []
    for text in texts:
        l0, b0 = K.conv_forward_fused.launches, batches[0][0]
        out = direct.predict_text(text)
        check(isinstance(out, FD.TextPrediction),
              f"compiler: service predict_text gave {out!r}")
        check(K.conv_forward_fused.launches - l0 == batches[0][0] - b0,
              f"compiler: {K.conv_forward_fused.launches - l0} K1 "
              f"launches for {batches[0][0] - b0} forward batches")
        svc_out.append(out)
    srv_out, lat, errors = [None] * len(texts), [], []
    lock = threading.Lock()

    def client(k: int) -> None:
        try:
            for i in range(k, len(texts), 8):
                ts = time.perf_counter()
                out = server.predict_text(texts[i])
                dt = time.perf_counter() - ts
                with lock:
                    srv_out[i] = out
                    lat.append(dt)
        except Exception as e:                     # surfaced below
            errors.append(repr(e))
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "client threads ended")
    check(not errors, f"compiler: client errors {errors[:3]}")
    bad = [o for o in srv_out if not isinstance(o, FD.TextPrediction)]
    check(not bad, f"compiler: server predict_text gave {bad[:3]}")
    identical = all(a.predictions == b.predictions
                    for a, b in zip(srv_out, svc_out))
    check(identical, "compiler: server predict_text != service bit for bit")
    entries = [(e.key, e.ids) for e in ents]
    row_err = float(np.abs(direct.predict_entries(entries)
                           - cpu.predict_entries(entries)).max())
    check(row_err <= TOL, f"compiler: card rows vs CPU err {row_err}")
    cpu_out = [cpu.predict_text(t) for t in texts]
    den_err = max(rel_err([a.predictions[t] for t in heads],
                          [b.predictions[t] for t in heads])
                  for a, b in zip(svc_out, cpu_out))
    check(den_err <= RTOL_DEN,
          f"compiler: card predictions vs CPU rel err {den_err}")
    fuzz = FD.fuzz_corpus(texts[:8] + [FD.AFFINE_EXAMPLE], 200,
                          np.random.default_rng(5))
    stages, n_pred = {}, 0
    for text in fuzz:
        out = server.predict_text(text)
        if isinstance(out, FD.IngestError):
            stages[out.stage] = stages.get(out.stage, 0) + 1
        else:
            check(all(np.isfinite(v) for v in out.predictions.values()),
                  "compiler: fuzz predictions finite")
            n_pred += 1
    check("predict" not in stages,
          f"compiler: fuzz errors at the predict stage: {stages}")
    check(n_pred > 0, "compiler: every fuzzed text degraded")
    snap = server.metrics_snapshot()
    server.stop()
    stopped = server.predict_text(texts[0])
    check(isinstance(stopped, FD.IngestError) and stopped.stage == "predict",
          f"compiler: a stopped server gave {stopped!r}")
    lat_ms = np.asarray(lat) * 1e3
    emit({"phase": "compiler", "case": "front_door", "texts": len(texts),
          "ingest_encode_host_us_per_text": ingest_us,
          "server_predict_text_p50_ms": float(np.percentile(lat_ms, 50)),
          "server_predict_text_p99_ms": float(np.percentile(lat_ms, 99)),
          "server_p50_us": snap["latency_p50_us"],
          "server_p99_us": snap["latency_p99_us"],
          "server_batches": snap["batches"],
          "identical_server_service": identical,
          "rows_max_abs_err_vs_cpu": row_err,
          "predictions_max_rel_err_vs_cpu": den_err,
          "fuzz": {"texts": len(fuzz), "predicted": n_pred,
                   "errors_by_stage": stages},
          "stopped_server": repr(stopped),
          "launches": K.conv_forward_fused.launches,
          "batches": batches[0][0] + batches[1][0], "card": card})

    # 4. the advisors through a server, against the CPU service's
    server = CostModelServer(served, max_batch=64, flush_us=500).start(
        warmup=False)                             # served is warm
    bert = samplers.sample_graph(np.random.default_rng(11), "bert")
    new = AUG.augment(bert, np.random.default_rng(12))

    def advise(svc):
        return (SVC.FusionAdvisor(svc).advise(chain_graph()),
                SVC.UnrollAdvisor(svc, register_budget=1e9).advise(
                    bert, factors=(1, 2, 4, 8)),
                SVC.RecompileAdvisor(svc).advise(bert, new))
    (fuse, c0, c1), unroll, recompile = advise(server)
    (cpu_fuse, cpu_c0, cpu_c1), cpu_unroll, cpu_recompile = advise(cpu)
    check(isinstance(fuse, bool) and c0 > 0 and c1 > 0,
          f"compiler: FusionAdvisor gave {(fuse, c0, c1)}")
    check(unroll["best_factor"] in (1, 2, 4, 8)
          and set(unroll["per_iter_latency"]) == {1, 2, 4, 8},
          f"compiler: UnrollAdvisor gave {unroll}")
    check(isinstance(recompile["recompile"], bool)
          and np.isfinite(recompile["shift"]),
          f"compiler: RecompileAdvisor gave {recompile}")
    f = (1, 2, 4, 8)
    adv_err = max(
        rel_err([c0, c1], [cpu_c0, cpu_c1]),
        rel_err([unroll["per_iter_latency"][k] for k in f]
                + [unroll["register_pressure"][k] for k in f],
                [cpu_unroll["per_iter_latency"][k] for k in f]
                + [cpu_unroll["register_pressure"][k] for k in f]),
        rel_err([recompile["predicted_old"], recompile["predicted_new"]],
                [cpu_recompile["predicted_old"],
                 cpu_recompile["predicted_new"]]))
    check(adv_err <= RTOL_DEN, f"compiler: advisors vs CPU rel err "
          f"{adv_err}")
    emit({"phase": "compiler", "case": "advisors",
          "fusion": {"fuse": fuse, "latency_before": c0,
                     "latency_after": c1, "same_as_cpu": fuse == cpu_fuse},
          "unroll": {**unroll, "same_as_cpu":
                     unroll["best_factor"] == cpu_unroll["best_factor"]},
          "recompile": {**recompile, "same_as_cpu":
                        recompile["recompile"]
                        == cpu_recompile["recompile"]},
          "max_rel_err_vs_cpu": adv_err, "card": card})

    # 5. the closed loop: beam search through the server, judged by the
    # analyzer oracle; the CPU service searches the same graphs
    rng = np.random.default_rng(10)
    graphs = [samplers.sample_graph(rng, fams[i % len(fams)])
              for i in range(20)]
    best_keys = {"card": [], "cpu": []}
    replay = OE.replay

    def recording(tag):
        def rec(res, rules=None):
            g = replay(res, rules)
            best_keys[tag].append(g.struct_key())
            return g
        return rec
    kw = dict(beam_width=3, max_steps=4, eval_budget=128)
    l0 = K.conv_forward_fused.launches
    with mock.patch.object(OE, "replay", recording("card")):
        t0 = time.perf_counter()
        report = OE.evaluate_search(server, graphs, **kw)
        search_s = time.perf_counter() - t0
    search_launches = K.conv_forward_fused.launches - l0
    with mock.patch.object(OE, "replay", recording("cpu")):
        cpu_report = OE.evaluate_search(cpu, graphs, **kw)
    s = report["summary"]
    check(s["n_graphs"] == 20, "compiler: 20 searches")
    check(s["mean_oracle_best_us"] <= s["mean_oracle_baseline_us"] + 1e-9,
          f"compiler: search {s['mean_oracle_best_us']} us worse than the "
          f"fusion baseline {s['mean_oracle_baseline_us']} us")
    check(s["frac_strictly_better_than_baseline"] >= 0.25,
          f"compiler: strictly better on "
          f"{s['frac_strictly_better_than_baseline']} of the graphs")
    check(all(r["predict_calls"] == 1 + r["expansions"]
              for r in report["per_graph"]),
          "compiler: one predict_all a frontier expansion")
    check(s["spearman_pred_oracle_pooled"] > 0.3,
          f"compiler: pooled Spearman {s['spearman_pred_oracle_pooled']}")
    same_best = sum(a == b for a, b in zip(best_keys["card"],
                                           best_keys["cpu"]))
    keys = ("mean_oracle_root_us", "mean_oracle_best_us",
            "mean_oracle_baseline_us", "frac_strictly_better_than_baseline",
            "spearman_pred_oracle_pooled", "spearman_pred_oracle",
            "candidates_costed", "predict_calls")
    emit({"phase": "compiler", "case": "closed_loop",
          **{k: s[k] for k in keys},
          "cpu": {k: cpu_report["summary"][k] for k in keys},
          "same_best_as_cpu": same_best,
          "evaluate_wall_s_per_graph": search_s / 20,
          "predict_all_calls_per_graph": s["predict_calls"] / 20,
          "k1_launches_per_graph": search_launches / 20, "card": card})

    # 6. the card's busy share over one search of a graph not seen yet
    g = samplers.sample_graph(np.random.default_rng(99), "resnet")
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    l0, b1 = K.conv_forward_fused.launches, batches[1][0]
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    res = SE.beam_search(server, g, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    prof.stop()
    server.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    emit({"phase": "compiler", "case": "profiled_search",
          "graph_ops": len(g.ops), "expansions": res.expansions,
          "evaluated": res.evaluated, "wall_ms": wall_s * 1e3,
          "card_ms": busy_us / 1e3, "card_busy_share": busy_us / 1e6
          / wall_s, "k1_launches": K.conv_forward_fused.launches - l0,
          "forward_batches": batches[1][0] - b1,
          "card_kernel_launches": sum(e.count for e in kernels),
          "card": card})

    launches, n_batches = K.conv_forward_fused.launches, \
        batches[0][0] + batches[1][0]
    check(launches > 0 and launches == n_batches,
          f"compiler: {launches} K1 launches for {n_batches} forward "
          f"batches")
    out = {"phase": "compiler", "case": "path", "launches": launches,
           "batches": n_batches,
           "phase_seconds": time.perf_counter() - t_phase, "card": card}
    emit(out)
    return out


# replicated phase: the tier's load, the fleet's searches (the compiler
# phase's settings) and the reference gate's recovery bound
REPL_GRAPHS, REPL_THREADS = 256, 8      # 512 requests, half repeats
FLEET_WORKERS, FLEET_POOL = 4, 16
FLEET_SEARCH = dict(beam_width=3, max_steps=4, eval_budget=128)
CHAOS_RECOVERY_S = 120.0                # benchmarks/gate.py's bound


def tier_stats(client) -> list:
    """Every replica's ``MSG_STATS`` payload, in replica order; each
    replica must answer."""
    stats = client.replica_stats()
    check(all(s is not None for s in stats),
          f"replicated: {sum(s is None for s in stats)} replicas did not "
          f"answer the stats RPC")
    return sorted(stats, key=lambda s: s["replica_id"])


def tier_work(before, after, kernel: str) -> list:
    """Per replica, ``kernel``'s launches and the forward batches between
    two stats snapshots (the children's counts from the first)."""
    return [(a["kernel_launches"][kernel] - b["kernel_launches"][kernel],
             a["forward_batches"] - b["forward_batches"])
            for b, a in zip(before, after)]


def drive_tier(clients, graphs, n_threads: int) -> tuple:
    """``n_threads`` threads ask the tier for ``graphs``, one graph a
    request: thread k on ``clients[k % len(clients)]``, its share of the
    graphs twice (the second pass repeats, from the client's LRU).
    Returns ({head: values in graph order}, latencies in s, wall s)."""
    import numpy as np
    per = len(graphs) // n_threads
    rows, lat, errors = {}, [], []
    lock = threading.Lock()

    def client(k: int) -> None:
        mine = range(per * k, per * k + per)
        try:
            for i in [*mine, *mine]:
                ts = time.perf_counter()
                out = clients[k % len(clients)].predict_all([graphs[i]])
                dt = time.perf_counter() - ts
                with lock:
                    rows[i] = out
                    lat.append(dt)
        except Exception as e:                     # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "replicated: client threads ended")
    check(not errors, f"replicated: client errors {errors[:3]}")
    check(len(rows) == per * n_threads, "replicated: every graph answered")
    heads = list(rows[0])
    return ({t: np.concatenate([rows[i][t] for i in range(len(rows))])
             for t in heads}, lat, wall)


def same_rows(a, b) -> bool:
    import numpy as np
    return set(a) == set(b) and all(np.array_equal(a[t], b[t]) for t in a)


def check_replicas(stats, name: str, what: str) -> None:
    """Every replica serves on the card named ``name`` and built no
    kernel library itself."""
    for s in stats:
        check(s["device"] == {"type": "cuda", "name": name},
              f"{what}: replica {s['replica_id']} on {s['device']}")
        check(s["nvcc_runs"] == 0,
              f"{what}: replica {s['replica_id']} ran nvcc "
              f"{s['nvcc_runs']} times")


def thread_fleet(svc, pool, n_workers: int, rounds: int) -> tuple:
    """The reference bench's thread-fleet baseline: ``n_workers`` threads
    search ``pool`` through one ``CostModelServer`` over ``svc``, with
    incremental hashing off. Returns (wall s, candidates costed)."""
    from repro_torch.core.server import CostModelServer
    from repro_torch.ir import graph as IRG
    from repro_torch.opt import search as SE
    prev = IRG.set_incremental_hashing(False)
    server = CostModelServer(svc, max_batch=svc.max_batch, flush_us=150)
    server.start(warmup=False)
    try:
        cands, errors = [], []

        def worker(w: int) -> None:
            try:
                for _ in range(rounds):
                    cands.append(sum(r.evaluated + 1 for r in
                                     SE.search_pool(server, pool, offset=w,
                                                    **FLEET_SEARCH)))
            except Exception as e:                 # surfaced below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(n_workers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not errors, f"replicated: thread fleet errors {errors[:3]}")
        return wall, sum(cands)
    finally:
        server.stop()
        IRG.set_incremental_hashing(prev)


def phase_replicated(card: str) -> dict:
    """The replicated serving tier on the card (module docstring, item
    10): a 4-replica conv1d tier through K1 with its fleet, a 2-replica
    LSTM tier through K2, and the chaos plan on 2 K1 replicas under a
    supervisor."""
    import numpy as np
    import torch
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import models as CM
    from repro_torch.core.service import CostModelService
    from repro_torch.ir import samplers
    from repro_torch.obs import (MetricsRegistry, Tracer, assemble,
                                 completeness, register_router,
                                 register_supervisor)
    from repro_torch.opt import search as SE
    from repro_torch.serving import (FaultEvent, FaultPlan, FaultyTransport,
                                     FleetDriver, QueueTransport,
                                     ReplicaClient, ReplicaSupervisor,
                                     ServiceSpec, start_replicas)
    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    ds, stats, _ = serve_world()
    heads = CM.DEFAULT_HEADS
    rng = np.random.default_rng(2)
    graphs = [samplers.sample_graph(rng) for _ in range(REPL_GRAPHS)]
    fams = sorted(samplers.SAMPLERS)
    pool = [samplers.sample_graph(rng, fams[i % len(fams)])
            for i in range(FLEET_POOL)]

    def service(kind, params, **kw):
        return CostModelService(kind, COSTMODEL_BASE, params, ds.vocab,
                                stats, mode="ops", max_seq=256,
                                max_batch=64, use_kernel=True, **kw)

    def free_mib() -> float:
        torch.cuda.synchronize()
        return torch.cuda.mem_get_info()[0] / 2 ** 20

    # 1. the conv1d tier through K1: 4 replicas, clients 0-3 for the
    # fleet's workers, 4-6 for the load, 7 traced, 8 without its LRU
    conv_params = seeded_params(COSTMODEL_BASE, heads, 0)
    conv = service("conv1d", conv_params)
    direct = conv.predict_all(graphs)
    spec = ServiceSpec.from_service(conv)
    check(spec.device == "cuda" and spec.use_kernel,
          f"replicated: spec on {spec.device}, use_kernel "
          f"{spec.use_kernel}")
    free0 = free_mib()
    t0 = time.perf_counter()
    tier = start_replicas(spec, 4, n_clients=9, flush_us=300.0,
                          start_timeout_s=120.0, obs_trace=True)
    start_s = time.perf_counter() - t0
    free1 = free_mib()
    try:
        clients = [ReplicaClient(tier.client_handle(c)) for c in (4, 5, 6)]
        check(all(c.fsvc.device == "cpu" for c in clients),
              "replicated: the router's featurizer is on the CPU")
        before = tier_stats(clients[0])
        check_replicas(before, name, "replicated k1")
        got, lat, wall = drive_tier(clients, graphs, REPL_THREADS)
        after = tier_stats(clients[0])
        work = tier_work(before, after, "conv_forward_fused")
        check(all(n_l == n_b for n_l, n_b in work),
              f"replicated k1: launches == forward batches a replica, "
              f"got {work}")
        serving = sum(n_b > 0 for _, n_b in work)
        check(serving >= 3, f"replicated k1: {serving} of 4 replicas "
              f"served a batch")
        identical = same_rows(got, direct)
        check(identical, "replicated k1: tier rows bit-identical to a "
              "direct K1 predict_all")
        check(all(c.fsvc.forward_batches == 0 for c in clients),
              "replicated k1: a featurizer ran a forward")
        lat_ms = np.asarray(lat) * 1e3
        emit({"phase": "replicated", "case": "k1_tier", "replicas": 4,
              "requests": len(lat), "requests_per_s": len(lat) / wall,
              "p50_ms": float(np.percentile(lat_ms, 50)),
              "p99_ms": float(np.percentile(lat_ms, 99)),
              "launches_batches": work, "replicas_serving": serving,
              "identical_to_direct": identical, "start_s": start_s,
              "free_mib_before": free0, "free_mib_ready": free1,
              "mib_per_replica": (free0 - free1) / 4, "card": card})

        # the shared tier: replica LRUs cleared, a client without its
        # own LRU is answered from the shared cache, with no forward
        clients[0].clear_caches(remote=True)
        nolru = ReplicaClient(tier.client_handle(8), local_cache=False)
        s0 = tier_stats(nolru)
        again = nolru.predict_all(graphs)
        s1 = tier_stats(nolru)
        shared = sum(a["shared_hits"] - b["shared_hits"]
                     for b, a in zip(s0, s1))
        fwd = sum(n_b for _, n_b in tier_work(s0, s1, "conv_forward_fused"))
        n_keys = len({g.struct_key() for g in graphs})
        check(shared == n_keys and fwd == 0,
              f"replicated k1: {shared} shared-cache hits for {n_keys} "
              f"keys, {fwd} forward batches")
        check(same_rows(again, direct),
              "replicated k1: shared-cache rows bit-identical")

        # traces across processes: a cold pass (forward spans) and a
        # warm pass (replica-LRU hits)
        tracer = Tracer(sample_every=1, proc="client")
        traced = ReplicaClient(tier.client_handle(7), local_cache=False,
                               tracer=tracer)
        fresh = [samplers.sample_graph(rng) for _ in range(24)]
        for g in [*fresh, *fresh[:8]]:
            traced.predict_all([g])
        trees = assemble(tracer.recorder.snapshot())
        comp = completeness(trees)
        with_replica = sum(any(p.startswith("replica-") for p in t.procs)
                           for t in trees.values())
        check(len(trees) == 32 and comp >= 0.99 and with_replica == 32,
              f"replicated k1: {len(trees)} traces, completeness {comp}, "
              f"{with_replica} with replica spans")
        emit({"phase": "replicated", "case": "k1_shared_and_traces",
              "shared_hits": shared, "keys": n_keys, "traces": len(trees),
              "completeness": comp, "card": card})

        # 2. the fleet: 4 spawned search workers over the tier, held to
        # search_pool over the direct K1 service
        want = {r.root.struct_key(): (r.best.struct_key(), r.best_score)
                for r in SE.search_pool(conv, pool, **FLEET_SEARCH)}
        t1 = time.perf_counter()
        drv = FleetDriver.start(tier, pool, FLEET_WORKERS,
                                search_kw=FLEET_SEARCH,
                                start_timeout_s=120.0)
        fleet_start_s = time.perf_counter() - t1
        try:
            warm = drv.run_pass()
            drv.clear()
            tier.shared_cache.clear()
            cold = drv.run_pass()
            steady = max((drv.run_pass(rounds=2) for _ in range(2)),
                         key=lambda p: p["candidates"] / p["wall_s"])
            wstats = drv.stats()
        finally:
            drv.stop()
        same_best = all(b == want for p in (warm, cold, steady)
                        for b in p["best"])
        check(same_best, "replicated fleet: a worker's best graph or cost "
              "differs from the direct search's")
        worker_cuda = [w["cuda_initialized"] for w in wstats]
        check(not any(worker_cuda),
              f"replicated fleet: workers initialised CUDA {worker_cuda}")
        end = tier_stats(clients[0])
        check_replicas(end, name, "replicated k1")
        work = tier_work(before, end, "conv_forward_fused")
        check(all(n_l == n_b for n_l, n_b in work),
              f"replicated k1 + fleet: launches == forward batches a "
              f"replica, got {work}")
        k1_launches = sum(n_l for n_l, _ in work)
    finally:
        tier.stop()
    base = service("conv1d", conv_params, fast_encode=False)
    base.warmup()
    thread_fleet(base, pool, FLEET_WORKERS, 1)          # warm, untimed
    with base._cache_lock:
        base._cache.clear()
        base._ids_cache.clear()
    base_cold = thread_fleet(base, pool, FLEET_WORKERS, 1)
    base_steady = max((thread_fleet(base, pool, FLEET_WORKERS, 2)
                       for _ in range(2)), key=lambda p: p[1] / p[0])
    cps = steady["candidates"] / steady["wall_s"]
    base_cps = base_steady[1] / base_steady[0]
    emit({"phase": "replicated", "case": "fleet", "workers": FLEET_WORKERS,
          "pool": FLEET_POOL, **FLEET_SEARCH, "same_best_as_direct":
          same_best, "worker_cuda_initialized": worker_cuda,
          "start_s": fleet_start_s,
          "cold_candidates_per_s": cold["candidates"] / cold["wall_s"],
          "steady_candidates_per_s": cps,
          "thread_fleet_cold_candidates_per_s": base_cold[1] / base_cold[0],
          "thread_fleet_steady_candidates_per_s": base_cps,
          "thread_fleet": "the reference bench's baseline: threads through "
                          "one K1 server, fast_encode and incremental "
                          "hashing off",
          "steady_vs_thread_fleet": cps / base_cps,
          "k1_launches": k1_launches, "card": card})

    # 3. the LSTM tier through K2's ids entry
    lstm = service("lstm", seeded_lstm_params(COSTMODEL_BASE, heads, 0))
    lgraphs = graphs[:REPL_GRAPHS // 2]
    ldirect = lstm.predict_all(lgraphs)
    free2 = free_mib()
    ltier = start_replicas(ServiceSpec.from_service(lstm), 2, n_clients=1,
                           flush_us=300.0, start_timeout_s=120.0)
    free3 = free_mib()
    try:
        lc = ReplicaClient(ltier.client_handle(0))
        lb = tier_stats(lc)
        check_replicas(lb, name, "replicated k2")
        lgot, llat, lwall = drive_tier([lc], lgraphs, REPL_THREADS)
        la = tier_stats(lc)
    finally:
        ltier.stop()
    lwork = tier_work(lb, la, "lstm_scan_ids")
    check(all(n_l == n_b for n_l, n_b in lwork) and
          sum(n_b for _, n_b in lwork) > 0,
          f"replicated k2: ids-entry launches == forward batches a "
          f"replica, got {lwork}")
    check(all(s["kernel_launches"]["lstm_scan_fused"] == 0 for s in la),
          "replicated k2: a replica launched the xw entry")
    lidentical = same_rows(lgot, ldirect)
    check(lidentical,
          "replicated k2: tier rows bit-identical to a direct K2 service")
    k2_launches = sum(n_l for n_l, _ in lwork)
    emit({"phase": "replicated", "case": "k2_tier", "replicas": 2,
          "requests": len(llat), "requests_per_s": len(llat) / lwall,
          "launches_batches": lwork, "identical_to_direct": lidentical,
          "free_mib_before": free2, "free_mib_ready": free3,
          "mib_per_replica": (free2 - free3) / 2, "card": card})

    # 4. chaos: the reference bench's fault plan on 2 supervised K1
    # replicas; round 0 is the fault-free reference
    crng = np.random.default_rng(0)
    cgraphs = [samplers.sample_graph(crng) for _ in range(24)]
    u = len({g.struct_key() for g in cgraphs})
    plan = FaultPlan(seed=0, events=[
        FaultEvent(at=u, kind="corrupt", key=cgraphs[0].struct_key()),
        FaultEvent(at=u + 1, kind="corrupt", key=cgraphs[1].struct_key()),
        FaultEvent(at=2 * u, kind="kill", replica=0),
        FaultEvent(at=12 * u, kind="wedge", replica=1),
        FaultEvent(at=20 * u, kind="drop", replica=0, count=3),
        FaultEvent(at=20 * u + 1, kind="delay", replica=1, count=2,
                   delay_s=0.05),
        FaultEvent(at=20 * u + 2, kind="dup", replica=0, count=2),
        FaultEvent(at=40 * u, kind="unwedge", replica=1)])
    cwant = conv.predict_all(cgraphs)
    ctier = start_replicas(spec, 2, n_clients=2, flush_us=300.0,
                           start_timeout_s=120.0)
    pids0 = [p.pid for p in ctier.procs]
    reg = MetricsRegistry()
    rounds = []
    try:
        sup = ReplicaSupervisor(ctier, heartbeat_s=0.25,
                                heartbeat_timeout_s=3.0,
                                restart_backoff_s=0.05,
                                start_timeout_s=120.0).start()
        try:
            handle = ctier.client_handle(0)
            ft = FaultyTransport(QueueTransport(handle), plan, tier=ctier)
            client = ReplicaClient(handle, transport=ft, local_cache=False,
                                   timeout_s=1.0, deadline_s=3.0,
                                   cooldown_s=0.05, oracle_fallback=True,
                                   jitter_seed=0)
            register_supervisor(reg, sup)
            register_router(reg, client)
            ref = None

            def one_round():
                d0 = client.degraded_count
                t0 = time.perf_counter()
                try:
                    got, err = client.predict_all(cgraphs), None
                except Exception as e:
                    got, err = None, repr(e)
                rec = {"wall_s": time.perf_counter() - t0,
                       "ok": err is None,
                       "degraded": client.degraded_count - d0,
                       "error": err}
                if got is not None and ref is not None \
                        and rec["degraded"] == 0:
                    rec["bit_equal"] = same_rows(got, ref)
                rounds.append(rec)
                return got

            ref = one_round()
            check(ref is not None and same_rows(ref, cwant),
                  f"replicated chaos: the fault-free round equals a direct "
                  f"K1 predict_all ({rounds[0]['error']})")
            stop_at = time.monotonic() + 120.0
            while time.monotonic() < stop_at:
                one_round()
                time.sleep(0.02)      # the op clock must not outrun the
                st = sup.stats()      # heartbeat's wall clock
                if len(rounds) >= 60 and plan.exhausted \
                        and st["restarts_recovered"] >= 2 \
                        and not st["respawning"]:
                    break
            final_clean = False
            for _ in range(10):
                one_round()
                r = rounds[-1]
                if r["ok"] and r["degraded"] == 0 and r.get("bit_equal"):
                    final_clean = True
                    break
                time.sleep(0.5)
            st = sup.stats()
            snap = reg.snapshot()["metrics"]
            router = client.stats()
            cstats = tier_stats(ReplicaClient(ctier.client_handle(1)))
            pids1 = [p.pid for p in ctier.procs]
        finally:
            sup.stop()
    finally:
        ctier.stop()
    avail = sum(r["ok"] for r in rounds) / len(rounds)
    nd = [r for r in rounds if r.get("bit_equal") is not None]
    diverged = sum(not r["bit_equal"] for r in nd)
    applied = {}
    for e in ft.log:
        if e["applied"]:
            applied[e["kind"]] = applied.get(e["kind"], 0) + 1
    recovered = [r["recovered_in_s"] for r in st["restart_log"]
                 if "recovered_in_s" in r]
    check(avail >= 0.99, f"replicated chaos: availability {avail}")
    check(diverged == 0, f"replicated chaos: {diverged} of {len(nd)} "
          f"non-degraded rounds diverged")
    check(applied.get("kill", 0) >= 1 and applied.get("wedge", 0) >= 1
          and plan.exhausted, f"replicated chaos: faults applied "
          f"{applied}, plan exhausted {plan.exhausted}; fault log "
          f"{ft.log}; restarts {st['restart_log']}")
    check(st["restarts_recovered"] >= 2,
          f"replicated chaos: {st['restarts_recovered']} recoveries")
    check(st["recovery_s_max"] <= CHAOS_RECOVERY_S,
          f"replicated chaos: recovery took {st['recovery_s_max']} s")
    check(final_clean, "replicated chaos: no clean round after the plan")
    check("supervisor.restarts_total" in snap
          and "router.degraded_count" in snap,
          "replicated chaos: counters missing from the registry snapshot")
    check(all(a != b for a, b in zip(pids0, pids1)),
          f"replicated chaos: slots not respawned ({pids0} -> {pids1})")
    check_replicas(cstats, name, "replicated chaos (respawned)")
    emit({"phase": "replicated", "case": "chaos", "rounds": len(rounds),
          "availability": avail, "non_degraded_rounds": len(nd),
          "degraded_rounds": sum(r["degraded"] > 0 for r in rounds),
          "diverged": diverged, "final_clean": final_clean,
          "plan_exhausted": plan.exhausted, "faults_applied": applied,
          "restarts_total": st["restarts_total"],
          "restarts_recovered": st["restarts_recovered"],
          "recovery_s": recovered, "recovery_s_max": st["recovery_s_max"],
          "respawned_nvcc_runs": [s["nvcc_runs"] for s in cstats],
          "router": {k: router[k] for k in
                     ("shed_count", "degraded_count", "deadline_expired",
                      "recv_errors", "failures", "unhealthy_now")},
          "mean_round_s": float(np.mean([r["wall_s"] for r in rounds])),
          "card": card})
    out = {"phase": "replicated", "case": "path",
           "k1_launches": k1_launches, "k2_launches": k2_launches,
           "phase_seconds": time.perf_counter() - t_phase, "card": card}
    emit(out)
    return out


# families phase: the FC and transformer families at COSTMODEL_BASE
# widths; the embedding x20 so outputs reach a few tenths
FAMILY_EMB_SCALE = 20.0
FAMILY_STEPS = 100


def seeded_family_params(kind: str, cfg, heads, seed: int):
    """``fc_init``'s or ``xformer_init``'s shapes and scales from a seed,
    the embedding scaled by FAMILY_EMB_SCALE, and what the inits leave
    0, 1 or small drawn: every bias N(0, 0.1), the position table
    N(0, 0.1), the LayerNorm gains 1 + N(0, 0.1)."""
    import torch
    from repro_torch.core import models as CM
    g = torch.Generator().manual_seed(seed)
    p = CM.get_model(kind)[0](cfg, heads, generator=g)
    p["emb"] = p["emb"] * FAMILY_EMB_SCALE
    for lyr in [*p.get("fc", []), *p.get("heads", {}).values(),
                *([p["head"]] if "head" in p else [])]:
        lyr["b"] = torch.randn(lyr["b"].shape, generator=g) * 0.1
    if "pos" in p:
        p["pos"] = torch.randn(p["pos"].shape, generator=g) * 0.1
    for blk in p.get("blocks", []):
        for k in ("ln1", "ln2"):
            blk[k] = 1.0 + torch.randn(blk[k].shape, generator=g) * 0.1
    return p


def head_columns(out, heads):
    """A model's output as a (B, n_heads) float32 numpy array."""
    import torch
    cols = [out[t] for t in heads] if heads else [out]
    return torch.stack([c.float() for c in cols], 1).cpu().numpy()


def family_forward(kind: str) -> dict:
    """The plain card forward against the CPU's with torch's default
    precision switches, bf16 against f32 params, and the card's time a
    forward at B=64, S=256."""
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import models as CM
    apply = CM.get_model(kind)[1]
    rng = np.random.default_rng(30)
    err, cases = 0.0, 0
    torch.backends.cudnn.allow_tf32 = True      # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for heads in (None, CM.DEFAULT_HEADS):
            p = seeded_family_params(kind, COSTMODEL_BASE, heads, 1)
            p_cpu, p_card = P.from_numpy(p, "cpu"), P.from_numpy(p, "cuda")
            for S in (32, 256):
                for B in (1, 5, 64):
                    ids = mixed_ids(rng, B, S, COSTMODEL_BASE.vocab_size)
                    with torch.inference_mode():
                        got = head_columns(apply(
                            p_card, torch.from_numpy(ids).cuda()), heads)
                        want = head_columns(apply(
                            p_cpu, torch.from_numpy(ids)), heads)
                    check(bool(np.isfinite(got).all()),
                          f"{kind}: card rows finite (B={B}, S={S}, "
                          f"all-PAD row {B > 1})")
                    err = max(err, float(np.abs(got - want).max()))
                    cases += 1
    finally:
        torch.backends.cudnn.allow_tf32 = False     # the f32 yardsticks
    check(err <= TOL, f"{kind}: card vs CPU err {err}")
    heads = CM.DEFAULT_HEADS
    p = seeded_family_params(kind, COSTMODEL_BASE, heads, 2)
    p32 = P.from_numpy(p, "cuda")
    p16 = P.from_numpy(p, "cuda", torch.bfloat16)
    ids = torch.from_numpy(long_ids(rng, 64, 256,
                                    COSTMODEL_BASE.vocab_size)).cuda()
    with torch.inference_mode():
        a, b = apply(p32, ids), apply(p16, ids)
        check(all(b[t].dtype == torch.bfloat16 for t in heads),
              f"{kind}: bf16 params gave another output dtype")
        rho = min(spearman(a[t].cpu().numpy(), b[t].float().cpu().numpy())
                  for t in heads)
        check(rho >= SPEARMAN_MIN, f"{kind}: bf16 Spearman {rho}")
        ms, ms16 = time_pair(lambda: apply(p32, ids),
                             lambda: apply(p16, ids))
    return {"cases": cases, "max_abs_err_vs_cpu": err,
            "bf16_spearman_min": rho, "forward_ms": ms,
            "forward_ms_bf16": ms16, "shape": {"B": 64, "S": 256}}


def family_serve(kind: str, params, ds, stats, graphs) -> dict:
    """A plain card service behind a server, 256 requests from 8
    threads: rows within TOL of a direct plain forward, and equal to a
    service padding every row to max_seq within 1e-5."""
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import models as CM
    from repro_torch.core.server import CostModelServer
    from repro_torch.core.service import CostModelService

    def service(buckets=None):
        return CostModelService(kind, COSTMODEL_BASE, params, ds.vocab,
                                stats, mode="ops", max_seq=256,
                                max_batch=64, buckets=buckets)
    svc = service()
    server = CostModelServer(svc, max_batch=64, flush_us=2000)
    server.start(warmup=True)
    try:
        rows, lat, wall = drive_clients(server, graphs)
        snap = server.metrics_snapshot()
    finally:
        server.stop()
    check(len(rows) == len(graphs), f"{kind}: every graph answered")
    got = np.stack([rows[i] for i in range(len(graphs))])
    check(bool(np.isfinite(got).all()), f"{kind}: served rows finite")
    check(snap["cache_hits"] > 0, f"{kind}: LRU hits {snap['cache_hits']}")
    dev_p = P.from_numpy(params, "cuda")
    apply = CM.get_model(kind)[1]
    entries = [svc.entry(g) for g in graphs]
    by_len = {}
    for i, (_, ids) in enumerate(entries):
        by_len.setdefault(len(ids), []).append(i)
    err = 0.0
    with torch.inference_mode():
        for idx in by_len.values():
            ids = torch.from_numpy(np.stack([entries[i][1] for i in idx]))
            want = head_columns(apply(dev_p, ids.cuda()), svc.heads)
            err = max(err, float(np.abs(got[idx] - want).max()))
    check(err <= TOL, f"{kind}: served rows vs plain forward err {err}")
    padded = service(buckets=(256,))
    full = padded.predict_entries([padded.entry(g) for g in graphs])
    bucket_err = float(np.abs(got - full).max())
    check(bucket_err <= 1e-5, f"{kind}: bucketed rows vs max_seq-padded "
          f"rows err {bucket_err}")
    lat_ms = np.asarray(lat) * 1e3
    return {"requests": len(lat), "requests_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "batches": snap["batches"], "cache_hits": snap["cache_hits"],
            "buckets": len(by_len), "max_abs_err_vs_plain": err,
            "bucketed_vs_padded_err": bucket_err}


def family_train(kind: str, tr) -> dict:
    """FAMILY_STEPS steps at B=64 on the card: the loss below half its
    first value; the first 10 losses within TRAIN_LOSS_RTOL of the same
    engine on the CPU (stopped there by the supervisor's preemption);
    the card's ms a step after 10 steps."""
    import signal
    import numpy as np
    import torch
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import models as CM
    from repro_torch.core import trainer as TR
    kw = dict(steps=FAMILY_STEPS, batch_size=64, log_every=1)
    marks = {}

    def on_step(step, dt):
        if step == 10:
            torch.cuda.synchronize()
            marks["t"] = time.perf_counter()
        if step == FAMILY_STEPS:
            torch.cuda.synchronize()
            marks["end"] = time.perf_counter()
    card = TR.TrainEngine(kind, COSTMODEL_BASE, CM.DEFAULT_HEADS,
                          **kw).fit(tr, on_step=on_step)

    def preempt(step, dt):
        if step == 10:
            os.kill(os.getpid(), signal.SIGTERM)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        cpu = TR.TrainEngine(kind, COSTMODEL_BASE, CM.DEFAULT_HEADS,
                             device="cpu", install_sigterm=True,
                             **kw).fit(tr, on_step=preempt)
    finally:
        signal.signal(signal.SIGTERM, prev)
    first, last = card.history[0][1], card.history[-1][1]
    check(last < 0.5 * first, f"{kind}: loss {first} -> {last}: not "
          f"below half")
    card_l = np.array([v for _, v in card.history[:10]])
    cpu_l = np.array([v for _, v in cpu.history])
    check(len(cpu_l) == 10, f"{kind}: CPU run stopped after {len(cpu_l)}")
    loss_err = float(np.max(np.abs(card_l - cpu_l) / np.abs(cpu_l)))
    check(loss_err <= TRAIN_LOSS_RTOL, f"{kind}: card losses {loss_err} "
          f"off the CPU's (limit {TRAIN_LOSS_RTOL})")
    return {"steps": FAMILY_STEPS, "batch_size": 64, "first_loss": first,
            "last_loss": last, "card_vs_cpu_loss_rel_err": loss_err,
            "ms_per_step": (marks["end"] - marks["t"]) * 1e3
            / (FAMILY_STEPS - 10)}


def phase_families(card: str) -> dict:
    """The FC and transformer families on the card at COSTMODEL_BASE
    (see the module docstring)."""
    from repro_torch.core import models as CM
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    t_phase = time.perf_counter()
    ds, stats, graphs = serve_world()
    tr, _ = ds.split(0.1)
    out = {}
    for kind in ("fc", "xformer"):
        t0 = time.perf_counter()
        fwd = family_forward(kind)
        params = seeded_family_params(kind, COSTMODEL_BASE,
                                      CM.DEFAULT_HEADS, 3)
        served = family_serve(kind, params, ds, stats, graphs)
        trained = family_train(kind, tr)
        out[kind] = {"forward": fwd, "serve": served, "train": trained,
                     "seconds": time.perf_counter() - t0}
        emit({"phase": "families", "kind": kind, **out[kind],
              "card": card})
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit({"phase": "families", "case": "times",
          "forward_ms": {k: out[k]["forward"]["forward_ms"]
                         for k in ("fc", "xformer")},
          "train_ms_per_step": {k: out[k]["train"]["ms_per_step"]
                                for k in ("fc", "xformer")},
          "phase_seconds": out["phase_seconds"], "card": card})
    return out


# cli phase: the port's CLIs at small step counts
CLI_STEPS = 30
CLI_TRAIN = ["--preset", "base", "--target", "all", "--steps",
             str(CLI_STEPS), "--n-graphs", "300", "--save-every",
             str(CLI_STEPS)]


@contextlib.contextmanager
def tracked_services():
    """Every ``CostModelService`` made inside: the CLIs build theirs
    inside ``main``, and neither returns it."""
    from repro_torch.core.service import CostModelService
    made = []
    init = CostModelService.__post_init__

    def post_init(self):
        init(self)
        made.append(self)
    CostModelService.__post_init__ = post_init
    try:
        yield made
    finally:
        CostModelService.__post_init__ = init


def run_cli(main, argv):
    """``main(argv)`` with its standard output captured and K1's counter
    set to 0 just before. Returns its value, text and seconds, K1's
    launches in the call, the launches owed (each card service with
    ``use_kernel`` launches once a warm-up shape and once a forward
    batch) and those services."""
    import io
    from types import SimpleNamespace
    from repro_torch.kernels import conv1d_stack as K
    buf = io.StringIO()
    with tracked_services() as made, contextlib.redirect_stdout(buf):
        K.conv_forward_fused.launches = 0
        t0 = time.perf_counter()
        out = main(argv)
        secs = time.perf_counter() - t0
        launches = K.conv_forward_fused.launches
    k1 = [s for s in made if s.use_kernel and s.device != "cpu"]
    return SimpleNamespace(
        out=out, text=buf.getvalue(), seconds=secs, launches=launches,
        owed=sum(s.warmup_shapes + s.forward_batches for s in k1),
        k1_services=k1)


def served_vs_plain(svc, seed: int, texts=()) -> dict:
    """The rows a K1 card service served (its LRU, with the bucket-padded
    ids of its ids cache, and of ``texts`` it served through
    ``predict_text``, featurized again), and a ragged batch of each of
    its buckets through it, against a plain card service built from the
    same params, vocabulary and stats on the same ids; within TOL."""
    import numpy as np
    from repro_torch.ir import frontdoor as FD
    from repro_torch.serving import ServiceSpec
    plain = ServiceSpec.from_service(svc).build(use_kernel=False)
    with svc._cache_lock:
        ids_of = {k: v[0] for k, v in svc._ids_cache.items()}
    for text in texts:
        ent = svc.ingest_text(text)
        if not isinstance(ent, FD.IngestError):
            ids_of[ent.key] = ent.ids
    served = [(k, ids_of[k], row) for k, row in svc.export_cache()
              if k in ids_of]
    n_served = len(served)
    rng = np.random.default_rng(seed)
    for S in svc.buckets:
        ids = ragged_ids(rng, 5, S, svc.cfg.vocab_size)
        ids[1] = long_ids(rng, 1, S, svc.cfg.vocab_size)[0]
        keys = [f"ragged:{S}:{i}" for i in range(len(ids))]
        rows = svc.forward_entries(list(zip(keys, ids)))
        served += list(zip(keys, ids, rows))
    by_bucket = {}
    for key, ids, row in served:
        by_bucket.setdefault(len(ids), []).append((key, ids, row))
    err = 0.0
    for group in by_bucket.values():
        want = plain.forward_entries([(k, i) for k, i, _ in group])
        got = np.stack([r for _, _, r in group])
        err = max(err, float(np.abs(got - want).max()))
    check(n_served > 0, "no served row of a CLI's K1 service to compare")
    check(set(by_bucket) == set(svc.buckets),
          f"compared buckets {sorted(by_bucket)} of {svc.buckets}")
    check(err <= TOL, f"K1 rows of a CLI's service vs plain: err {err}")
    return {"served_rows": n_served, "max_abs_err": err,
            "rows_by_bucket": {S: len(g) for S, g in
                               sorted(by_bucket.items())}}


def rel_close(a: dict, b: dict, rtol: float) -> float:
    """Largest relative gap of two {head: {metric: value}} trees; raises
    past ``rtol``."""
    worst = 0.0
    for t in b:
        for k, v in b[t].items():
            gap = abs(a[t][k] - v) / max(abs(v), 1e-9)
            worst = max(worst, gap)
    check(worst <= rtol, f"metrics {worst} apart (limit {rtol})")
    return worst


def phase_cli(card: str) -> dict:
    """The port's CLIs on the card, called as ``main(argv)`` (see the
    module docstring)."""
    import signal
    import tempfile
    import numpy as np
    from repro_torch.launch import obs as OBS
    from repro_torch.launch import optimize, serve, train
    from repro_torch.obs import assemble, completeness
    t_phase = time.perf_counter()
    prev = signal.getsignal(signal.SIGTERM)   # the train CLI sets one
    out = {"train": {}}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "ds.npz")
            for model in ("conv1d", "fc", "lstm", "xformer"):
                args = [*CLI_TRAIN, "--model", model, "--dataset", data,
                        "--ckpt-dir", os.path.join(tmp, model)]
                run = run_cli(train.main, args)
                card_m = run.out
                check(f"trained {CLI_STEPS} steps" in run.text,
                      f"cli train {model}: {run.text[-300:]}")
                again = run_cli(train.main, args)
                check("run already complete" in again.text,
                      f"cli train {model} resumed: {again.text[-300:]}")
                cpu = run_cli(train.main,
                              [*args, "--eval-only", "--device", "cpu"])
                check(all(np.isfinite(v) for m in card_m.values()
                          for v in m.values()), f"{model}: metrics finite")
                out["train"][model] = {
                    "seconds": run.seconds,
                    "eval_only_cpu_seconds": cpu.seconds,
                    "resumed_vs_trained_rel": rel_close(again.out, card_m,
                                                        1e-5),
                    "cpu_vs_card_rel": rel_close(cpu.out, card_m, 1e-3),
                    "rmse_norm": {t: m["rmse_norm"]
                                  for t, m in card_m.items()}}
            emit({"phase": "cli", "case": "train", **out["train"],
                  "card": card})

            run = run_cli(serve.main, [
                "--kernel", "--requests", "256", "--train-steps", "50",
                "--n-graphs", "300"])
            snap = run.out
            check(run.launches > 0 and run.launches == run.owed,
                  f"cli serve: {run.launches} K1 launches, {run.owed} "
                  f"warm-up shapes and forward batches")
            check("recompile advisor:" in run.text and snap["shed"] == 0,
                  f"cli serve: {run.text[-300:]}")
            check(len(run.k1_services) == 1, f"cli serve: "
                  f"{len(run.k1_services)} K1 services")
            out["serve"] = {"seconds": run.seconds,
                            "launches": run.launches,
                            "batches": snap["batches"],
                            "cache_hits": snap["cache_hits"],
                            "p50_ms": snap["latency_p50_us"] / 1e3,
                            "p99_ms": snap["latency_p99_us"] / 1e3,
                            "vs_plain": served_vs_plain(
                                run.k1_services[0], 40)}
            emit({"phase": "cli", "case": "serve", **out["serve"]})

            jsonl = os.path.join(tmp, "obs.jsonl")
            run = run_cli(serve.main, [
                "--kernel", "--replicas", "2", "--supervise", "--obs",
                "--obs-sample", "1", "--obs-jsonl", jsonl,
                "--requests", "128", "--train-steps", "20",
                "--n-graphs", "300"])
            stats = run.out
            check(len(stats) == 2 and all(
                s["device"]["type"] == "cuda" and s["nvcc_runs"] == 0
                and s["forward_batches"] > 0 and s["warmup_shapes"] > 0
                and s["kernel_launches"]["conv_forward_fused"]
                == s["warmup_shapes"] + s["forward_batches"]
                for s in stats), f"cli replicas: {stats}")
            check("supervisor: active=2" in run.text, f"cli replicas: "
                  f"{run.text[-300:]}")
            report = run_cli(OBS.main, ["report", jsonl])
            spans, _ = OBS.read_records(jsonl)
            trees = assemble(spans)
            check(report.out == 0 and trees and all(
                t.complete for t in trees.values())
                and completeness(trees) == 1.0
                and "INCOMPLETE" not in report.text,
                f"cli obs report: {report.text[:300]}")
            out["replicated"] = {
                "seconds": run.seconds, "traces": len(trees),
                "spans": len(spans),
                "replica_forward_batches": [s["forward_batches"]
                                            for s in stats],
                "replica_warmup_shapes": [s["warmup_shapes"]
                                          for s in stats],
                "replica_k1_launches": [
                    s["kernel_launches"]["conv_forward_fused"]
                    for s in stats]}
            emit({"phase": "cli", "case": "replicated",
                  **out["replicated"]})

            run = run_cli(optimize.main, [
                "--kernel", "--eval-graphs", "8", "--n-graphs", "300",
                "--train-steps", "50"])
            s = run.out["summary"]
            check(run.launches > 0 and run.launches == run.owed,
                  f"cli optimize: {run.launches} K1 launches, {run.owed} "
                  f"warm-up shapes and forward batches")
            check(s["n_graphs"] == 8 and np.isfinite(
                s["oracle_improvement_mean"]), f"cli optimize: {s}")
            check(len(run.k1_services) == 1, f"cli optimize: "
                  f"{len(run.k1_services)} K1 services")
            out["optimize"] = {"seconds": run.seconds,
                               "launches": run.launches,
                               "predict_calls": s["predict_calls"],
                               "candidates_costed":
                               s["candidates_costed"],
                               "oracle_improvement_mean":
                               s["oracle_improvement_mean"],
                               "vs_plain": served_vs_plain(
                                   run.k1_services[0], 41)}
            emit({"phase": "cli", "case": "optimize", **out["optimize"]})
    finally:
        signal.signal(signal.SIGTERM, prev)
    out["launches"] = out["serve"]["launches"] + \
        out["optimize"]["launches"]
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit({"phase": "cli", "case": "path", "launches": out["launches"],
          "phase_seconds": out["phase_seconds"], "card": card})
    return out


# ingest phase: the ingest CLI over the port's own lowering
INGEST_FUZZ = 200
INGEST_RTOL = 1e-3      # denormalized predictions, card vs CPU


def pair_rel(rows_a, rows_b) -> float:
    """Largest relative gap between two runs' predictions of the same
    texts; every row of both must be a prediction."""
    from repro_torch.ir import frontdoor as FD
    worst = 0.0
    for (_, _, ta, a), (_, _, tb, b) in zip(rows_a, rows_b, strict=True):
        check(ta == tb and isinstance(a, FD.TextPrediction)
              and isinstance(b, FD.TextPrediction), f"ingest: {a}, {b}")
        for t, v in a.predictions.items():
            worst = max(worst, abs(b.predictions[t] - v)
                        / max(abs(v), 1e-9))
    return worst


def phase_ingest(card: str) -> dict:
    """The StableHLO lowering and the ingest CLI on the card (see the
    module docstring)."""
    import numpy as np
    import torch
    from repro_torch.ir import frontdoor as FD
    from repro_torch.ir import stablehlo as SH
    from repro_torch.launch import ingest
    from repro_torch.serving import ServiceSpec
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    corpus = SH.lower_arch_corpus(None)
    lower_s = time.perf_counter() - t0
    n_ops = [getattr(FD.ingest(t), "n_ops", 0) for _, _, t in corpus]
    check(len(corpus) == 43 and min(n_ops) > 0,
          f"ingest: {len(corpus)} lowered texts, n_ops {n_ops}")

    args = ["--arch", "all", "--fuzz", str(INGEST_FUZZ)]
    run = run_cli(ingest.main, [*args, "--kernel"])
    rows, fuzz = run.out["arch_rows"], run.out["fuzz"]
    check([t for _, _, t, _ in rows] == [t for _, _, t in corpus],
          "ingest: the CLI lowered other texts than lower_arch_corpus")
    check(all(isinstance(r, FD.TextPrediction) for *_, r in rows),
          f"ingest: {[r for *_, r in rows if isinstance(r, FD.IngestError)]}")
    unk_max = max(r.unk_rate for *_, r in rows)
    check(unk_max == 0.0, f"ingest: unk_rate_max {unk_max}")
    check(fuzz["inputs"] == INGEST_FUZZ and fuzz["uncaught"] == 0,
          f"ingest fuzz: {fuzz}")
    check(len(run.k1_services) == 1, f"ingest: {len(run.k1_services)} "
          f"K1 services")
    check(run.launches > 0 and run.launches == run.owed,
          f"ingest: {run.launches} K1 launches, {run.owed} warm-up "
          f"shapes and forward batches")
    svc = run.k1_services[0]
    warmup_shapes, forward_batches = svc.warmup_shapes, svc.forward_batches
    texts = [t for _, _, t in corpus]
    texts += FD.fuzz_corpus(texts, INGEST_FUZZ, np.random.default_rng(0))
    vs_plain = served_vs_plain(svc, 42, texts)

    # texts a second through predict_text: a fresh K1 service, cold LRU
    fresh = ServiceSpec.from_service(svc).build()
    fresh.warmup()
    t0 = time.perf_counter()
    for _, _, text in corpus:
        check(isinstance(fresh.predict_text(text), FD.TextPrediction),
              "ingest: a fresh K1 service's prediction")
    torch.cuda.synchronize()
    texts_per_s = len(corpus) / (time.perf_counter() - t0)

    # the card against the CPU on one model. Two trainings are two
    # models: AdamW steps a rounding-noise gradient either way, and two
    # devices sum in other orders, so 150 steps on each landed 9.8e-7
    # and 6.9e-3 apart in two runs. So the same CLI on each device with
    # the seeded untrained params, and the card-trained service's
    # params served by the CPU's plain path.
    pair = [run_cli(ingest.main, [*args, "--train-steps", "0", *extra])
            for extra in (["--kernel"], ["--device", "cpu"])]
    cpu_svc = ServiceSpec.from_service(svc).build(device="cpu",
                                                  use_kernel=False)
    gaps = {"cli": pair_rel(pair[0].out["arch_rows"],
                            pair[1].out["arch_rows"]),
            "trained": pair_rel(rows, [(a, lyr, t, cpu_svc.predict_text(t))
                                       for a, lyr, t, _ in rows])}
    check(pair[0].launches == pair[0].owed, f"ingest untrained: "
          f"{pair[0].launches} K1 launches, {pair[0].owed} owed")
    check(max(gaps.values()) <= INGEST_RTOL, f"ingest: CPU vs card "
          f"predictions {gaps} apart (limit {INGEST_RTOL})")
    out = {"phase": "ingest", "texts": len(corpus), "lower_s": lower_s,
           "texts_per_s": texts_per_s, "launches": run.launches,
           "warmup_shapes": warmup_shapes,
           "forward_batches": forward_batches, "fuzz": fuzz,
           "unk_rate_max": unk_max, "vs_plain": vs_plain,
           "cpu_vs_card_rel": gaps, "card_seconds": run.seconds,
           "cpu_seconds": pair[1].seconds,
           "phase_seconds": time.perf_counter() - t_phase, "card": card}
    emit(out)
    return out

# ------------------------------------------------------------- the LM phase
LM_ARCH = "qwen3-0.6b"
LM_TRAIN = (8, 512, 10)          # batch, sequence, steps
LM_DECODE = (2, 512, 32, 1024)   # batch, prompt, new tokens, cache max_seq
LM_CPU = (2, 64)                 # the card-vs-CPU forward's batch, sequence
LM_DECODE_STEPS = 8              # each reduced arch
# float32 logits, card vs CPU (and the decode path vs the forward on the
# card), as the largest difference over the largest |logit|: float32
# sums in other orders (cuBLAS against oneDNN) through up to 28 layers
# landed 6.3e-7 - 2.0e-6, TF32 matmuls 1.26e-4 (first chip run; 1e-4
# let TF32 miss by only 1.26x)
LM_REL = 1e-5


def lm_batch(cfg, seed: int, B: int, S: int) -> dict:
    """A reduced arch's numpy batch: tokens, labels and the frontend's
    stub embeddings, as the reference's arch tests make them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = (rng.normal(size=(
            B, cfg.vision_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        b["frame_embeds"] = (rng.normal(size=(
            B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def bf16_products_attention(q, k, v):
    """The attention route the port does not take, timed beside it: bf16
    products whose outputs round to bf16 (the reference asks for float32
    outputs of its bf16 products), one causal block, float32 softmax."""
    import torch
    S, D = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    w = torch.softmax(torch.where(mask, logits.float(), -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def out_dtype_attention(q, k, v):
    """The reference's products on the tensor cores: bf16 operands,
    float32 outputs (``torch.bmm(..., out_dtype=torch.float32)``), one
    causal block, float32 softmax; timed beside the port's route."""
    import torch
    B, S, H, D = q.shape

    def heads(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, S, D)
    logits = torch.bmm(heads(q), heads(k).transpose(1, 2),
                       out_dtype=torch.float32) * D ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    w = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    out = torch.bmm(w.to(v.dtype), heads(v), out_dtype=torch.float32)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3).to(q.dtype)


def profile_calls(fn, n: int) -> dict:
    """``fn`` called ``n`` times under the profiler: wall ms a call (the
    card synchronized at both ends), the card's kernel ms a call, the
    busy share, launches a call and the eight kernels with the most card
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_us, launches, top = kernel_times(prof, 8)
    return {"calls": n, "wall_ms": wall_s * 1e3 / n,
            "card_ms": busy_us / 1e3 / n,
            "card_busy_share": busy_us / 1e6 / wall_s,
            "launches": launches / n,
            "top_kernels_ms": {k[:70]: us / 1e3 / n for k, us in top}}


def phase_lm(card: str, device: str = "cuda", cfg=None) -> dict:
    """The LLM substrate on the card (see the module docstring);
    ``device`` and ``cfg`` exist to rehearse the phase on the CPU at a
    reduced width."""
    import multiprocessing
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.data import pipeline as PIPE
    from repro_torch.models import layers as TL
    from repro_torch.models import model as MODEL
    from repro_torch.models import steps as STEPS
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    f32 = torch.float32
    # what shares the host with this phase (its steps are host-bound):
    # threads and child processes left by earlier phases, and a fixed
    # Python loop's seconds, a yardstick of the host's speed (it spread
    # 0.096-0.189 s between calls, with the host-bound times)
    t0 = time.perf_counter()
    sum(i * i for i in range(2_000_000))
    host = {"threads": sorted(t.name for t in threading.enumerate()),
            "children": len(multiprocessing.active_children()),
            "python_loop_s": time.perf_counter() - t0}

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def on(b, d):
        return {k: torch.from_numpy(v).to(d) for k, v in b.items()}

    def rel(ref, got) -> float:
        return float((got.float() - ref.float()).abs().max()
                     / ref.float().abs().max())

    # full width: train LM_TRAIN steps at f32 master weights, bf16 compute
    cfg = cfg or get_arch(LM_ARCH)
    B, S, n_steps = LM_TRAIN
    with dev:
        params = MODEL.init_params(torch.Generator(dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in P.tree_flatten(params))
    step = STEPS.make_train_step(cfg, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=n_steps))
    state = adamw.init_state(params)
    data = PIPE.synthetic_lm_batches(cfg.vocab, B, S, seed=0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step_ms, metrics = [], []
    for _ in range(n_steps):
        batch = on(next(data), dev)
        (params, state, m), ms = timed(lambda: step(params, state, batch))
        step_ms.append(ms)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    train_profile = None
    if cuda:    # one more step on the last batch, profiled, not kept
        train_profile = profile_calls(lambda: step(params, state, batch), 1)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    check(bool(np.isfinite(losses + gnorms).all()),
          f"lm: losses {losses}, grad norms {gnorms}")
    check(losses[-1] < losses[0], f"lm: losses {losses} did not fall")
    check(all(bool(torch.isfinite(t).all()) for t in P.tree_flatten(params)),
          "lm: trained params not finite")
    del state, metrics
    ms_step = float(np.median(step_ms[1:]))

    # prefill and greedy decode, bf16 compute and KV cache
    Bd, n_prompt, n_new, max_seq = LM_DECODE
    prompt = torch.from_numpy(next(PIPE.synthetic_lm_batches(
        cfg.vocab, Bd, n_prompt, seed=1))["tokens"]).to(dev)
    prefill = STEPS.make_prefill_step(cfg)
    prefill(params, {"tokens": prompt})                       # warm-up
    last, prefill_ms = timed(lambda: prefill(params, {"tokens": prompt}))
    decode = STEPS.make_decode_step(cfg)
    cache = MODEL.init_cache(cfg, Bd, max_seq, device=dev)

    def feed():
        tok = None
        for i in range(n_prompt):
            tok, _ = decode(params, cache, prompt[:, i:i + 1], i)
        return tok

    def generate(tok):
        out = []
        for i in range(n_new):
            tok, _ = decode(params, cache, tok, n_prompt + i)
            out.append(tok)
        return torch.cat(out, dim=1)

    first, feed_ms = timed(feed)
    new, gen_ms = timed(lambda: generate(first))
    decode_profile = None
    if cuda:    # 8 more steps past the generated ones, profiled
        pos = iter(range(n_prompt + n_new, n_prompt + n_new + 8))
        decode_profile = profile_calls(
            lambda: decode(params, cache, new[:, -1:], next(pos)), 8)
    check(int(new.min()) >= 0 and int(new.max()) < cfg.vocab,
          f"lm: decoded tokens out of range {new.min()}..{new.max()}")
    check(all(bool(torch.isfinite(t.float()).all())
              for t in P.tree_flatten(cache)), "lm: KV cache not finite")
    bf16_agree = bool((first == STEPS.next_token(last, cfg.vocab)).all())
    del cache

    # prefill vs the decode path at float32, every prompt position: the
    # greedy tokens agree wherever the prefill's top-2 gap exceeds twice
    # the largest logit difference of the two paths (closer is a tie)
    with torch.no_grad():
        pre, _ = MODEL.forward(params, cfg, {"tokens": prompt}, cdt=f32,
                               remat=False)
    cache32 = MODEL.init_cache(cfg, Bd, max_seq, kv_dtype=f32, device=dev)

    def decode32():
        diffs, toks = [], []
        for i in range(n_prompt):
            lg, _ = MODEL.decode_forward(params, cfg, prompt[:, i:i + 1],
                                         cache32, i, cdt=f32)
            diffs.append((lg - pre[:, i]).abs().max())
            toks.append(STEPS.next_token(lg, cfg.vocab))
        return torch.stack(diffs).max(), torch.cat(toks, dim=1)

    (eps, dec_tok), dec32_ms = timed(decode32)
    del cache32
    pre_tok = STEPS.next_token(pre.flatten(0, 1), cfg.vocab).view(
        Bd, n_prompt)
    top2 = pre[..., :cfg.vocab].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * eps
    agree = dec_tok == pre_tok
    decode_rel = float(eps / pre.abs().max())
    del pre
    check(decode_rel <= LM_REL, f"lm: float32 decode vs prefill logits "
          f"{decode_rel:.3g} apart (limit {LM_REL})")
    check(bool(agree[~tie].all()), f"lm: float32 decode disagrees with "
          f"the prefill at {int((~agree & ~tie).sum())} positions")

    # the card against the CPU at float32, torch's default switches, and
    # the same forward with TF32 matmuls (the sensitivity case)
    cb = torch.from_numpy(next(PIPE.synthetic_lm_batches(
        cfg.vocab, *LM_CPU, seed=2))["tokens"])

    @torch.no_grad()
    def fwd32(p, tokens):
        return MODEL.forward(p, cfg, {"tokens": tokens}, cdt=f32,
                             remat=False)[0].cpu()

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False   # torch's defaults
        torch.backends.cudnn.allow_tf32 = True
        card_logits, card_fwd_ms = timed(lambda: fwd32(params, cb.to(dev)))
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_logits = fwd32(params, cb.to(dev))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    cpu_params = P.tree_map(lambda t: t.cpu(), params)
    cpu_logits, cpu_fwd_ms = timed(lambda: fwd32(cpu_params, cb))
    del cpu_params
    cpu_rel, tf32_rel = rel(cpu_logits, card_logits), rel(cpu_logits,
                                                         tf32_logits)
    check(cpu_rel <= LM_REL, f"lm: card vs CPU logits {cpu_rel:.3g} apart "
          f"(limit {LM_REL})")
    tf32_line = (f"TF32 misses the limit by {tf32_rel / LM_REL:.3g}x"
                 if tf32_rel > LM_REL else
                 "cannot tell TF32 from float32 at this limit")

    # the attention route's cost at the training shape (the card only)
    attention = None
    if cuda:
        H, D = cfg.n_heads, cfg.resolved_head_dim
        g = torch.Generator(dev).manual_seed(3)
        q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        route = TL.flash_attention(q, k, v, causal=True)

        def differ(other) -> float:
            """Share of the bf16 outputs not equal to the route's."""
            return float((other != route).float().mean())

        ms_route, ms_alt = time_pair(
            lambda: TL.flash_attention(q, k, v, causal=True),
            lambda: bf16_products_attention(q, k, v), n_samples=7, reps=3)
        attention = {
            "shape": [B, S, H, D], "float32_products_ms": ms_route,
            "bf16_products_ms": ms_alt,
            "bf16_products_differ": differ(bf16_products_attention(q, k,
                                                                   v))}
        try:
            ms_route2, ms_out = time_pair(
                lambda: TL.flash_attention(q, k, v, causal=True),
                lambda: out_dtype_attention(q, k, v), n_samples=7, reps=3)
            attention.update(
                float32_products_ms_2=ms_route2, out_dtype_ms=ms_out,
                out_dtype_differ=differ(out_dtype_attention(q, k, v)))
            qg = q.detach().requires_grad_()
            out_dtype_attention(qg, k, v).float().sum().backward()
            attention["out_dtype_backward"] = "ok"
        except (RuntimeError, TypeError) as e:
            # no out_dtype in this torch, or no derivative for it
            attention["out_dtype"] = f"{type(e).__name__}: {e}"[:200]

    del params

    # the ten archs, reduced: params through lm_from_numpy, forward (card
    # vs CPU at float32; bf16 finite), one train step, decode steps
    archs = {}
    for name in sorted(ARCHS):
        rcfg = get_arch(name).reduced()
        tree = P.to_numpy(MODEL.init_params(
            torch.Generator().manual_seed(0), rcfg))
        pd, pc = (P.lm_from_numpy(tree, rcfg, d) for d in (dev, "cpu"))
        b = lm_batch(rcfg, 0, 2, 16)
        with torch.no_grad():
            ld = MODEL.forward(pd, rcfg, on(b, dev), cdt=f32)[0]
            lc = MODEL.forward(pc, rcfg, on(b, "cpu"), cdt=f32)[0]
            l16, aux = MODEL.forward(pd, rcfg, on(b, dev))
        r = rel(lc, ld.cpu())
        check(r <= LM_REL, f"lm {name}: card vs CPU {r:.3g} (limit "
              f"{LM_REL})")
        check(bool(torch.isfinite(l16.float()).all())
              and bool(torch.isfinite(aux)), f"lm {name}: bf16 forward")
        p2, _, m = STEPS.make_train_step(rcfg, adamw.AdamWConfig(
            lr=1e-3, total_steps=5, warmup_steps=0))(
            pd, adamw.init_state(pd), on(b, dev))
        check(np.isfinite([float(m["loss"]), float(m["grad_norm"])]).all()
              and all(bool(torch.isfinite(t).all())
                      for t in P.tree_flatten(p2)), f"lm {name}: train step")
        cache = MODEL.init_cache(rcfg, 2, 16, device=dev)
        dstep = STEPS.make_decode_step(rcfg)
        tok = torch.ones((2, 1), dtype=torch.int32, device=dev)
        for i in range(LM_DECODE_STEPS):
            tok, _ = dstep(pd, cache, tok, i)
        check(0 <= int(tok.min()) and int(tok.max()) < rcfg.vocab
              and all(bool(torch.isfinite(t.float()).all())
                      for t in P.tree_flatten(cache)), f"lm {name}: decode")
        archs[name] = {"card_vs_cpu_rel": r, "loss": float(m["loss"])}

    out = {"phase": "lm", "arch": cfg.name, "params": n_params,
           "train": {"batch": B, "seq": S, "steps": n_steps,
                     "losses": losses, "grad_norms": gnorms,
                     "ms_per_step": ms_step, "step_ms": step_ms,
                     "tokens_per_s": B * S / ms_step * 1e3,
                     "peak_bytes": peak, "profile": train_profile},
           "decode": {"batch": Bd, "prompt": n_prompt, "new": n_new,
                      "max_seq": max_seq, "prefill_ms": prefill_ms,
                      "prompt_ms_per_token": feed_ms / n_prompt,
                      "ms_per_token": gen_ms / n_new,
                      "float32_ms_per_token": dec32_ms / n_prompt,
                      "profile": decode_profile,
                      "bf16_first_token_agrees": bf16_agree},
           "float32_decode_vs_prefill": {
               "rel": decode_rel, "limit": LM_REL,
               "positions": int(agree.numel()), "agree": int(agree.sum()),
               "ties": int(tie.sum())},
           "card_vs_cpu": {"rel": cpu_rel, "limit": LM_REL,
                           "tf32_rel": tf32_rel, "tf32": tf32_line,
                           "card_ms": card_fwd_ms, "cpu_ms": cpu_fwd_ms},
           "attention": attention, "reduced_archs": archs, "host": host,
           "kernels": "none: plain PyTorch (cuBLAS); the reference "
                      "reaches no TPU kernel on this path",
           "phase_seconds": time.perf_counter() - t_phase, "card": card}
    emit(out)
    return out


# the mesh phase
MESH_TRAIN = (8, 512)        # (a): a train step's batch and sequence
MESH_DECODE = (2, 8, 1024)   # (a): decode batch, steps, cache max_seq
MESH_REL = 1e-6              # (a): rules vs rules=None on a mesh of one
MESH_CONV_STEPS = 50         # (b): conv1d steps on 2 gloo CPU ranks
# (c): flops a rank over model flops a rank at train_4k: remat recomputes
# a forward (x4/3) and the flash attention computes every key block under
# a mask, twice model_flops_for's causal half (1.96 for qwen3-0.6b)
MESH_DRYRUN_RATIO = (1.0, 2.0)
MESH_DRYRUN_SHAPES = ("train_4k", "decode_32k")


def mesh_conv_fit(mesh, steps: int) -> dict:
    """conv1d at COSTMODEL_BASE with int8 gradient compression on the
    CPU, on ``mesh`` (inside a group of its size when above 1): the
    losses of every step, the params and norm stats."""
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core import trainer as TR
    from repro_torch.core.models import DEFAULT_HEADS
    ds, _, _ = serve_world()
    train, _ = ds.split(0.1)
    t0 = time.perf_counter()
    r = TR.TrainEngine("conv1d", COSTMODEL_BASE, DEFAULT_HEADS,
                       device="cpu", steps=steps, batch_size=64,
                       log_every=1, mesh_data=mesh[0], mesh_model=mesh[1],
                       compress_grads=True).fit(train)
    return {"losses": [loss for _, loss in r.history],
            "params": P.to_numpy(r.params), "norm_stats": r.norm_stats,
            "seconds": time.perf_counter() - t0}


def mesh_rank(rank: int, n: int, store: str, out: str, steps: int) -> None:
    """(b)'s child: one gloo rank on the CPU (the cores shared among the
    ranks), its group's store a file; rank 0 writes the result."""
    import pickle
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        res = mesh_conv_fit((n, 1), steps)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_mesh(card: str) -> dict:
    """The mesh tooling (see the module docstring): (a) the LM steps'
    ``rules`` paths on a one-rank NCCL mesh at full width, (b) the
    cost-model trainer on 2 gloo CPU ranks served through K1 on the
    card, (c) the dry run on a fake 16x16 group."""
    import json as _json
    import pickle
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch import params as P
    from repro_torch.configs import get_arch
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core.service import CostModelService
    from repro_torch.data import pipeline as PIPE
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.launch.roofline import model_flops_for
    from repro_torch.configs import SHAPES
    from repro_torch.models import model as MODEL
    from repro_torch.models import steps as STEPS
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH
    t_phase = time.perf_counter()

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def tree_rel(got, want) -> float:
        top = max(float(w.float().abs().max()) for w in P.tree_flatten(want))
        return max(float((full(g).float() - w.float()).abs().max())
                   for g, w in zip(P.tree_flatten(got),
                                   P.tree_flatten(want))) / top

    def full(t):
        return t.full_tensor() if isinstance(t, SH.DTensor) else t

    # (a) the rules paths at full width on a one-rank NCCL mesh
    mesh = make_single_device_mesh()
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda",
          f"(a) needs an NCCL mesh on the card: {dist.get_backend()}, "
          f"{mesh.device_type}")
    rules = SH.ShardingRules(mesh)
    cfg = get_arch(LM_ARCH)
    B, S = MESH_TRAIN
    with torch.device("cuda"):
        params = MODEL.init_params(torch.Generator("cuda").manual_seed(0),
                                   cfg)
    paxes = MODEL.param_axes(cfg)
    dparams = SH.place_tree(params, SH.tree_shardings(rules, paxes, params))
    check(all(isinstance(t, SH.DTensor) and
              all(p == SH.Replicate() for p in t.placements)
              for t in P.tree_flatten(dparams)),
          "(a) params are replicated DTensors on a mesh of one")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             next(PIPE.synthetic_lm_batches(cfg.vocab, B, S, seed=0)).items()}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=10)
    state = adamw.init_state(params)
    dstate = SH.place_tree(state, SH.tree_shardings(
        rules, STEPS.opt_state_axes(paxes), state))
    plain_step = STEPS.make_train_step(cfg, opt_cfg)
    rules_step = STEPS.make_train_step(cfg, opt_cfg, rules=rules)
    (p0, _, m0), ms0 = synced(lambda: plain_step(params, state, batch))
    (p1, _, m1), ms1 = synced(lambda: rules_step(dparams, dstate, batch))
    loss_rel = abs(float(m1["total_loss"]) - float(m0["total_loss"])) / \
        abs(float(m0["total_loss"]))
    param_rel = tree_rel(p1, p0)
    identical = loss_rel == 0.0 and param_rel == 0.0
    del p0, p1
    check(loss_rel <= MESH_REL and param_rel <= MESH_REL,
          f"(a) rules vs rules=None: loss {loss_rel}, params {param_rel}")
    plain_ms = [synced(lambda: plain_step(params, state, batch))[1]
                for _ in range(2)]
    rules_ms = [synced(lambda: rules_step(dparams, dstate, batch))[1]
                for _ in range(2)]
    Bd, n_dec, max_seq = MESH_DECODE
    caches = [MODEL.init_cache(cfg, Bd, max_seq, device="cuda")
              for _ in range(2)]
    caches[1] = SH.place_tree(caches[1], SH.tree_shardings(
        rules, MODEL.cache_axes(cfg), caches[1]))
    dec = (STEPS.make_decode_step(cfg),
           STEPS.make_decode_step(cfg, rules=rules))
    toks = [batch["tokens"][:Bd, :1]] * 2
    dec_ms = ([], [])
    same = True
    for i in range(n_dec):
        for j, (pp, step) in enumerate(((params, dec[0]),
                                        (dparams, dec[1]))):
            (toks[j], caches[j]), ms = synced(
                lambda: step(pp, caches[j], toks[j], i))
            dec_ms[j].append(ms)
        same &= bool(torch.equal(full(toks[1]), toks[0]))
    cache_rel = tree_rel(caches[1], caches[0])
    check(same, "(a) decode tokens with rules differ from rules=None")
    check(cache_rel <= MESH_REL, f"(a) decode caches {cache_rel} apart")
    del caches, params, dparams, state, dstate
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    part_a = {"arch": LM_ARCH, "batch": B, "seq": S,
              "loss_rel": loss_rel, "param_rel": param_rel,
              "limit": MESH_REL, "bit_identical": identical,
              "first_step_ms": {"plain": ms0, "rules": ms1},
              "ms_per_step": {"plain": float(np.mean(plain_ms)),
                              "rules": float(np.mean(rules_ms))},
              "decode": {"batch": Bd, "steps": n_dec, "max_seq": max_seq,
                         "tokens_equal": same, "cache_rel": cache_rel,
                         "ms_per_token": {
                             "plain": float(np.mean(dec_ms[0][1:])),
                             "rules": float(np.mean(dec_ms[1][1:]))}}}
    emit({"phase": "mesh", "case": "rules_one_rank_nccl", **part_a})

    # (b) the trainer on 2 gloo CPU ranks (CPU ranks by design: NCCL
    # takes one rank a card), its params served through K1 on the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = os.path.join(tmp, "ranks.pkl")
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(2, os.path.join(tmp, "store"), out,
                              MESH_CONV_STEPS), nprocs=2, join=True)
    ranks_s = time.perf_counter() - t0
    with open(out, "rb") as f:
        two = pickle.load(f)
    one = mesh_conv_fit((1, 1), MESH_CONV_STEPS)
    check(len(two["losses"]) == len(one["losses"]) == MESH_CONV_STEPS,
          "(b) a loss a step")
    loss_rel = float(np.max(np.abs(np.subtract(two["losses"][:10],
                                               one["losses"][:10]))
                            / np.abs(one["losses"][:10])))
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"(b) 2 ranks vs 1: first 10 losses {loss_rel} apart")
    check(two["losses"][-1] < two["losses"][0],
          f"(b) loss {two['losses'][0]} -> {two['losses'][-1]}")
    ds, _, graphs = serve_world()
    K.conv_forward_fused.launches = 0
    svc = CostModelService("conv1d", COSTMODEL_BASE, two["params"],
                           ds.vocab, two["norm_stats"], mode="ops",
                           max_seq=256, max_batch=64, use_kernel=True)
    svc.warmup()
    preds = svc.predict_all(graphs)
    launches = K.conv_forward_fused.launches
    owed = svc.warmup_shapes + svc.forward_batches
    check(launches > 0 and launches == owed,
          f"(b) K1 launches {launches} != warm-up shapes + forward "
          f"batches {owed}")
    check(all(np.isfinite(v).all() for v in preds.values()),
          "(b) served predictions finite")
    vs_plain = served_vs_plain(svc, seed=23)
    part_b = {"ranks": 2, "backend": "gloo", "device": "cpu",
              "why_cpu": "NCCL takes one rank a card; this machine has one",
              "mesh": [2, 1], "compress_grads": True,
              "steps": MESH_CONV_STEPS, "first10_loss_rel": loss_rel,
              "limit": TRAIN_LOSS_RTOL,
              "losses": [two["losses"][0], two["losses"][-1]],
              "ranks_s": ranks_s, "one_rank_s": one["seconds"],
              "k1_launches": launches, "owed": owed,
              "served_vs_plain": vs_plain}
    emit({"phase": "mesh", "case": "trainer_two_gloo_ranks", **part_b})

    # (c) the dry run: a fake group of 256 ranks in a child process
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    dry = {}
    for shape in MESH_DRYRUN_SHAPES:
        dry_out = os.path.join(tmp, "dryrun")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             LM_ARCH, "--shape", shape, "--out", dry_out],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parent / "src")))
        secs = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"(c) dryrun {shape}: rc {proc.returncode} "
              f"{proc.stdout[-500:]} {proc.stderr[-1500:]}")
        with open(os.path.join(dry_out,
                               f"pod16x16__{LM_ARCH}__{shape}.json")) as f:
            rec = _json.load(f)
        check(rec["status"] == "ok", f"(c) dryrun {shape}: {rec}")
        rl = rec["roofline"]
        check(rl["model_flops"] == model_flops_for(cfg, SHAPES[shape]),
              "(c) model flops")
        ratio = rl["flops_per_chip"] / (rl["model_flops"] / rl["chips"])
        if SHAPES[shape].kind == "train":
            check(MESH_DRYRUN_RATIO[0] <= ratio <= MESH_DRYRUN_RATIO[1],
                  f"(c) {shape} flops ratio {ratio}")
        # a tensor left whole on every rank would not fit
        rank_bytes = sum(rec["memory"].values())
        check(rank_bytes <= card_bytes,
              f"(c) {shape}: {rank_bytes} bytes a rank, more than the "
              f"card's {card_bytes}")
        dry[shape] = {"status": rec["status"], "chips": rl["chips"],
                      "flops_ratio": ratio,
                      "t_compute_ms": rl["t_compute"] * 1e3,
                      "t_memory_ms": rl["t_memory"] * 1e3,
                      "t_collective_ms": rl["t_collective"] * 1e3,
                      "bottleneck": rl["bottleneck"],
                      "coll_breakdown": rl["coll_breakdown"],
                      "memory": rec["memory"], "rank_bytes": rank_bytes,
                      "card_bytes": card_bytes,
                      "traced_s": rec["lower_s"], "process_s": secs}
    emit({"phase": "mesh", "case": "dryrun", "arch": LM_ARCH,
          "mesh": "pod16x16 (fake group of 256)",
          "constants": "H100 SXM5 data sheet: 989e12 flop/s, 3.35e12 B/s, "
                       "450e9 B/s", "cells": dry})
    out = {"phase": "mesh", "rules": part_a, "trainer": part_b,
           "dryrun": dry, "launches": launches,
           "phase_seconds": time.perf_counter() - t_phase, "card": card}
    emit(out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here outside a checkout)
    # the train phase's resume check runs deterministic algorithms,
    # which need this before cuBLAS's first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False         # f32 yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    serve = phase_serve(dev["nvidia_smi"])
    lstm = phase_kernels_lstm()
    serve_lstm = phase_serve_lstm(dev["nvidia_smi"])
    tower = phase_tower()
    embed = phase_kernels_embed()
    train = phase_train(dev["nvidia_smi"])
    compiler = phase_compiler(dev["nvidia_smi"])
    replicated = phase_replicated(dev["nvidia_smi"])
    phase_families(dev["nvidia_smi"])
    cli = phase_cli(dev["nvidia_smi"])
    ingest = phase_ingest(dev["nvidia_smi"])
    phase_lm(dev["nvidia_smi"])
    mesh = phase_mesh(dev["nvidia_smi"])
    t64, t4, t1 = (kern["timings"][b] for b in (64, 4, 1))
    l64, l1 = lstm["timings"][64], lstm["timings"][1]
    w64, w1 = tower["timings"][64], tower["timings"][1]
    e128 = embed["timings"][(128, "float32")]
    emit({"kernels": [{
        "name": "conv_forward_fused", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": serve["launches"] + compiler["launches"]
        + replicated["k1_launches"] + cli["launches"]
        + ingest["launches"] + mesh["launches"],
        "launches_by_path": {"serve": serve["launches"],
                             "compiler": compiler["launches"],
                             "replicated": replicated["k1_launches"],
                             "cli": cli["launches"],
                             "ingest": ingest["launches"],
                             "mesh": mesh["launches"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": t64["ms"], "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"], "bound_by": t64["bound_by"],
        "library_ms": None,
        "kernel_ms": t64["ms"], "bound": "flops"
        if t64["bound_by"] == "operations" else "bytes",
        "shape": {"B": 64, "S": 256}, "wrapper_ms": t64["wrapper_ms"],
        "checked_wrapper_ms": t64["checked_wrapper_ms"],
        "device_ms": t64["device_ms"], "host_ms": t64["host_ms"],
        "b4": {k: t4[k] for k in ("ms", "plain_ms", "device_ms", "host_ms",
                                  "wrapper_ms", "checked_wrapper_ms",
                                  "bound_ms", "bound_by", "plan")},
        "b1": {k: t1[k] for k in ("ms", "plain_ms", "device_ms", "host_ms",
                                  "wrapper_ms", "checked_wrapper_ms",
                                  "bound_ms", "bound_by", "plan")},
        "plan": t64["plan"], "ptxas": t64["ptxas"],
        "serve_forward_ms_per_batch": serve["forward_ms_per_batch"],
        "card": dev["nvidia_smi"]}, {
        "name": "lstm_scan_ids", "route": "cuda",
        "source": LSTM_SOURCE, "replaces": LSTM_TPU_KERNEL,
        "launches": serve_lstm["launches"] + replicated["k2_launches"],
        "launches_by_path": {"serve_lstm": serve_lstm["launches"],
                             "replicated": replicated["k2_launches"]},
        "max_abs_err": lstm["max_abs_err"],
        "ms": l64["ms"], "plain_ms": l64["plain_ms"],
        "bound_ms": l64["bound_ms"], "bound_by": l64["bound_by"],
        "library_ms": l64["library_ms"],
        "library": "torch.nn.LSTM (cuDNN) on packed prefix sequences, "
                   "from embedded x; against forward_ms",
        "entries": "lstm_scan_ids (main path, gather in the kernel) and "
                   "lstm_scan_fused (xw, mask) launch one kernel template",
        "entries_ms": l64["entries_ms"],
        "forward_ms": l64["forward_ms"],
        "library_max_abs_err": l64["library_max_abs_err"],
        "ms_per_step": l64["ms_per_step"], "plan": lstm["plan"],
        "shape": {"B": 64, "S": 256, "H": l64["H"]},
        "b1": {k: l1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "ms_per_step", "entries_ms", "forward_ms",
                                  "library_ms")},
        "card": dev["nvidia_smi"]}, {
        "name": "conv1d_stack_fused", "route": "cuda",
        "source": TOWER_SOURCE, "replaces": TOWER_TPU_KERNEL,
        "launches": tower["launches"], "max_abs_err": tower["max_abs_err"],
        "ms": w64["ms"], "plain_ms": w64["plain_ms"],
        "bound_ms": w64["bound_ms"], "bound_by": w64["bound_by"],
        "library_ms": None, "shape": {"B": 64, "S": 256},
        "plan": w64["plan"], "ptxas": w64["ptxas"],
        "device_ms": w64["device_ms"], "host_ms": w64["host_ms"],
        "b1": {k: w1[k] for k in ("ms", "plain_ms", "device_ms", "host_ms",
                                  "bound_ms", "bound_by", "plan")},
        "card": dev["nvidia_smi"]}, {
        "name": "embed_grad", "route": "cuda", "source": EMBED_SOURCE,
        "replaces": None, "launches": train["e1_launches"],
        "launches_by_path": {"train": train["e1_launches"]},
        "max_err_over_limit": embed["max_err_over_limit"],
        **{k: e128[k] for k in ("ms", "kernel_ms", "plain_ms",
                                "library_ms", "index_put_ms", "device_ms",
                                "host_ms", "library_device_ms",
                                "library_host_ms", "bound_ms", "bound_by",
                                "roofline_pct", "ptxas")},
        "library": "aten.embedding_dense_backward (padding_idx 0)",
        "shape": {"B": EG_B, "S": 128, "V": EG_V, "E": EG_E},
        "other": {f"S{S}_{d}": {k: t[k] for k in (
            "ms", "kernel_ms", "plain_ms", "library_ms", "index_put_ms",
            "device_ms", "host_ms", "bound_ms", "roofline_pct")}
            for (S, d), t in embed["timings"].items()},
        "card": dev["nvidia_smi"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
