"""Traffic's input graphs: the five sampled model families and the
unoptimized IR a compiler hands its optimizer.

A frozen copy of the port's family samplers (``ir/samplers.py``) and of
the JAX benches' ``_unoptimized_ir`` dressing, so that later changes to
the program cannot change what the benchmark sends. The graphs are built
with the port's Graph API (``repro_torch.ir.graph``), the type its
service and server take; everything else about them is decided here,
from the seed.
"""
from __future__ import annotations

from repro_torch.ir.graph import Graph, Tensor

BATCHES = [1, 8, 16, 32]
SPATIAL = [7, 14, 28, 56, 112, 224]
CHANNELS = [3, 16, 32, 64, 128, 256, 512, 1024]
HIDDEN = [128, 256, 512, 768, 1024, 2048, 4096]
SEQ = [64, 128, 256, 512]

# the IR's elementwise opcodes (fusion fodder), in a fixed order
ELEMENTWISE = ("abs", "add", "div", "exp", "gelu", "maximum", "minimum",
               "mult", "neg", "relu", "rsqrt", "sigmoid", "silu", "sub",
               "tanh")
# every opcode the samplers, the dressing and the rewrites can emit
OPCODES = tuple(sorted(set(ELEMENTWISE) | {
    "softmax", "layernorm", "batchnorm", "reduce_sum", "reduce_max",
    "reduce_mean", "matmul", "conv2d", "depthwise_conv2d", "attention",
    "reshape", "transpose", "concat", "slice", "broadcast", "pool_max",
    "pool_avg", "upsample", "pad", "fused"}))


def _conv_block(g, rng, x, t, channels):
    c_out = rng.choice(channels)
    n, h, w, _ = t.shape
    stride = rng.choice((1, 1, 1, 2))
    h2, w2 = max(h // stride, 1), max(w // stride, 1)
    out_t = Tensor((n, h2, w2, c_out), t.dtype)
    x = g.add_op("conv2d", [x], out_t, stride=stride, kernel=3)
    if rng.random() < 0.7:
        x = g.add_op("batchnorm", [x], out_t)
    act = rng.choice(("relu", "silu", "gelu"))
    x = g.add_op(str(act), [x], out_t)
    return x, out_t


def sample_resnet(rng) -> Graph:
    g = Graph(name="resnet_sub")
    n = rng.choice(BATCHES)
    s = rng.choice(SPATIAL)
    c = rng.choice(CHANNELS)
    t = Tensor((n, s, s, c))
    x = g.add_arg(t)
    for _ in range(rng.randrange(1, 5)):
        skip, skip_t = x, t
        x, t = _conv_block(g, rng, x, t, CHANNELS)
        x2, t2 = _conv_block(g, rng, x, t, [t.shape[-1]])
        if t2.shape == skip_t.shape:
            x = g.add_op("add", [x2, skip], t2)
            t = t2
        else:
            x, t = x2, t2
    if rng.random() < 0.3:
        n_, h_, w_, c_ = t.shape
        t = Tensor((n_, max(h_ // 2, 1), max(w_ // 2, 1), c_))
        x = g.add_op("pool_max", [x], t)
    g.outputs = [x]
    return g


def sample_bert(rng) -> Graph:
    g = Graph(name="bert_sub")
    b = rng.choice(BATCHES)
    s = rng.choice(SEQ)
    d = rng.choice(HIDDEN)
    ff = rng.choice((2 * d, 4 * d))
    t = Tensor((b, s, d))
    x = g.add_arg(t)
    wq = g.add_arg(Tensor((d, d)))
    wo = g.add_arg(Tensor((d, d)))
    wf1 = g.add_arg(Tensor((d, ff)))
    wf2 = g.add_arg(Tensor((ff, d)))
    for _ in range(rng.randrange(1, 4)):
        q = g.add_op("matmul", [x, wq], t)
        k = g.add_op("matmul", [x, wq], t)
        v = g.add_op("matmul", [x, wq], t)
        at = Tensor((b, s, s))
        a = g.add_op("matmul", [q, k], at, transpose_b=True)
        a = g.add_op("softmax", [a], at)
        o = g.add_op("matmul", [a, v], t)
        o = g.add_op("matmul", [o, wo], t)
        x = g.add_op("add", [x, o], t)
        x = g.add_op("layernorm", [x], t)
        h_t = Tensor((b, s, ff))
        h = g.add_op("matmul", [x, wf1], h_t)
        h = g.add_op("gelu", [h], h_t)
        h2 = g.add_op("matmul", [h, wf2], t)
        x = g.add_op("add", [x, h2], t)
        x = g.add_op("layernorm", [x], t)
    g.outputs = [x]
    return g


def sample_unet(rng) -> Graph:
    g = Graph(name="unet_sub")
    n = rng.choice((1, 2, 4))
    s = rng.choice((56, 112, 224))
    c = rng.choice((16, 32, 64))
    t = Tensor((n, s, s, c))
    x = g.add_arg(t)
    skips = []
    for _ in range(rng.randrange(1, 4)):       # down path
        x, t = _conv_block(g, rng, x, t, [t.shape[-1] * 2])
        skips.append((x, t))
        n_, h_, w_, c_ = t.shape
        t = Tensor((n_, max(h_ // 2, 1), max(w_ // 2, 1), c_))
        x = g.add_op("pool_max", [x], t)
    for sx, st in reversed(skips):                 # up path
        n_, h_, w_, c_ = t.shape
        t_up = Tensor((n_, h_ * 2, w_ * 2, c_))
        x = g.add_op("upsample", [x], t_up)
        if t_up.shape[:3] == st.shape[:3]:
            t = Tensor(t_up.shape[:3] + (t_up.shape[3] + st.shape[3],))
            x = g.add_op("concat", [x, sx], t)
        else:
            t = t_up
        x, t = _conv_block(g, rng, x, t, [st.shape[-1]])
    g.outputs = [x]
    return g


def _detector(rng, name, heads):
    g = Graph(name=name)
    n = rng.choice((1, 8))
    s = rng.choice((28, 56, 112))
    c = rng.choice((64, 128, 256))
    t = Tensor((n, s, s, c))
    x = g.add_arg(t)
    for _ in range(rng.randrange(2, 6)):            # backbone
        x, t = _conv_block(g, rng, x, t, CHANNELS)
    outs = []
    for _ in range(heads):                         # detection heads
        n_, h_, w_, c_ = t.shape
        box_t = Tensor((n_, h_, w_, rng.choice((4, 8, 12))))
        cls_t = Tensor((n_, h_, w_, rng.choice((20, 80, 91))))
        b = g.add_op("conv2d", [x], box_t, stride=1, kernel=3)
        cl = g.add_op("conv2d", [x], cls_t, stride=1, kernel=3)
        cl = g.add_op("sigmoid", [cl], cls_t)
        outs += [b, cl]
    g.outputs = outs
    return g


def sample_ssd(rng) -> Graph:
    return _detector(rng, "ssd_sub", heads=rng.randrange(1, 4))


def sample_yolo(rng) -> Graph:
    return _detector(rng, "yolo_sub", heads=rng.randrange(1, 3))


SAMPLERS = {"bert": sample_bert, "resnet": sample_resnet,
            "ssd": sample_ssd, "unet": sample_unet, "yolo": sample_yolo}


def sample(rng, families) -> Graph:
    """One graph of a family drawn uniformly from ``families``; ``rng``
    is a ``random.Random``."""
    fam = families[rng.randrange(len(families))]
    return SAMPLERS[fam](rng)


def unoptimized_ir(g: Graph, rng) -> Graph:
    """Dress a sampled graph as the unoptimized IR a compiler hands the
    optimizer: naive elementwise chains (fusion fodder), duplicated
    subexpressions (CSE fodder) and dead ops (DCE fodder)."""
    new = Graph(name=g.name + "_raw")
    new.values = list(g.values[:g.n_args])
    new.n_args = g.n_args
    for op in g.ops:
        new.add_op(op.opcode, list(op.operands), g.values[op.result],
                   **op.attrs)
    new.outputs = list(g.outputs)
    results = [op.result for op in new.ops]
    for _ in range(6):                  # fusable chains ending in outputs
        v = results[rng.randrange(len(results))]
        for _ in range(rng.randrange(3, 7)):
            t = new.values[v]
            v = new.add_op(ELEMENTWISE[rng.randrange(len(ELEMENTWISE))],
                           [v], Tensor(t.shape, t.dtype))
        new.outputs.append(v)
    for _ in range(4):                  # duplicate subexpressions (CSE)
        op = new.ops[rng.randrange(len(new.ops))]
        d = new.add_op(op.opcode, list(op.operands),
                       new.values[op.result], **op.attrs)
        t = new.values[d]
        new.outputs.append(new.add_op("relu", [d], Tensor(t.shape, t.dtype)))
    for _ in range(3):                  # dead ops (DCE)
        v = results[rng.randrange(len(results))]
        t = new.values[v]
        new.add_op("exp", [v], Tensor(t.shape, t.dtype))
    return new
