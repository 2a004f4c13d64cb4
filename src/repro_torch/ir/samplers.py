"""Family-specific dataflow-graph samplers (Resnet/BERT/Unet/SSD/Yolo-like).

The paper's 20k-sample corpus is extracted from these five model families;
we sample random subgraphs with the same op mix and a *frequent-shape pool*
(the paper keeps OOV shape tokens rare by reusing frequent tensor sizes).
"""
from __future__ import annotations

import numpy as np

from repro_torch.ir.graph import Graph, Tensor

# Frequent-shape pools (paper: "many of the tensor sizes appear frequently
# across multiple models").
BATCHES = [1, 8, 16, 32]
SPATIAL = [7, 14, 28, 56, 112, 224]
CHANNELS = [3, 16, 32, 64, 128, 256, 512, 1024]
HIDDEN = [128, 256, 512, 768, 1024, 2048, 4096]
SEQ = [64, 128, 256, 512]


def _conv_block(g, rng, x, t, channels):
    c_out = int(rng.choice(channels))
    n, h, w, _ = t.shape
    stride = int(rng.choice([1, 1, 1, 2]))
    h2, w2 = max(h // stride, 1), max(w // stride, 1)
    out_t = Tensor((n, h2, w2, c_out), t.dtype)
    x = g.add_op("conv2d", [x], out_t, stride=stride, kernel=3)
    if rng.random() < 0.7:
        x = g.add_op("batchnorm", [x], out_t)
    act = rng.choice(["relu", "silu", "gelu"])
    x = g.add_op(str(act), [x], out_t)
    return x, out_t


def sample_resnet(rng: np.random.Generator) -> Graph:
    g = Graph(name="resnet_sub")
    n = int(rng.choice(BATCHES))
    s = int(rng.choice(SPATIAL))
    c = int(rng.choice(CHANNELS))
    t = Tensor((n, s, s, c))
    x = g.add_arg(t)
    for _ in range(rng.integers(1, 5)):
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


def sample_bert(rng: np.random.Generator) -> Graph:
    g = Graph(name="bert_sub")
    b = int(rng.choice(BATCHES))
    s = int(rng.choice(SEQ))
    d = int(rng.choice(HIDDEN))
    ff = int(rng.choice([2 * d, 4 * d]))
    t = Tensor((b, s, d))
    x = g.add_arg(t)
    wq = g.add_arg(Tensor((d, d)))
    wo = g.add_arg(Tensor((d, d)))
    wf1 = g.add_arg(Tensor((d, ff)))
    wf2 = g.add_arg(Tensor((ff, d)))
    for _ in range(rng.integers(1, 4)):
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


def sample_unet(rng: np.random.Generator) -> Graph:
    g = Graph(name="unet_sub")
    n = int(rng.choice([1, 2, 4]))
    s = int(rng.choice([56, 112, 224]))
    c = int(rng.choice([16, 32, 64]))
    t = Tensor((n, s, s, c))
    x = g.add_arg(t)
    skips = []
    depth = int(rng.integers(1, 4))
    for _ in range(depth):  # down path
        x, t = _conv_block(g, rng, x, t, [t.shape[-1] * 2])
        skips.append((x, t))
        n_, h_, w_, c_ = t.shape
        t = Tensor((n_, max(h_ // 2, 1), max(w_ // 2, 1), c_))
        x = g.add_op("pool_max", [x], t)
    for sx, st in reversed(skips):  # up path
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
    n = int(rng.choice([1, 8]))
    s = int(rng.choice([28, 56, 112]))
    c = int(rng.choice([64, 128, 256]))
    t = Tensor((n, s, s, c))
    x = g.add_arg(t)
    for _ in range(rng.integers(2, 6)):  # backbone
        x, t = _conv_block(g, rng, x, t, CHANNELS)
    outs = []
    for _ in range(heads):  # detection heads
        n_, h_, w_, c_ = t.shape
        box_t = Tensor((n_, h_, w_, int(rng.choice([4, 8, 12]))))
        cls_t = Tensor((n_, h_, w_, int(rng.choice([20, 80, 91]))))
        b = g.add_op("conv2d", [x], box_t, stride=1, kernel=3)
        cl = g.add_op("conv2d", [x], cls_t, stride=1, kernel=3)
        cl = g.add_op("sigmoid", [cl], cls_t)
        outs += [b, cl]
    g.outputs = outs
    return g


def sample_ssd(rng):
    return _detector(rng, "ssd_sub", heads=int(rng.integers(1, 4)))


def sample_yolo(rng):
    return _detector(rng, "yolo_sub", heads=int(rng.integers(1, 3)))


SAMPLERS = {
    "resnet": sample_resnet,
    "bert": sample_bert,
    "unet": sample_unet,
    "ssd": sample_ssd,
    "yolo": sample_yolo,
}


def sample_graph(rng: np.random.Generator, family: str = None) -> Graph:
    fam = family or rng.choice(sorted(SAMPLERS))
    g = SAMPLERS[str(fam)](rng)
    g.validate()
    return g
