"""Host milliseconds a training step takes to dispatch its optimizer
(gradient transform, AdamW): the mean ``lm.optimizer`` span of
``models/steps.make_train_step`` over the sampled steps whose ``lm.step``
began in the window (a torch profiler samples every step it records).

The span is on the host's clock around calls that only enqueue work, so
it reads the host's dispatch, not the card's optimizer time: while the
card runs behind the host (idle ~1% of a traced window in the jamba
cell) it cannot move ``train_graphs_per_s``, and would only if the host
came to set the step."""

PHASE = "lm.optimizer"


def read(w):
    if w["kind"] != "lmtrain":
        return None
    from repro_torch.obs import trace as T
    if not hasattr(T, "default_tracer"):       # a program without spans
        return None
    lo, hi = w["win"]["wall"]
    got = []
    for tree in T.assemble(T.default_tracer().recorder.snapshot()).values():
        root = tree.roots[0] if tree.roots else None
        if root is None or root["name"] != "lm.step" or \
                not lo <= root["t_wall"] <= hi:
            continue
        got += [k["dur_s"] for k in tree.children.get(root["span"], ())
                if k["name"] == PHASE]
    return 1e3 * sum(got) / len(got) if got else None
