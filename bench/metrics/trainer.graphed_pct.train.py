"""Share (%) of a training run's steps that a CUDA graph ran: the
``graphed`` tag of ``TrainEngine.fit``'s ``trainer.step`` spans
(``core/trainer.py``) over the newest ``trainer.fit`` trace's sampled
steps after its first that no profiler recorded (tag ``profiled``).
None for a program whose steps carry no such tag."""


def read(w):
    if w["kind"] != "train":
        return None
    from repro_torch.obs import trace as T
    if not hasattr(T, "default_tracer"):       # a program without spans
        return None
    fits = [t for t in T.assemble(
        T.default_tracer().recorder.snapshot()).values()
        if t.roots and t.roots[0]["name"] == "trainer.fit"]
    if not fits:
        return None
    tree = max(fits, key=lambda t: t.roots[0]["t_wall"])
    steps = [s for s in tree.children.get(tree.roots[0]["span"], [])
             if s["name"] == "trainer.step"][1:]
    tags = [s["tags"]["graphed"] for s in steps
            if not s["tags"]["profiled"] and "graphed" in s["tags"]]
    return 100.0 * sum(map(bool, tags)) / len(tags) if tags else None
