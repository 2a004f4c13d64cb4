"""Host milliseconds a training step spends in its backward
(``autograd.grad``): the mean ``trainer.backward`` span of
``TrainEngine.fit`` (``core/trainer.py``) over the newest
``trainer.fit`` trace's sampled steps after its first that no profiler
recorded (tag ``profiled``)."""

PHASE = "trainer.backward"


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
    steps = [s for s in steps if not s["tags"]["profiled"]]
    got = [k["dur_s"] for s in steps for k in tree.children.get(s["span"], ())
           if k["name"] == PHASE]
    return 1e3 * sum(got) / len(steps) if got else None
