"""Seconds of ``TrainEngine.fit``'s own set-up: its ``trainer.prepare``
span (``core/trainer.py``: from the call to the first step) plus the
first step's ``trainer.step``, which meets the lazy CUDA and cuDNN
start-up, in the newest ``trainer.fit`` trace."""


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
    kids = tree.children.get(tree.roots[0]["span"], [])
    prep = [k for k in kids if k["name"] == "trainer.prepare"]
    steps = [k for k in kids if k["name"] == "trainer.step"]
    return prep[0]["dur_s"] + steps[0]["dur_s"] if prep and steps else None
