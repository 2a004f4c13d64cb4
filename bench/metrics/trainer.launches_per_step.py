"""CUDA kernels a training step launches, from the device trace over
the traced steps (copies and memsets left out)."""


def read(w):
    t = w["trace"]
    if w["kind"] != "train" or t is None or not w["work"]:
        return None
    n = sum(c for name, c in t["launches"].items()
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(w["work"])
