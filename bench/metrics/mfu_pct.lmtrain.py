"""Model operations of the traced training steps (three forwards:
``bench/models/jamba.py``'s ``step_flops``) over the traced time times
the card's dense BF16 peak (989 TFLOP/s)."""


def read(w):
    t = w["trace"]
    if w["kind"] != "lmtrain" or t is None or not w["work"] or \
            t["window_s"] <= 0:
        return None
    from bench.models import jamba
    flops = sum(f for f, _ in w["work"])
    return 100.0 * flops / (t["window_s"] * jamba.PEAK_BF16_FLOPS)
