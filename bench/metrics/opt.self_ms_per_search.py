"""Milliseconds a search spends outside its calls to the server: the
time inside ``beam_search`` less the time inside ``predict_all``, a
search finished in the window."""


def read(w):
    if w["kind"] != "search" or not w["win"]["completed"]:
        return None
    return 1e3 * w["win"]["self_s"] / w["win"]["completed"]
