"""Graphs a search passes to the server's ``predict_all``, a search
finished in the window."""


def read(w):
    if w["kind"] != "search" or not w["win"]["completed"]:
        return None
    return w["win"]["rows"] / w["win"]["completed"]
