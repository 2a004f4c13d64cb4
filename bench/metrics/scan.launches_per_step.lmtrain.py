"""Entries of the scan kernel a training step makes (forward, forward
again under recomputation, backward), from the program's counter
(``kernels/selective_scan``'s ``launches``) over the window's steps."""


def read(w):
    win = w["win"]
    if w["kind"] != "lmtrain" or not win.get("n") or \
            win.get("scan_launches") is None:
        return None
    return win["scan_launches"] / win["n"]
