"""edges_per_s: the edges of every call the window completed, over the
window's wall time on the host's clock."""


def read(w):
    edges = w.work.get("edges")
    return edges / w.seconds if edges else None
