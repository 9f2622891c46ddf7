"""hops_per_s: live walkers times the walk length, summed over every call
the window completed, over the window's wall time on the host's clock."""


def read(w):
    hops = w.work.get("hops")
    return hops / w.seconds if hops else None
