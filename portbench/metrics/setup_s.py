"""setup_s: seconds from the process's start to the window's: imports,
loading (or, in a checkout's first run, building) the kernels, the
program's state made from the seed, and the warm-up of every shape the
window uses."""


def read(w):
    return w.setup_s
