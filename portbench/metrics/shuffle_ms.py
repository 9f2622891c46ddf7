"""shuffle_ms: the mean CUDA-event time of `generate`'s shuffle phase over the
traced window's calls (events recorded at the program's `phase_hook`)."""


def read(w):
    times = w.phase_ms.get("shuffle")
    return sum(times) / len(times) if times else None
