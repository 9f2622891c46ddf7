"""csr_ms: the mean CUDA-event time of `generate`'s csr phase over the
traced window's calls (events recorded at the program's `phase_hook`)."""


def read(w):
    times = w.phase_ms.get("csr")
    return sum(times) / len(times) if times else None
