"""peak_gib: the most device memory the allocator held in the window
(`torch.cuda.max_memory_allocated` after a reset at its start), in GiB."""


def read(w):
    return w.memory_peak_bytes / 2**30 if w.memory_peak_bytes else None
