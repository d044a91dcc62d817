"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over the window,
after ``reset_peak_memory_stats()`` at its start, in GB (1e9 bytes).  None
off the card."""


def read(w):
    if w.platform != "gpu":
        return None
    return w.peak_bytes / 1e9
