"""wave_kernel_ms_per_kread: the wave kernels (ops/wave_cuda.py,
csrc/wave.cu), the engine's ``kernel_ms`` (CUDA events around each launch)
summed over the window's blocks, in ms a 1,000 reads.  None off the card."""


def read(w):
    if w.platform != "gpu" or w.stats["kernel_ms"] <= 0:
        return None
    return w.per_kread(w.stats["kernel_ms"] / 1e3)
