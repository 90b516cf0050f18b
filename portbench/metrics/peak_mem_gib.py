"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window (reset
at its start), in GiB: what the cell's plans, caches and vectors hold."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
