"""GiB of ``torch.cuda.max_memory_allocated()`` over the window, the
counter reset at its start."""


def read(ctx):
    return None if ctx["mem_window_peak"] is None \
        else ctx["mem_window_peak"] / 2**30
