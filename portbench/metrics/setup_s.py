"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernel library's load (its build on a checkout's first run),
the deck, the lowering and one warm-up simulation cut to a chunk."""


def read(ctx):
    return ctx["setup_s"]
