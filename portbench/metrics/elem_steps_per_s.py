"""Element-steps a second: every simulation's elements x steps over the
window's wall time, from the first ``run()`` call's start to the last
one's return (graph captures, host checks and frames included)."""


def read(ctx):
    return ctx["elem_steps"] / ctx["window_s"]
