"""Share of the traced simulation's window in which the device is idle
inside the program's ``hakai.graph.capture`` spans (each graph's warm-up,
capture and instantiation), by interval intersection
(``portbench/idle.py``).  None without device intervals or without the
program's spans."""
from portbench import idle


def read(ctx):
    split = idle.split(ctx["trace"])
    return None if split is None else split["capture"]
