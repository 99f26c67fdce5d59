"""``device_idle_share`` of a cell that writes frames: the same reading,
reported against ``frames_sim_s``."""
from portbench.metrics.device_idle_share import read  # noqa: F401
