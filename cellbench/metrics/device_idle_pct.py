"""device_idle_pct: the share of the profiled episode in
which no operation ran on the device."""
from cellbench.readers import idle_pct as read  # noqa: F401
