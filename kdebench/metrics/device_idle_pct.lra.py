"""`device_idle_pct.lra`: see ``kdebench.readers.device_idle_pct``."""
from kdebench.readers import device_idle_pct as read  # noqa: F401
