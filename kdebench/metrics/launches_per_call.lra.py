"""`launches_per_call.lra`: see ``kdebench.readers.launches_per_call``."""
from kdebench.readers import launches_per_call as read  # noqa: F401
