"""`launches_per_call.sparsify`: see ``kdebench.readers.launches_per_call``."""
from kdebench.readers import launches_per_call as read  # noqa: F401
