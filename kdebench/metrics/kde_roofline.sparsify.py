"""`kde_roofline.sparsify`: see ``kdebench.readers.kde_roofline``."""
from kdebench.readers import kde_roofline as read  # noqa: F401
