from .args import ArgsParser  # noqa: F401
from .memory import vm_peak_mb, vm_rss_mb  # noqa: F401
from .timer import Timer  # noqa: F401
