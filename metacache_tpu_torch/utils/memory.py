"""Host memory reporting — VmRSS from /proc/self/status, the same source
the reference reads (src/querying.h:305-323)."""
from __future__ import annotations

import resource
from typing import Optional


def _status_mb(field: str) -> Optional[float]:
    """A `field:` line of /proc/self/status in MB, None if it is absent."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


def vm_rss_mb() -> Optional[float]:
    """Resident set size in MB, None if /proc is unavailable."""
    return _status_mb("VmRSS")


def vm_peak_mb() -> Optional[float]:
    """Peak resident set size in MB: VmHWM, or where the kernel's status
    file lacks it (some container kernels do), getrusage's ru_maxrss (KB
    on Linux); None if neither is known."""
    peak = _status_mb("VmHWM")
    if peak is None:
        kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        peak = kb / 1024.0 if kb > 0 else None
    return peak
