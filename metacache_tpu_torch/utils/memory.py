"""Host memory reporting — VmRSS from /proc/self/status, the same source
the reference reads (src/querying.h:305-323)."""
from __future__ import annotations

from typing import Optional


def vm_rss_mb() -> Optional[float]:
    """Resident set size in MB, None if /proc is unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


def vm_peak_mb() -> Optional[float]:
    """Peak resident set size in MB, None if /proc is unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None
