"""Resident set size of this process, from ``/proc/self/status`` (``VmRSS``,
the figure ``psutil``'s ``memory_info().rss`` reports)."""

from __future__ import annotations


def rss_mb() -> float:
    """This process's resident set in MB (1e6 bytes)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e6
    raise RuntimeError("/proc/self/status has no VmRSS line")
