"""The age of this process, for the set-up time: from the process's start
(``/proc``) to now."""

from __future__ import annotations

import os
import time


def process_age_s() -> float:
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def process_start_wall() -> float:
    """The wall-clock time (``time.time``) at which this process started."""
    return time.time() - process_age_s()
