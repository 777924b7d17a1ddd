"""What a run says about the card and the process: the card's name,
power limit and memory, and how long the process has been alive."""

from __future__ import annotations

import os
import subprocess


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])            # field 22: starttime
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    why it could not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi gave nothing (rc {out.returncode})"
