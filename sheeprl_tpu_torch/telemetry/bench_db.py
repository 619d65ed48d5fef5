"""Provenance stamps for the telemetry meta line (the part of
``sheeprl_tpu/telemetry/bench_db.py`` the port needs): which code
(:func:`git_stamp`) on which host (:func:`host_fingerprint`) produced a run.

The bench history store, its regression statistics and the ``perf``
subcommand come with the port's benchmark. Stdlib only.
"""

from __future__ import annotations

import os
import platform
import socket
import subprocess
from typing import Any, Dict, Optional

__all__ = ["git_stamp", "host_fingerprint"]


def git_stamp(root: Optional[str] = None) -> Dict[str, Any]:
    """``{"sha", "dirty"}`` of the checkout at ``root`` (cwd default); both
    degrade gracefully (sha ``"unknown"``) outside a git work tree."""
    cwd = root or os.getcwd()
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True, text=True, timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    dirty = False
    try:
        status = subprocess.run(["git", "status", "--porcelain"], cwd=cwd, capture_output=True, text=True, timeout=10)
        dirty = status.returncode == 0 and bool(status.stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return {"sha": sha, "dirty": dirty}


def host_fingerprint() -> Dict[str, Any]:
    """Hardware/host identity coarse enough to be stable across runs on the
    same box, fine enough to separate baselines from different machines."""
    return {
        "hostname": socket.gethostname(),
        "machine": platform.machine(),
        "system": platform.system(),
        "cpu_count": os.cpu_count() or 0,
        "python": platform.python_version(),
    }
