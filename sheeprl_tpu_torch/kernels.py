"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with :mod:`ctypes`. Builds happen at
first use (or up front through :func:`build`), from the sources in the
package, into ``sheeprl_tpu_torch/_build/`` (git-ignored). A library's file
name carries a digest of its source and flags, so an edited source is
rebuilt and a stale build is never loaded. Several sources compile in
parallel, one ``nvcc`` each.

Nothing here runs when the module is imported: the CPU tests import every
module of the package on a host with no ``nvcc``.

Telemetry: every ``nvcc`` run is a ``kernel_build`` span and counter, every
build found already made a cache hit
(:func:`sheeprl_tpu_torch.telemetry.cuda_events.kernel_built`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import uuid
from pathlib import Path
from typing import Dict, Iterable, Optional

from sheeprl_tpu_torch.telemetry.cuda_events import kernel_built

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES: Dict[str, Path] = {
    "ln_gru": PACKAGE_DIR / "csrc" / "ln_gru.cu",
    "ln_gru_tc": PACKAGE_DIR / "csrc" / "ln_gru_tc.cu",
    "ln_gru_bwd": PACKAGE_DIR / "csrc" / "ln_gru_bwd.cu",
}
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``'s,
    else the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found (set CUDA_HOME); the CUDA kernels can only be built on a CUDA host")
    return found


def library_path(name: str) -> Path:
    source = SOURCES[name]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (all by default) that has no current
    build, all at once. Returns the seconds each build took (0.0 for one
    already built); the compiler's report (``-Xptxas=-v``: registers, shared
    memory, spills) is kept beside the library as ``<lib>.log``. Raises
    RuntimeError with the compiler's output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    running = []
    for name in names:
        target = library_path(name)
        if target.exists():
            kernel_built(name, 0.0, cached=True)
            continue
        staging = target.with_name(f".{target.name}.{uuid.uuid4().hex[:8]}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(staging), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, target, staging, proc, time.perf_counter()))
    failures = []
    for name, target, staging, proc, start in running:
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            staging.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n{output}")
            continue
        target.with_name(target.name + ".log").write_text(output)
        os.replace(staging, target)  # atomic: a concurrent loader sees no half-written library
        kernel_built(name, seconds[name], cached=False)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report from the current build of ``name``."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load it (once per process)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
