"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library for ``sm_90a`` (Hopper) at first use, under
``build/chattts_tpu_torch/`` at the root of the checkout (or
``$CHATTTS_TORCH_BUILD_DIR``).  A library's file name carries a hash of its
source and flags, so an edited source builds anew and an unchanged one is
reused.  Nothing here runs at import time: this module is imported on
machines that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def build_dir() -> Path:
    env = os.environ.get("CHATTTS_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parent / "build" / "chattts_tpu_torch"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(source: str, defines: Sequence[str] = ()) -> Path:
    src = CSRC / source
    flags = " ".join((*NVCC_FLAGS, *defines))
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()[:16]
    return build_dir() / f"{src.stem}-{digest}.so"


def build(sources: List[str], defines: Sequence[str] = ()) -> Dict[str, float]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together, with ``defines`` (``-DNAME=value``) added to the flags.
    Returns {source: seconds} for the ones compiled; raises with the
    compiler's output if any fails.  The ptxas report (registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in sources:
        out = library_path(source, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / source)]
        jobs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for source, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


class CudaLibrary:
    """One ``csrc`` source, built and loaded on first use."""

    def __init__(self, source: str, defines: Sequence[str] = ()):
        self.source = source
        self.defines = tuple(defines)
        self._lib = None

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self.source], self.defines)
            self._lib = ctypes.CDLL(str(library_path(self.source,
                                                     self.defines)))
        return self._lib

    def ptxas_report(self) -> str:
        log = library_path(self.source, self.defines).with_suffix(".log")
        return log.read_text() if log.exists() else ""
