"""Build, load and bind the hand-written CUDA kernels of csrc/.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface, ``build/kernels/lib<name>.so`` beside the
package, and is loaded with ctypes. A library is built at first use and
rebuilt when its source (or a shared ``*.cuh`` header) is newer; all
stale sources compile at once, one nvcc process each. Nothing here runs
at import: the CPU tests import every module on a host without nvcc.

Launch counts: every wrapper that launches a kernel adds one to its entry
in ``launches``, and also to ``scenario_launches`` when the launch covers
more than one consolidation scenario; nothing else touches them, so a
caller that zeroes them (``reset_launches``) and reads them after a run
sees which kernels the run went through, and whether a probe set ran as
one scenario batch or as a loop of single solves. A kernel's variant
(``VARIANTS``: the pack scan over a domain batch, or over a batch with
contributor rows) counts in its own entry as well as in the kernel's.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("fresh_feasibility", "existing_feasibility", "pack", "pack_classed",
           "wire_pack", "apply_rows")
# launches of a kernel's variant, counted besides the kernel's own: pack
# over a domain batch (has_domains) runs its domain machinery, over a
# batch with contributor rows (has_contrib) its contributor counting
VARIANTS = ("pack_domains", "pack_contrib")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # keep float32 a*b+c as two IEEE roundings: fits_count and the load
    # ledgers must agree bit for bit with the XLA reference
    "-fmad=false",
)

launches: Dict[str, int] = {name: 0 for name in SOURCES + VARIANTS}
scenario_launches: Dict[str, int] = {name: 0 for name in SOURCES + VARIANTS}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        scenario_launches[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    src = os.path.join(CSRC, f"{name}.cu")
    headers = [os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")]
    newest = max(os.path.getmtime(f) for f in [src] + headers)
    return os.path.getmtime(lib) < newest


def build(names=SOURCES, force: bool = False, verbose: bool = False) -> Dict[str, str]:
    """Compile every stale library of ``names`` (all at once, one nvcc
    each); returns {name: compiler output} for the ones built."""
    with _lock:
        todo = [n for n in names if force or _stale(n)]
        if not todo:
            return {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name in todo:
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-I", CSRC, "-o", _lib_path(name) + ".tmp",
                    os.path.join(CSRC, f"{name}.cu")]
            procs[name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
        logs, failed = {}, []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{out[-4000:]}")
            else:
                os.replace(_lib_path(name) + ".tmp", _lib_path(name))
        if failed:
            raise KernelBuildError("nvcc failed: " + "\n".join(failed))
        return logs


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(_lib_path(name))
                # every entry point returns cudaGetLastError() after launching
                getattr(lib, f"kt_{name}").restype = ctypes.c_int
                _libs[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t.numel() == 0 else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on the CUDA ``device``."""
    if device.type != "cuda":
        raise ValueError(f"{name}: kernels take CUDA tensors, got {device}")
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


NOTHING_LAUNCHED = -1  # csrc/common.cuh:kNothingLaunched (empty shapes)


def launched(name: str, rc: int, scenarios: int = 1, variants=()) -> None:
    """Count one launch of kernel ``name`` (and of each of its
    ``variants``) over ``scenarios`` scenarios; raise on a CUDA error
    code."""
    if rc == NOTHING_LAUNCHED:
        return
    if rc != 0:
        raise KernelLaunchError(f"{name}: CUDA error {rc} at launch")
    for key in (name,) + tuple(variants):
        launches[key] += 1
        if scenarios > 1:
            scenario_launches[key] += 1
