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
(``VARIANTS``: the pack scan over a domain batch, a batch with
contributor rows, minValues floors, a reservation ledger or in the tiled
mode; the class-batched scan over minValues floors or in the tiled mode;
B3's fresh or existing entry) counts in its own entry as well as in the
kernel's. B1's and B2's partial modes and B8's in-place entry count only
under their own names (``ENTRIES``).
"""

from __future__ import annotations

import contextlib
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
SOURCES = ("fresh_feasibility", "existing_feasibility", "dense_feasibility",
           "pack", "pack_classed", "wire_pack", "apply_rows", "relax_fill", "mesh_fold")
# launches of a kernel's variant, counted besides the kernel's own: pack
# over a domain batch (has_domains) runs its domain machinery, over a
# batch with contributor rows (has_contrib) its contributor counting, over
# minValues floors (MV > 0) its minValues caps, over a reservation ledger
# (NRES > 0) the ledger and in the tiled mode (tile_feasibility) its
# per-step rows; pack_classed over minValues floors its maintained
# minValues headroom and in the tiled mode its per-class rows;
# dense_feasibility's two entries count as dense_fresh and dense_existing
VARIANTS = ("pack_domains", "pack_contrib", "pack_minvalues", "pack_resv", "pack_tiled",
            "pack_classed_minvalues", "pack_classed_tiled", "dense_fresh",
            "dense_existing")
# entry points counted under their own name, not their source's: B1's and
# B2's partial modes (a mesh shard's failure counts, folded by mesh_fold)
# and B8's in-place entry (KTPU_DONATE_DELTA=1)
ENTRIES = ("fresh_partial", "existing_partial", "apply_rows_inplace")
# measurement-only libraries, never in SOURCES (the solver and
# chip_smoke.py never build or load them; tenant_scan.py does): name ->
# (the source they compile, extra nvcc flags). pack_clocks and
# pack_classed_clocks are B4 and B5 with their phase clocks (the latter
# also at one block, pack_classed_clocks_c1); pack_classed_c<C> is B5 with
# clusters of at most C blocks, for the A/B that chose its width (8, the
# solver's own library); fresh_feasibility_clocks is B1 with its phase
# clocks.
MEASURE_BUILDS = {
    "fresh_feasibility_clocks": ("fresh_feasibility", ("-DKT_PHASE_CLOCKS",)),
    "pack_clocks": ("pack", ("-DKT_PHASE_CLOCKS",)),
    "pack_classed_clocks": ("pack_classed", ("-DKT_PHASE_CLOCKS",)),
    "pack_classed_clocks_c1": ("pack_classed", ("-DKT_PHASE_CLOCKS", "-DKT_MAX_CLUSTER=1")),
    **{f"pack_classed_c{c}": ("pack_classed", (f"-DKT_MAX_CLUSTER={c}",)) for c in (1, 2, 4)},
}
# a source's C entry points, where they are not the one kt_<source>; a
# phase-clock build adds kt_<source>_phase_clocks
ENTRY_POINTS = {"dense_feasibility": ("kt_dense_fresh", "kt_dense_existing"),
                "fresh_feasibility": ("kt_fresh_feasibility", "kt_fresh_feasibility_partial"),
                "existing_feasibility": ("kt_existing_feasibility",
                                         "kt_existing_feasibility_partial"),
                "apply_rows": ("kt_apply_rows", "kt_apply_rows_inplace")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # keep float32 a*b+c as two IEEE roundings: fits_count and the load
    # ledgers must agree bit for bit with the XLA reference
    "-fmad=false",
)

launches: Dict[str, int] = {name: 0 for name in SOURCES + VARIANTS + ENTRIES}
scenario_launches: Dict[str, int] = {name: 0 for name in SOURCES + VARIANTS + ENTRIES}

_lock = threading.Lock()
# the counts are read-modify-writes, and the solver sidecar launches from
# several threads at once
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def reset_launches() -> None:
    with _count_lock:
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


def _source(name: str) -> str:
    return os.path.join(CSRC, MEASURE_BUILDS.get(name, (name,))[0] + ".cu")


def _entries(name: str):
    src, flags = MEASURE_BUILDS.get(name, (name, ()))
    clocks = (f"kt_{src}_phase_clocks",) if "-DKT_PHASE_CLOCKS" in flags else ()
    return ENTRY_POINTS.get(src, (f"kt_{src}",)) + clocks


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    src = _source(name)
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
            cmd = [nvcc, *NVCC_FLAGS, *MEASURE_BUILDS.get(name, (None, ()))[1]]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-I", CSRC, "-o", _lib_path(name) + ".tmp", _source(name)]
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
                for entry in _entries(name):
                    getattr(lib, entry).restype = ctypes.c_int
                _libs[name] = lib
    return lib


_bound: Dict[tuple, object] = {}


def bind(name: str, entry: str, argtypes):
    """C entry point ``entry`` of library ``name`` with its argument types
    set once: ctypes then converts each Python int by them, and a caller
    passes raw pointers (``Tensor.data_ptr()``) and ints without building
    ctypes objects."""
    fn = _bound.get((name, entry))
    if fn is None:
        lib = library(name)
        with _lock:
            fn = _bound.get((name, entry))
            if fn is None:
                fn = getattr(lib, entry)
                fn.argtypes = tuple(argtypes)
                _bound[(name, entry)] = fn
    return fn


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t.numel() == 0 else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, without building a
    Stream object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_CURRENT = contextlib.nullcontext()


def device_scope(device: torch.device):
    """A context under which CUDA ``device`` is the current device (a
    launch goes to the current device): a device switch only where it is
    not already the current one."""
    if device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on the CUDA ``device``. One pass of cheap tests first; the detailed
    ones, for their message, only where one of them fails."""
    if (type(t) is torch.Tensor and t.dtype is dtype and t.shape == shape
            and t.get_device() == device.index and device.type == "cuda"
            and t.is_contiguous()):
        return
    if device.type != "cuda":
        raise ValueError(f"{name}: kernels take CUDA tensors, got {device}")
    live(t, name)
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def donate(t: torch.Tensor) -> torch.Tensor:
    """A new tensor over ``t``'s memory, which an in-place launch has just
    rewritten; ``t`` itself is emptied (no storage, shape [0]) and marked,
    so that a launch that still reads it fails its checks and raises, as
    JAX's deleted donated buffer does, rather than reading the new rows."""
    new = t.detach()
    t.set_()
    t._kt_donated = True
    return new


def live(t, name: str) -> None:
    """Raise if ``t`` was donated away (``donate``)."""
    if getattr(t, "_kt_donated", False):
        raise ValueError(f"{name}: the tensor was donated away by an in-place row apply "
                         "(KTPU_DONATE_DELTA=1)")


NOTHING_LAUNCHED = -1  # csrc/common.cuh:kNothingLaunched (empty shapes)
CLUSTER_UNPLACED = -2  # csrc/common.cuh:kClusterUnplaced


def launched(name: str, rc: int, scenarios: int = 1, variants=()) -> None:
    """Count one launch of kernel ``name`` (and of each of its
    ``variants``) over ``scenarios`` scenarios; raise on a CUDA error
    code."""
    if rc == NOTHING_LAUNCHED:
        return
    if rc == CLUSTER_UNPLACED:
        raise KernelLaunchError(
            f"{name}: the card cannot place one thread-block cluster of the kernel's width "
            "(cudaOccupancyMaxActiveClusters is 0 with the kernel's shared memory)")
    if rc != 0:
        raise KernelLaunchError(f"{name}: CUDA error {rc} at launch")
    with _count_lock:
        for key in (name,) + tuple(variants):
            launches[key] += 1
            if scenarios > 1:
                scenario_launches[key] += 1
