# Copied from karpenter_tpu/native/__init__.py.
"""Native (C++) host solver runtime.

``solve_core_native`` is a drop-in for ops/solve.py::solve_core operating on
the same EncodedSnapshot.solve_args(...) tuple — compiled from
native/solve_core.cc and loaded through ctypes. It serves as the host
fallback when no accelerator is attached (SolverConfig.backend='native') and
as the independent implementation the JAX kernel is parity-tested against.

The shared library is built on first use with g++ (-O2 -shared -fPIC) and
cached next to the source; rebuilt when the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .. import faults

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "solve_core.cc")
_LIB = os.path.join(_HERE, "libkt_solver.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def build(force: bool = False) -> str:
    """Compile the shared library if missing or stale; returns its path."""
    with _lock:
        if (
            not force
            and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
        ):
            return _LIB
        cmd = [
            "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
            "-o", _LIB, _SRC,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}"
            )
        return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        # chaos seam: a missing toolchain / corrupt .so on a fresh host
        # surfaces as NativeBuildError, which the solver's degradation
        # ladder turns into an oracle fallback instead of a crashed solve
        faults.hit(faults.NATIVE_LOAD)
        path = build()
        lib = ctypes.CDLL(path)
        lib.kt_solve.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except (NativeBuildError, OSError):
        return False


def _as(arr, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr), dtype=dtype)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def solve_core_native(
    g_count, g_req, g_def, g_neg, g_mask, g_hcap, g_haff,
    g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior, g_dreg, g_drank,
    g_hstg, g_hscap, g_dtg,
    g_hself, g_hcontrib, g_dcontrib,
    p_def, p_neg, p_mask, p_daemon, p_limit, p_has_limit, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc, t_cap,
    o_avail, o_zone, o_ct,
    a_tzc, res_cap0, a_res,
    n_def, n_mask, n_avail, n_base, n_tol, n_hcnt, n_dzone, n_dct,
    nh_cnt0, dd0, dtg_key,
    well_known,
    p_mvmin, t_mvoh,
    gk_g=None, gk_k=None, gk_w=None, goff_idx=None,
    nmax: int = 0,
    zone_kid: int = 0,
    ct_kid: int = 0,
    has_domains: bool = True,  # trace-time gate for the JAX twin; unused here
    has_contrib: bool = False,  # trace-time gate for the JAX twin; unused here
    tile_feasibility: bool = False,  # JAX execution strategy; unused here
    wf_iters: int = 32,  # JAX bisection budget; the C++ core is exact
    sparse_groups: bool = False,  # JAX table strategy; the core is sparse-always
) -> Tuple[np.ndarray, ...]:
    """Same contract as ops/solve.py::solve_core (and solve_all), on host.

    ``has_domains`` is accepted for call-site symmetry with the jitted
    kernel; the C++ core branches on g_dmode at runtime, so no gating is
    needed. The compacted segment index (gk_*/goff_idx) is likewise
    accepted for tuple symmetry but not marshalled: the core derives the
    same neutral-row mask internally (solve_core.cc feasibility section)
    and applies the identical hoisted-base + live-pair-correction
    structure unconditionally."""
    lib = _load()

    g_count = _as(g_count, np.int32)
    g_hcap = _as(g_hcap, np.int32)
    g_haff = _as(g_haff, np.uint8)
    n_hcnt = _as(n_hcnt, np.int32)
    g_req = _as(g_req, np.float32)
    g_dmode = _as(g_dmode, np.int32)
    g_dkey = _as(g_dkey, np.int32)
    g_dskew = _as(g_dskew, np.int32)
    g_dmin0 = _as(g_dmin0, np.uint8)
    g_dprior = _as(g_dprior, np.int32)
    g_dreg = _as(g_dreg, np.uint8)
    g_drank = _as(g_drank, np.int32)
    n_dzone = _as(n_dzone, np.int32)
    n_dct = _as(n_dct, np.int32)
    g_hstg = _as(g_hstg, np.int32)
    g_hscap = _as(g_hscap, np.int32)
    g_dtg = _as(g_dtg, np.int32)
    g_hself = _as(g_hself, np.uint8)
    g_hcontrib = _as(g_hcontrib, np.uint8)
    g_dcontrib = _as(g_dcontrib, np.uint8)
    nh_cnt0 = _as(nh_cnt0, np.int32)
    dd0 = _as(dd0, np.int32)
    dtg_key = _as(dtg_key, np.int32)
    res_cap0 = _as(res_cap0, np.int32)
    a_res = _as(a_res, np.uint8)
    g_def, g_neg, g_mask = (_as(x, np.uint8) for x in (g_def, g_neg, g_mask))
    p_def, p_neg, p_mask = (_as(x, np.uint8) for x in (p_def, p_neg, p_mask))
    p_daemon = _as(p_daemon, np.float32)
    p_limit = _as(p_limit, np.float32)
    p_has_limit = _as(p_has_limit, np.uint8)
    p_tol = _as(p_tol, np.uint8)
    p_titype_ok = _as(p_titype_ok, np.uint8)
    t_def, t_mask = _as(t_def, np.uint8), _as(t_mask, np.uint8)
    t_alloc, t_cap = _as(t_alloc, np.float32), _as(t_cap, np.float32)
    o_avail = _as(o_avail, np.uint8)
    o_zone, o_ct = _as(o_zone, np.int32), _as(o_ct, np.int32)
    a_tzc = _as(a_tzc, np.uint8)
    n_def, n_mask = _as(n_def, np.uint8), _as(n_mask, np.uint8)
    n_avail, n_base = _as(n_avail, np.float32), _as(n_base, np.float32)
    n_tol = _as(n_tol, np.uint8)
    well_known = _as(well_known, np.uint8)
    p_mvmin = _as(p_mvmin, np.int32)
    t_mvoh = _as(t_mvoh, np.uint8)

    G = g_count.shape[0]
    P, K = p_def.shape
    V1 = g_mask.shape[2] if G else p_mask.shape[2]
    T, R = t_alloc.shape
    O = o_avail.shape[1] if o_avail.size else 0
    N = n_avail.shape[0]
    JH = nh_cnt0.shape[1] if nh_cnt0.ndim == 2 else 1
    JD = dd0.shape[0] if dd0.ndim == 2 else 1
    NRES = res_cap0.shape[0]
    MV = p_mvmin.shape[1] if p_mvmin.ndim == 2 else 0
    MW = t_mvoh.shape[2] if t_mvoh.ndim == 3 else 1

    c_pool = np.zeros(nmax, np.int32)
    c_tmask = np.zeros((nmax, T), np.uint8)
    n_open = np.zeros(1, np.int32)
    overflow = np.zeros(1, np.uint8)
    exist_fills = np.zeros((G, max(N, 1)), np.int32)
    claim_fills = np.zeros((G, nmax), np.int32)
    unplaced = np.zeros(G, np.int32)
    c_dzone = np.full(nmax, -1, np.int32)
    c_dct = np.full(nmax, -1, np.int32)
    c_resv = np.zeros(nmax, np.uint8)

    lib.kt_solve(
        ctypes.c_int(G), ctypes.c_int(T), ctypes.c_int(P), ctypes.c_int(N),
        ctypes.c_int(R), ctypes.c_int(K), ctypes.c_int(V1), ctypes.c_int(O),
        ctypes.c_int(nmax), ctypes.c_int(zone_kid), ctypes.c_int(ct_kid),
        ctypes.c_int(JH), ctypes.c_int(JD), ctypes.c_int(NRES),
        ctypes.c_int(MV), ctypes.c_int(MW),
        _ptr(g_count), _ptr(g_req), _ptr(g_def), _ptr(g_neg), _ptr(g_mask),
        _ptr(g_hcap), _ptr(g_haff),
        _ptr(g_dmode), _ptr(g_dkey), _ptr(g_dskew), _ptr(g_dmin0),
        _ptr(g_dprior), _ptr(g_dreg), _ptr(g_drank),
        _ptr(g_hstg), _ptr(g_hscap), _ptr(g_dtg),
        _ptr(g_hself), _ptr(g_hcontrib), _ptr(g_dcontrib),
        _ptr(p_def), _ptr(p_neg), _ptr(p_mask), _ptr(p_daemon), _ptr(p_limit),
        _ptr(p_has_limit), _ptr(p_tol), _ptr(p_titype_ok),
        _ptr(t_def), _ptr(t_mask), _ptr(t_alloc), _ptr(t_cap),
        _ptr(o_avail), _ptr(o_zone), _ptr(o_ct),
        _ptr(a_tzc), _ptr(res_cap0), _ptr(a_res),
        _ptr(n_def), _ptr(n_mask), _ptr(n_avail), _ptr(n_base), _ptr(n_tol),
        _ptr(n_hcnt),
        _ptr(n_dzone), _ptr(n_dct),
        _ptr(nh_cnt0), _ptr(dd0), _ptr(dtg_key),
        _ptr(well_known),
        _ptr(p_mvmin), _ptr(t_mvoh),
        _ptr(c_pool), _ptr(c_tmask), _ptr(n_open), _ptr(overflow),
        _ptr(exist_fills), _ptr(claim_fills), _ptr(unplaced),
        _ptr(c_dzone), _ptr(c_dct), _ptr(c_resv),
    )
    return (
        c_pool,
        c_tmask.astype(bool),
        n_open[0],
        bool(overflow[0]),
        exist_fills[:, :N],
        claim_fills,
        unplaced,
        c_dzone,
        c_dct,
        c_resv.astype(bool),
    )
