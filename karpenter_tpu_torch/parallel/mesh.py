# Copied from karpenter_tpu/parallel/mesh.py, its axes, ARG_SPECS, the mesh factorizations and the pads; the Mesh, the placement and the sharded programs are the port's own.
"""The solver mesh: one solve over several devices, in one process.

The scaling axes map onto a 3-D ('scenario', 'data', 'model') mesh of
torch devices, as in the JAX package (karpenter_tpu/parallel/mesh.py):

- ``scenario`` — consolidation's what-if axis (S): each scenario block is
  an independent solve over the shared encoding, run by the block's own
  devices (``scenario_mesh`` moves the devices onto this axis);
- ``data`` — the live-pair axis (L) of the sparse feasibility index: each
  data shard takes a slice of ``gk_g``/``gk_k``/``gk_w`` and writes int32
  partial failure counts (kernel B1's and B2's partial modes);
- ``model`` — the instance types (T): each model shard takes a slice of
  the type and offering tables.

Group- and node-major arrays are replicated. The partials of every shard
are folded once, at the scan boundary, by one launch of the port's fold
kernel on the lead device (``csrc/mesh_fold.cu``), into the replicated
tables; the packing scan (B4) and the wire pack (B6) then run once, on the
lead device, over the full type tables it also holds. So no collective
runs inside the scan.

What differs from the JAX mesh, by design: the scan runs once, on the lead
device, where GSPMD replicates it on every device (the outputs are the
same, and JAX replicates them too); 'model' shards only the feasibility
stage, where JAX also shards the scan's type state; and the cross-device
movement is a copy of each shard's partials into the block's stacked
buffers on the lead device (none when they share a card: the shard's
kernel writes its slice there) plus the fold kernel, not NCCL: one process drives
every device, and a list of devices may name one card many times (the
port's counterpart of JAX's virtual CPU devices).

A sharded argument is held as one tensor per (device, slice); a replicated
one once per distinct device (``place``), so eight shards of one card hold
one copy of it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_SCENARIO = "scenario"
AXIS_DATA = "data"
AXIS_MODEL = "model"
MESH_AXES = (AXIS_SCENARIO, AXIS_DATA, AXIS_MODEL)

# Per-argument partition specs for EncodedSnapshot.solve_args /
# SOLVE_ARG_NAMES, as tuples of mesh-axis names (None = replicated dim;
# a missing tail is replicated). THE fixed r06 layout — the residency
# store, the padding, the scenario axis, and the SHP6xx shard-divisibility
# check all read this table.
#
#   replicated  g_* / p_* / n_* — scan-carried or scan-read state
#   'model'     t_* / o_* / a_tzc / a_res[T@1] / p_titype_ok[T@1] / t_mvoh
#   'data'      gk_g / gk_k / gk_w — the compacted live-pair axis
ARG_SPECS: Dict[str, Tuple[Optional[str], ...]] = {
    "g_count": (), "g_req": (), "g_def": (), "g_neg": (), "g_mask": (),
    "g_hcap": (), "g_haff": (),
    "g_dmode": (), "g_dkey": (), "g_dskew": (), "g_dmin0": (),
    "g_dprior": (), "g_dreg": (), "g_drank": (),
    "g_hstg": (), "g_hscap": (), "g_dtg": (),
    "g_hself": (), "g_hcontrib": (), "g_dcontrib": (),
    "p_def": (), "p_neg": (), "p_mask": (), "p_daemon": (),
    "p_limit": (), "p_has_limit": (), "p_tol": (),
    "p_titype_ok": (None, AXIS_MODEL),
    "t_def": (AXIS_MODEL,), "t_mask": (AXIS_MODEL,),
    "t_alloc": (AXIS_MODEL,), "t_cap": (AXIS_MODEL,),
    "o_avail": (AXIS_MODEL,), "o_zone": (AXIS_MODEL,),
    "o_ct": (AXIS_MODEL,),
    "a_tzc": (AXIS_MODEL,), "res_cap0": (), "a_res": (None, AXIS_MODEL),
    "n_def": (), "n_mask": (), "n_avail": (), "n_base": (), "n_tol": (),
    "n_hcnt": (),
    "n_dzone": (), "n_dct": (),
    "nh_cnt0": (), "dd0": (), "dtg_key": (),
    "well_known": (),
    "p_mvmin": (), "t_mvoh": (AXIS_MODEL,),
    "gk_g": (AXIS_DATA,), "gk_k": (AXIS_DATA,), "gk_w": (AXIS_DATA,),
    "goff_idx": (),
}

# the most shards (data x model) a mesh's fold takes, checked once by its
# wrapper (ops/feasibility.py:mesh_fold)
MAX_SHARDS = 64


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ('scenario', 'data', 'model') grid of torch devices.

    ``devices`` is a numpy object array of ``torch.device`` shaped
    (scenario, data, model); a device may appear many times. The lead
    device is the first. Hashable and compared by its devices and shape,
    because the residency store and the program caches key on it. A grid
    that mixes CPU and CUDA devices raises ValueError."""

    __slots__ = ("devices", "axis_names", "_key")

    def __init__(self, devices, axis_names: Tuple[str, ...] = MESH_AXES):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [_as_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        if arr.ndim != 3 or not flat:
            raise ValueError(f"a mesh is a non-empty 3-D grid of devices, got shape {arr.shape}")
        kinds = sorted({d.type for d in flat})
        if len(kinds) != 1 or kinds[0] not in ("cpu", "cuda"):
            raise ValueError(f"a mesh's devices are all CPU or all CUDA, got {kinds}")
        arr.reshape(-1)[:] = flat
        object.__setattr__(self, "devices", arr)
        object.__setattr__(self, "axis_names", tuple(axis_names))
        object.__setattr__(self, "_key", (arr.shape, tuple(str(d) for d in flat), self.axis_names))

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is immutable")

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __reduce__(self):
        return Mesh, (self.devices, self.axis_names)

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, lead={self.lead})"

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(x) for x in self.devices.shape)))

    @property
    def lead(self) -> torch.device:
        return self.devices.reshape(-1)[0]

    @property
    def kind(self) -> str:
        return self.lead.type


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    scenario: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ('scenario', 'data', 'model') mesh over the first n devices of
    ``devices`` (default: every CUDA card, cuda:0..n-1). ``devices`` may
    name one device many times. The plain solve puts every device on
    'data' by default, as in the JAX package; 'model' takes what ``data``
    leaves."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_as_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"requested {n} devices but only {len(devices)} available"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    scenario = scenario or 1
    if data is None:
        data = n // scenario
    if n % (scenario * data):
        raise ValueError(
            f"{n} devices do not factor as scenario={scenario} x data={data}"
            " x model"
        )
    model = n // (scenario * data)
    return Mesh(grid.reshape(scenario, data, model), MESH_AXES)


# derived scenario-major meshes, keyed by (base mesh, scenario dim): the
# same devices re-factorized so consolidation's embarrassingly parallel
# axis gets them
_SCENARIO_MESHES: Dict[tuple, Mesh] = {}


def scenario_mesh(mesh: Mesh, s: int) -> Mesh:
    """Re-factorize ``mesh``'s devices scenario-major for a batch of ``s``
    scenarios: the scenario axis takes the largest device count that
    divides ``s``; any remainder stays on 'data'. The base mesh's 'model'
    dimension is preserved, as in the JAX package."""
    model = int(mesh.devices.shape[MESH_AXES.index(AXIS_MODEL)])
    navail = int(np.prod(mesh.devices.shape)) // model
    sdim = 1
    while (
        sdim * 2 <= navail
        and s % (sdim * 2) == 0
        and navail % (sdim * 2) == 0
    ):
        sdim *= 2
    key = (mesh, sdim)
    out = _SCENARIO_MESHES.get(key)
    if out is None:
        out = _SCENARIO_MESHES[key] = Mesh(
            mesh.devices.reshape(sdim, navail // sdim, model), MESH_AXES
        )
    return out


def dense_mesh(mesh: Mesh) -> Mesh:
    """Re-factorize for the dense (non-sparse-segment) tables: 'data'
    shards only the live-pair index, which the dense and tiled paths never
    read, so 'data' folds into 'model' and the type tables shard instead.
    The 'scenario' dimension is preserved."""
    sdim, ddim, mdim = (int(x) for x in mesh.devices.shape)
    if ddim == 1:
        return mesh
    key = (mesh, "dense")
    out = _SCENARIO_MESHES.get(key)
    if out is None:
        out = _SCENARIO_MESHES[key] = Mesh(
            mesh.devices.reshape(sdim, 1, ddim * mdim), MESH_AXES
        )
    return out


def pad_axis(arr, axis: int, mult: int, fill=0):
    """Pad ``arr``'s ``axis`` up to a multiple of ``mult`` (shard-divisible
    after the encoder's pow2 bucketing; a pow2 axis >= the shard count is
    already divisible and returns unchanged)."""
    size = arr.shape[axis]
    target = ((size + mult - 1) // mult) * mult
    if target == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - size)
    return np.pad(arr, widths, constant_values=fill)


def pad_args_for_mesh(args, mesh):
    """Pad solve_core's argument tuple (EncodedSnapshot.solve_args order) so
    every sharded axis divides its mesh dimension: the T axis (types,
    offerings, availability) to a multiple of 'model', the segment
    live-pair axis L to a multiple of 'data'. Group- and node-major arrays
    are replicated in the r06 layout and need no padding. Padded types
    stay infeasible (p_titype_ok False, no offerings); padded live pairs
    carry weight 0 (a zero segment_sum contribution) and repeat group 0 in
    gk_g, so results are unchanged."""
    from ..solver.encode import SOLVE_ARG_NAMES

    model = mesh.devices.shape[MESH_AXES.index(AXIS_MODEL)]
    data = mesh.devices.shape[MESH_AXES.index(AXIS_DATA)]
    byname = dict(zip(SOLVE_ARG_NAMES, args))

    for name in ("t_def", "t_mask", "t_alloc", "t_cap",
                 "o_avail", "o_zone", "o_ct", "a_tzc", "t_mvoh"):
        byname[name] = pad_axis(byname[name], 0, model)
    byname["a_res"] = pad_axis(byname["a_res"], 1, model)
    # padded types stay infeasible for every template
    byname["p_titype_ok"] = pad_axis(byname["p_titype_ok"], 1, model)
    # the segment index names REAL group rows; L-axis padding appends
    # weight-0 pairs on group 0 — segment_sum ignores them exactly
    byname["gk_g"] = pad_axis(byname["gk_g"], 0, data)
    byname["gk_k"] = pad_axis(byname["gk_k"], 0, data)
    byname["gk_w"] = pad_axis(byname["gk_w"], 0, data)
    return tuple(byname[name] for name in SOLVE_ARG_NAMES)


# -- placement ----------------------------------------------------------------


def spec_of(name: str, stacked: bool = False) -> Tuple[Optional[str], ...]:
    """``name``'s partition spec; a scenario-stacked argument (g_count,
    n_tol and the topology priors of a scenario batch) gains a leading
    'scenario' axis."""
    spec = ARG_SPECS[name]
    return (AXIS_SCENARIO,) + spec if stacked else spec


def piece_key(spec, dims: Dict[str, int], coord: Dict[str, int],
              axes=MESH_AXES) -> tuple:
    """Which slice of an argument with partition ``spec`` the mesh
    position ``coord`` reads: ((array axis, shard index), ...) over the
    spec's axes among ``axes`` that have more than one shard; () is the
    whole array."""
    return tuple(
        (i, coord[ax]) for i, ax in enumerate(spec)
        if ax is not None and ax in axes and dims[ax] > 1
    )


def cut(arr, key: tuple, spec, dims: Dict[str, int]):
    """The slice ``key`` (``piece_key``) of ``arr`` (numpy or torch)."""
    for i, j in key:
        n = arr.shape[i] // dims[spec[i]]
        arr = arr[(slice(None),) * i + (slice(j * n, (j + 1) * n),)]
    return arr


def coords(mesh: Mesh):
    """Every mesh position as {'scenario': s, 'data': d, 'model': m}, in
    the devices' order."""
    for s, d, m in np.ndindex(*mesh.devices.shape):
        yield dict(zip(MESH_AXES, (s, d, m)))


def placements(spec, mesh: Mesh):
    """The (device, slice key) pairs an argument with partition ``spec``
    is held at: each position's slice on its device, and on each scenario
    block's lead device the block's slice of the whole array (what the
    block's scan reads). Distinct pairs only, in a fixed order."""
    dims = mesh.shape
    out = {}
    for c in coords(mesh):
        dev = mesh.devices[c[AXIS_SCENARIO], c[AXIS_DATA], c[AXIS_MODEL]]
        out[(dev, piece_key(spec, dims, c))] = None
        lead = mesh.devices[c[AXIS_SCENARIO], 0, 0]
        out[(lead, piece_key(spec, dims, c, axes=(AXIS_SCENARIO,)))] = None
    return tuple(out)


def place(name: str, host, mesh: Mesh, stacked: bool = False) -> Dict[tuple, torch.Tensor]:
    """``host`` (the whole padded argument, numpy) placed on ``mesh``: a
    dict {(device, slice key): tensor}, each slice copied once to each
    device that reads it."""
    from ..solver.args import put

    spec = spec_of(name, stacked)
    dims = mesh.shape
    return {
        (dev, key): put(name, cut(host, key, spec, dims), dev)
        for dev, key in placements(spec, mesh)
    }


def sliced(name: str, mesh: Mesh) -> bool:
    """Whether ``name`` is held in slices on ``mesh`` (a sharded axis with
    more than one shard), rather than whole on each device."""
    dims = mesh.shape
    return any(ax is not None and dims[ax] > 1 for ax in ARG_SPECS[name])


class MeshArgs:
    """One mesh dispatch's arguments: for each solve arg name, its placed
    tensors (``place``). ``at(name, s, d, m)`` is what position (s, d, m)
    reads; ``whole(name, s)`` is what scenario block s's scan reads on the
    block's lead device."""

    def __init__(self, mesh: Mesh, placed: Dict[str, Dict[tuple, torch.Tensor]],
                 stacked: frozenset = frozenset()):
        self.mesh = mesh
        self.placed = placed
        self.stacked = frozenset(stacked)

    def at(self, name: str, s: int, d: int, m: int) -> torch.Tensor:
        spec = spec_of(name, name in self.stacked)
        key = piece_key(spec, self.mesh.shape, dict(zip(MESH_AXES, (s, d, m))))
        return self.placed[name][(self.mesh.devices[s, d, m], key)]

    def whole(self, name: str, s: int = 0) -> torch.Tensor:
        spec = spec_of(name, name in self.stacked)
        key = piece_key(spec, self.mesh.shape, dict(zip(MESH_AXES, (s, 0, 0))),
                        axes=(AXIS_SCENARIO,))
        return self.placed[name][(self.mesh.devices[s, 0, 0], key)]


def place_args(args, mesh: Mesh, stacked: frozenset = frozenset()) -> MeshArgs:
    """The whole padded solve args (numpy, SOLVE_ARG_NAMES order) placed on
    ``mesh``; ``stacked`` names carry a leading scenario axis."""
    from ..solver.encode import SOLVE_ARG_NAMES

    return MeshArgs(mesh, {
        name: place(name, a, mesh, name in stacked) for name, a in zip(SOLVE_ARG_NAMES, args)
    }, stacked)


def shard_args(args, mesh: Mesh, stacked: frozenset = frozenset()):
    """The whole padded host args cut by ARG_SPECS into each position's
    pieces: {(s, d, m): tuple in SOLVE_ARG_NAMES order} (views, no copy)."""
    from ..solver.encode import SOLVE_ARG_NAMES

    dims = mesh.shape
    out = {}
    for c in coords(mesh):
        out[(c[AXIS_SCENARIO], c[AXIS_DATA], c[AXIS_MODEL])] = tuple(
            cut(a, piece_key(spec_of(n, n in stacked), dims, c), spec_of(n, n in stacked), dims)
            for n, a in zip(SOLVE_ARG_NAMES, args)
        )
    return out


# -- the sharded programs -----------------------------------------------------

# sharded programs keyed by (mesh, statics), as the JAX package caches its
# jitted ones
_SHARDED_FNS: Dict[tuple, object] = {}


def _mesh_args(args, mesh: Mesh, stacked: frozenset) -> MeshArgs:
    """The program's one MeshArgs, or the padded args placed on ``mesh``."""
    if len(args) == 1 and isinstance(args[0], MeshArgs):
        return args[0]
    return place_args(args, mesh, stacked)


def sharded_solve_fn(
    mesh, nmax: int, zone_kid: int, ct_kid: int, has_domains: bool = True,
    has_contrib: bool = False, tile_feasibility: bool = False,
    wf_iters: int = 32, sparse_groups: bool = False,
):
    """The full solve over the mesh (unpacked outputs — the measurement and
    test surface): ``fn(*padded_args)`` or ``fn(mesh_args)`` returns the
    10 outputs on the lead device."""
    from ..ops.solve import solve_core_mesh

    key = (
        "solve", mesh, nmax, zone_kid, ct_kid, has_domains, has_contrib,
        tile_feasibility, wf_iters, sparse_groups,
    )
    fn = _SHARDED_FNS.get(key)
    if fn is None:
        core = functools.partial(
            solve_core_mesh, mesh=mesh, nmax=nmax, zone_kid=zone_kid, ct_kid=ct_kid,
            has_domains=has_domains, has_contrib=has_contrib,
            tile_feasibility=tile_feasibility, wf_iters=wf_iters,
            sparse_groups=sparse_groups,
        )
        fn = _SHARDED_FNS[key] = lambda *args: core(_mesh_args(args, mesh, frozenset()))
    return fn


def sharded_solve_packed_fn(mesh, fills_dtype, **statics):
    """The wire-packed solve over the mesh — the driver's dispatch: its
    outputs equal the single-device dispatch's bit for bit."""
    from ..ops.solve import solve_core_mesh_packed

    key = ("packed", mesh, fills_dtype) + tuple(sorted(statics.items()))
    fn = _SHARDED_FNS.get(key)
    if fn is None:
        core = functools.partial(
            solve_core_mesh_packed, mesh=mesh, fills_dtype=fills_dtype, **statics,
        )
        fn = _SHARDED_FNS[key] = lambda *args: core(_mesh_args(args, mesh, frozenset()))
    return fn


def sharded_scenarios_fn(mesh, fills_dtype, batch_topo: bool, **statics):
    """The scenario-batched dispatch over the mesh: the stacked args are
    cut on the leading 'scenario' axis, each scenario block solved by its
    own devices, the outputs gathered on the lead device."""
    from ..ops.solve import SCENARIO_BATCHED_ARGS, SCENARIO_TOPO_BATCHED_ARGS
    from ..ops.solve import solve_scenarios_core_mesh_packed

    key = (
        ("scenarios", mesh, fills_dtype, batch_topo)
        + tuple(sorted(statics.items()))
    )
    fn = _SHARDED_FNS.get(key)
    if fn is None:
        stacked = frozenset(SCENARIO_TOPO_BATCHED_ARGS if batch_topo else SCENARIO_BATCHED_ARGS)
        core = functools.partial(
            solve_scenarios_core_mesh_packed, mesh=mesh, fills_dtype=fills_dtype,
            batch_topo=batch_topo, **statics,
        )
        fn = _SHARDED_FNS[key] = lambda *args: core(_mesh_args(args, mesh, stacked))
    return fn
