# Copied from karpenter_tpu/solver/residency.py, with torch tensors as buffers, placed on a mesh by parallel/mesh.py:place.
"""Device-resident solve arguments + the two-slot async dispatch queue.

The delta-encode layer (solver/encode.py:ClusterEncoding) makes the HOST
side of a reconcile marginal-cost; this module does the same for the
host→device boundary so steady-state churn transfers the *delta*, not the
snapshot:

- ``DeviceResidentArgs`` keeps the encoded cluster tensors resident on
  device between solves. Buffers are keyed by the EncodeDelta's per-class
  version counters: an unchanged class reuses its device buffer with zero
  transfer; a class whose buffer is exactly one encode behind re-transfers
  only the changed rows and applies them on device
  (``ops/solve.py:delta_apply_rows``, kernel B8 on CUDA; donation, the
  in-place write, is opt-in with KTPU_DONATE_DELTA=1, see its module
  note); everything else is a full copy onto the device.
- Under a solver mesh (parallel/mesh.py) the same store keeps each
  argument as its placement on the mesh: a replicated argument once per
  distinct device, a sharded one as one tensor per (device, slice), and
  the whole type tables on the lead device for the scan. REUSE and row
  deltas come out as on one device: a row delta patches each copy of a
  replicated argument (one B8 launch per distinct device); a sharded
  argument (whose class never carries row deltas: static, or
  NO_ROW_DELTA) restages whole.
- ``DispatchQueue`` is the explicit two-slot dispatch window: a CUDA
  launch returns before the card finishes, so a submitted kernel computes
  while the host encodes the next batch (or decodes the previous one).
  The queue makes the overlap an auditable object: depth instant events
  on the open span, a named fault site (faults.DISPATCH_QUEUE) for chaos
  coverage, and a hard two-slot bound so a runaway caller cannot pile
  uncollected work onto the card.

Neither object reads device values back: draining a slot returns the
device tensors, and the single readback stays in solver/driver.py.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults, obs
from .args import put

# SOLVE_ARG_NAMES partitioned into device-buffer classes. Versions come
# from EncodeDelta (encode.py): a class's buffers are reusable iff its
# version counter is unchanged since they were staged.
NODE_ROW_ARGS = frozenset(
    {"n_avail", "n_base", "n_def", "n_mask", "n_dzone", "n_dct"}
)
CROSS_ARGS = frozenset({"n_tol", "n_hcnt", "nh_cnt0"})
GROUP_ARGS = frozenset(
    {
        "g_req", "g_def", "g_neg", "g_mask", "g_hcap", "g_haff",
        "g_dmode", "g_dkey", "g_dskew", "g_dmin0", "g_dprior", "g_dreg",
        "g_drank", "g_hstg", "g_hscap", "g_dtg", "g_hself", "g_hcontrib",
        "g_dcontrib", "dd0", "dtg_key", "p_tol",
        # the compacted segment index is a pure function of the group
        # requirement rows, so it versions with the group class; its
        # leading axis is the live-pair bucket L, not G (NO_ROW_DELTA)
        "gk_g", "gk_k", "gk_w", "goff_idx",
    }
)
# g_count is its own class: count-only churn (the steady-state reconcile
# shape) moves ONLY this [G] vector, so the heavy group masks keep their
# device buffers while the counts ride a tiny row delta
GCOUNT_ARGS = frozenset({"g_count"})
# group-class members whose leading axis is NOT the group axis (dd0 and
# dtg_key ride the shared-constraint slot axis, p_tol carries G on axis 1):
# they restage whole on a version bump, never row-by-row — a group-axis
# index applied to them would silently clamp
NO_ROW_DELTA = frozenset(
    {"dd0", "dtg_key", "p_tol", "gk_g", "gk_k", "gk_w", "goff_idx"}
)

class DeviceResidentArgs:
    """Version-keyed device buffers for one catalog's solve arguments.

    Owned by the long-lived EncodeCache (it must outlive TorchSolver
    instances, which the provisioner rebuilds per solve). ``stage``
    returns the argument list with every host array replaced by its
    device-resident buffer, transferring only what the EncodeDelta proves
    changed. ``last_incremental`` reports whether anything was reused or
    delta-applied (the driver's corrupt-delta fallback consults it), and
    ``last_delta_rows``/``last_full_puts`` feed the bench/audit columns.
    """

    def __init__(self, owner: str = ""):
        import threading

        # multi-tenant attribution: whose device buffers these are — rides
        # the ENCODE_DELTA mutate ctx so chaos plans can corrupt exactly
        # one tenant's deltas
        self.owner = owner
        self._dev_buffers: Dict[str, torch.Tensor] = {}
        self._meta: Dict[str, Tuple[int, tuple, object]] = {}
        # concurrent solves serialize staging here: the host-side encode
        # already serializes on EncodeCache.lock, and the buffer map +
        # version bookkeeping need the same discipline. Buffer updates
        # are out of place by default (ops/solve.py) so a launched
        # dispatch's reference to a replaced buffer stays valid; under
        # KTPU_DONATE_DELTA=1 the replaced tensor is emptied instead, and
        # a queue token still holding it raises at its next launch.
        self._lock = threading.Lock()
        # the device and the mesh signature of the resident buffers:
        # staging for another device or mesh (or switching mesh <->
        # single device) sheds every buffer first
        self._device: Optional[torch.device] = None
        self._mesh_key: object = None
        self.last_incremental = False
        self.last_delta_rows = 0
        self.last_full_puts = 0

    def reset(self) -> None:
        """Drop every device buffer (catalog change, corrupt-delta
        fallback): the next stage() is a clean full transfer."""
        with self._lock:
            self._dev_buffers.clear()
            self._meta.clear()
            self.last_incremental = False

    @staticmethod
    def _class_of(name: str, delta) -> Tuple[int, Optional[np.ndarray]]:
        """(version, row-delta indices or None) for an arg name."""
        if name in NODE_ROW_ARGS:
            return delta.v_nodes, delta.node_rows
        if name in CROSS_ARGS:
            return delta.v_cross, delta.cross_rows
        if name in GCOUNT_ARGS:
            rows = (
                delta.count_rows
                if delta.count_rows is not None
                else delta.group_rows
            )
            return delta.v_gcount, rows
        if name in GROUP_ARGS:
            rows = None if name in NO_ROW_DELTA else delta.group_rows
            return delta.v_groups, rows
        return delta.v_static, None

    def stage(
        self,
        names: Sequence[str],
        host_args: Sequence,
        delta,
        device,
        skip: frozenset = frozenset(),
        mesh=None,
    ) -> List:
        """Device-resident argument list aligned with ``names``.

        ``skip`` names pass through untouched (the scenario axis overrides
        g_count/n_tol with per-scenario stacks that are staged by the
        caller). Emits one ``solve.delta_apply`` span covering the
        row-level updates (delta_rows/reused attrs ride it for the trace
        smoke and the churn bench). A ``device`` or ``mesh`` other than the
        resident buffers' sheds every buffer first.

        With ``mesh`` (parallel/mesh.py:Mesh; the host args already padded
        for it) each entry is the argument's placement on the mesh, a dict
        {(device, slice key): tensor} (parallel/mesh.py:MeshArgs reads it).
        """
        from ..ops.solve import delta_apply_rows

        device = torch.device(device)
        with self._lock:
            if device != self._device or mesh != self._mesh_key:
                self._dev_buffers.clear()
                self._meta.clear()
                self._device = device
                self._mesh_key = mesh
            if mesh is None:
                return self._stage_locked(
                    names, host_args, delta, skip,
                    lambda name, host: put(name, host, device), delta_apply_rows,
                )
            from ..parallel.mesh import place, sliced

            def apply_each(placed, rows, vals):
                return {k: delta_apply_rows(t, rows, vals) for k, t in placed.items()}

            return self._stage_locked(
                names, host_args, delta, skip,
                lambda name, host: place(name, host, mesh), apply_each,
                row_ok=lambda name: not sliced(name, mesh),
            )

    def _stage_locked(
        self, names, host_args, delta, skip, put_fn, delta_apply_rows,
        row_ok=lambda name: True,
    ) -> List:
        out: List = []
        applies: List[Tuple[str, int, np.ndarray, np.ndarray]] = []
        reused = 0
        puts = 0
        for name, host in zip(names, host_args):
            if name in skip or not isinstance(host, np.ndarray):
                out.append(host)
                continue
            version, rows = self._class_of(name, delta)
            if not row_ok(name):
                rows = None
            meta = self._meta.get(name)
            sig = (version, host.shape, host.dtype)
            if meta is not None and meta == sig:
                out.append(self._dev_buffers[name])
                reused += 1
                continue
            if (
                meta is not None
                and rows is not None
                and len(rows)
                and meta[0] == version - 1
                and meta[1] == host.shape
                and meta[2] == host.dtype
            ):
                # shape-stable row delta — valid ONLY when the resident
                # buffer is exactly one version step behind AND this
                # encode is the step: a class version bumps exactly when
                # its tags change, and the diff is nonempty exactly then,
                # so nonempty rows + version-1 proves the rows describe
                # the buffer's own transition. Encodes can pass without a
                # stage (a scenario batch declining after its encode, a
                # skipped per-scenario arg); an EMPTY diff with a version
                # gap means the change happened at one of those unstaged
                # encodes — patching nothing and stamping the buffer
                # current would feed the kernel content from two encodes
                # ago, so it restages whole.
                applies.append((name, version, host, rows))
                out.append(None)  # patched below, order preserved
                continue
            buf = put_fn(name, host)
            self._dev_buffers[name] = buf
            self._meta[name] = sig
            out.append(buf)
            puts += 1
        delta_rows = 0
        if applies:
            pos = {name: i for i, name in enumerate(names)}
            with obs.span(
                "solve.delta_apply",
                arrays=len(applies),
                delta_rows=int(sum(len(r) for *_x, r in applies)),
            ):
                for name, version, host, rows in applies:
                    vals = host[rows]
                    # chaos seam: a corrupt delta lands HERE, on the wire
                    # rows — the pre-decode invariant guard must catch the
                    # resulting solve and force a full re-encode
                    vals = faults.mutate(
                        faults.ENCODE_DELTA, vals, name=name,
                        rows=len(rows), owner=self.owner,
                    )
                    buf = delta_apply_rows(self._dev_buffers[name], rows, vals)
                    self._dev_buffers[name] = buf
                    self._meta[name] = (version, host.shape, host.dtype)
                    out[pos[name]] = buf
                    delta_rows += len(rows)
        self.last_incremental = bool(reused or applies)
        self.last_delta_rows = delta_rows
        self.last_full_puts = puts
        return out


class DispatchQueue:
    """Explicit two-slot window over async kernel dispatches.

    ``submit(label, fn)`` runs ``fn`` immediately — a CUDA launch
    returns before the card finishes, so the call does not block on the
    device — and tracks the slot; a third in-flight submit evicts the
    oldest slot (its device work completes and its tensors are dropped:
    the caching allocator reuses their memory in stream order; the
    two-slot bound keeps device memory and speculation bounded).
    ``drain(slot)`` hands back the submitted call's outputs and frees the
    slot. Both edges emit
    ``queue.depth`` instant events on the open span and consult the
    ``faults.DISPATCH_QUEUE`` site, so chaos plans can crash either edge
    and traces show the overlap window.
    """

    DEPTH = 2

    def __init__(self):
        self._slots: deque = deque()
        self._seq = 0

    def depth(self) -> int:
        return len(self._slots)

    def submit(self, label: str, fn):
        faults.hit(
            faults.DISPATCH_QUEUE, op="submit", label=label,
            depth=len(self._slots),
        )
        while len(self._slots) >= self.DEPTH:
            # evict the oldest uncollected slot: its device computation
            # finishes on its own; the caller that abandoned it never
            # drains (speculative prefetch that lost the race)
            stale = self._slots.popleft()
            obs.event("queue.evict", label=stale["label"])
        self._seq += 1
        slot = {"label": label, "seq": self._seq, "out": fn()}
        self._slots.append(slot)
        obs.event("queue.depth", depth=len(self._slots), op="submit",
                  label=label)
        return slot

    def drain(self, slot):
        faults.hit(
            faults.DISPATCH_QUEUE, op="drain", label=slot["label"],
            depth=len(self._slots),
        )
        try:
            self._slots.remove(slot)
        except ValueError:
            pass  # already evicted; its outputs are still valid futures
        obs.event("queue.depth", depth=len(self._slots), op="drain",
                  label=slot["label"])
        return slot["out"]


__all__ = [
    "DeviceResidentArgs", "DispatchQueue",
    "NODE_ROW_ARGS", "CROSS_ARGS", "GROUP_ARGS", "GCOUNT_ARGS",
    "NO_ROW_DELTA",
]
