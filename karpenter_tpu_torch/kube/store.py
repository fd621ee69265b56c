# Copied from karpenter_tpu/kube/store.py.
"""In-process typed object store standing in for the kube-apiserver.

The reference is level-triggered against a real apiserver: all durable state
lives in CRs, caches are rebuilt from watches, deletion is a two-phase
finalizer dance. This store reproduces those semantics in-process:

- objects are keyed by (kind, namespace, name) and carry resource versions;
- ``delete`` stamps ``deletion_timestamp`` when finalizers are present and
  only removes the object once the last finalizer is gone;
- watchers receive ADDED/MODIFIED/DELETED events synchronously, which is what
  the informer controllers in controllers/state consume.

Objects are stored by reference (single process); callers mutate copies and
``update`` them, mirroring client-go's update-by-replacement.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .. import faults
from .clock import Clock, RealClock

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(ValueError):
    pass


class ConflictError(ValueError):
    pass


@dataclass
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    kind: str
    object: object


def kind_of(obj) -> str:
    return type(obj).__name__


# indexed field selectors per kind: selector name -> extractor. The store
# maintains an exact index over these on every CRUD, so hot sweeps (the
# twin's informer rebuilds, per-node pod lookups at 100k-node scale) read
# the index instead of scanning every object of every kind.
_FIELD_EXTRACTORS: Dict[str, Dict[str, Callable[[object], Optional[str]]]] = {
    "Pod": {"spec.nodeName": lambda o: o.spec.node_name},
}

_EMPTY: frozenset = frozenset()


class Client:
    """Typed in-memory object store with watch + finalizer semantics.

    Reads are indexed: objects bucket per kind, and label values plus the
    ``_FIELD_EXTRACTORS`` fields maintain exact inverted indexes —
    ``list(kind, label_selector=..., field_selector=...)`` touches only
    matching objects (insertion-ordered, same as a full scan would
    return). The indexes are maintained on create/update/delete; mutating
    a stored object's labels WITHOUT ``update()`` is outside the store's
    contract (callers mutate copies and update them — module docstring)
    and leaves the index stale exactly like a real informer cache.
    """

    def __init__(
        self, clock: Optional[Clock] = None, fault_injection: bool = True
    ):
        self._clock = clock or RealClock()
        self._objects: Dict[Tuple[str, str, str], object] = {}
        self._by_uid: Dict[str, Tuple[str, str, str]] = {}
        # per-kind bucket + label/field inverted indexes; _indexed records
        # (insertion seq, indexed terms) per key so de-indexing is exact
        # even when the caller mutated the stored object before update()
        self._by_kind: Dict[str, Dict[Tuple[str, str, str], object]] = {}
        self._label_idx: Dict[tuple, set] = {}
        self._field_idx: Dict[tuple, set] = {}
        self._indexed: Dict[Tuple[str, str, str], Tuple[int, list]] = {}
        self._ins_seq = 0
        self._watchers: List[Callable[[Event], None]] = []
        self._lock = threading.RLock()
        self._rv = 0
        # fault_injection=False exempts this store from the chaos seams:
        # scratch stores (the solver's shipped-cluster-view rebuild in
        # solver/service.py) model plain memory, not an apiserver — a
        # store-chaos plan must not crash the very fallback path that
        # exists to survive the injected outage
        self._fault_injection = fault_injection

    # -- watch ------------------------------------------------------------

    def watch(self, handler: Callable[[Event], None]) -> None:
        self._watchers.append(handler)

    def _notify(self, event: Event) -> None:
        for handler in list(self._watchers):
            handler(event)

    # -- helpers ----------------------------------------------------------

    def _key(self, obj) -> Tuple[str, str, str]:
        meta = obj.metadata
        return (kind_of(obj), getattr(meta, "namespace", "default"), meta.name)

    def _bump(self, obj) -> None:
        self._rv += 1
        obj.metadata.resource_version = self._rv

    # -- index maintenance (call under self._lock) -------------------------

    def _index_insert(self, key, obj) -> None:
        kind = key[0]
        self._by_kind.setdefault(kind, {})[key] = obj
        terms: list = []
        labels = getattr(obj.metadata, "labels", None) or {}
        for k, v in labels.items():
            t = ("l", kind, k, v)
            self._label_idx.setdefault(t, set()).add(key)
            terms.append(t)
        for field, fn in _FIELD_EXTRACTORS.get(kind, {}).items():
            try:
                # analysis: ignore[LCK202] module-local pure attribute extractor, not a caller-registered callback — cannot reenter the store
                v = fn(obj)
            except AttributeError:
                v = None
            if v:
                t = ("f", kind, field, v)
                self._field_idx.setdefault(t, set()).add(key)
                terms.append(t)
        seq = self._indexed[key][0] if key in self._indexed else None
        if seq is None:
            self._ins_seq += 1
            seq = self._ins_seq
        self._indexed[key] = (seq, terms)

    def _index_drop(self, key, keep_seq: bool = False) -> None:
        entry = self._indexed.get(key)
        if entry is None:
            return
        seq, terms = entry
        for t in terms:
            d = self._label_idx if t[0] == "l" else self._field_idx
            s = d.get(t)
            if s is not None:
                s.discard(key)
                if not s:
                    del d[t]
        if keep_seq:
            # re-index of a replaced object: keep its insertion position
            # so selector results stay insertion-ordered like a full scan
            self._indexed[key] = (seq, [])
        else:
            del self._indexed[key]
            bucket = self._by_kind.get(key[0])
            if bucket is not None:
                bucket.pop(key, None)

    # -- CRUD -------------------------------------------------------------

    def create(self, obj):
        # chaos seam: a real apiserver returns transient 409s/timeouts;
        # fault plans inject ConflictError/latency here (faults/)
        if self._fault_injection:
            faults.hit(faults.STORE_CREATE, kind=kind_of(obj))
        with self._lock:
            key = self._key(obj)
            if key in self._objects:
                raise AlreadyExistsError(f"{key} already exists")
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self._clock.now()
            self._bump(obj)
            self._objects[key] = obj
            self._by_uid[obj.metadata.uid] = key
            self._index_insert(key, obj)
        self._notify(Event(ADDED, key[0], obj))
        return obj

    def get(self, kind, name: str, namespace: str = "default"):
        kind_name = kind if isinstance(kind, str) else kind.__name__
        with self._lock:
            obj = self._objects.get((kind_name, namespace, name))
        if obj is None:
            raise NotFoundError(f"{kind_name} {namespace}/{name} not found")
        return obj

    def get_by_uid(self, uid: str):
        with self._lock:
            key = self._by_uid.get(uid)
            if key is None:
                raise NotFoundError(f"uid {uid} not found")
            return self._objects[key]

    def try_get(self, kind, name: str, namespace: str = "default"):
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(
        self,
        kind,
        namespace: Optional[str] = None,
        predicate=None,
        label_selector: Optional[Dict[str, str]] = None,
        field_selector: Optional[Dict[str, str]] = None,
    ) -> List:
        """LIST a kind, optionally narrowed by exact-match selectors.

        ``label_selector``/``field_selector`` read the inverted indexes —
        cost is proportional to the MATCH, not the kind's population (the
        100k-node twin's informer-rebuild wall). Field selectors must name
        an indexed field (``_FIELD_EXTRACTORS``); unknown fields raise
        rather than silently full-scanning. Results keep the insertion
        order a full scan would return."""
        kind_name = kind if isinstance(kind, str) else kind.__name__
        with self._lock:
            if label_selector or field_selector:
                sets = []
                for k, v in (label_selector or {}).items():
                    sets.append(
                        self._label_idx.get(("l", kind_name, k, v), _EMPTY)
                    )
                for f, v in (field_selector or {}).items():
                    if f not in _FIELD_EXTRACTORS.get(kind_name, {}):
                        raise ValueError(
                            f"field selector {f!r} is not indexed for"
                            f" {kind_name} (see store._FIELD_EXTRACTORS)"
                        )
                    sets.append(
                        self._field_idx.get(("f", kind_name, f, v), _EMPTY)
                    )
                ordered = sorted(sets, key=len)
                keys = set(ordered[0])
                for s in ordered[1:]:
                    keys &= s
                out = [
                    self._objects[k2]
                    for k2 in sorted(keys, key=lambda k2: self._indexed[k2][0])
                    if namespace is None or k2[1] == namespace
                ]
            else:
                out = [
                    o
                    for (_, ns, _), o in self._by_kind.get(
                        kind_name, {}
                    ).items()
                    if namespace is None or ns == namespace
                ]
        if predicate is not None:
            out = [o for o in out if predicate(o)]
        return out

    def _reindex_stored(self, obj) -> None:
        """Re-derive the stored object's index terms from its CURRENT
        content. Callers that mutate the stored reference in place and
        then hit an injected conflict (the chaos seams below raise BEFORE
        the index maintenance runs) would otherwise leave the inverted
        indexes describing the pre-mutation object while a full scan sees
        the mutation — the index==scan invariant the selector reads are
        built on."""
        with self._lock:
            key = self._key(obj)
            stored = self._objects.get(key)
            if stored is not None:
                self._index_drop(key, keep_seq=True)
                self._index_insert(key, stored)

    def update(self, obj):
        if self._fault_injection:
            try:
                faults.hit(faults.STORE_UPDATE, kind=kind_of(obj))
            except Exception:
                self._reindex_stored(obj)
                raise
        with self._lock:
            key = self._key(obj)
            if key not in self._objects:
                raise NotFoundError(f"{key} not found")
            self._bump(obj)
            # de-index on the terms recorded at insert time (exact even
            # when the caller mutated the stored object before update),
            # keeping the insertion seq so list order matches a full scan
            self._index_drop(key, keep_seq=True)
            self._objects[key] = obj
            self._index_insert(key, obj)
        self._notify(Event(MODIFIED, key[0], obj))
        return obj

    def update_status(self, obj):
        # Single-store process: status updates are plain updates.
        return self.update(obj)

    def delete(self, obj, grace_period: Optional[float] = None):
        """Two-phase delete honoring finalizers (apiserver semantics)."""
        if self._fault_injection:
            try:
                faults.hit(faults.STORE_DELETE, kind=kind_of(obj))
            except Exception:
                # same healing as update(): the caller may have mutated
                # the stored reference before the injected failure
                self._reindex_stored(obj)
                raise
        with self._lock:
            key = self._key(obj)
            stored = self._objects.get(key)
            if stored is None:
                raise NotFoundError(f"{key} not found")
            if stored.metadata.finalizers:
                if stored.metadata.deletion_timestamp is None:
                    stored.metadata.deletion_timestamp = self._clock.now()
                    self._bump(stored)
                    event = Event(MODIFIED, key[0], stored)
                else:
                    return stored
            else:
                del self._objects[key]
                self._by_uid.pop(stored.metadata.uid, None)
                self._index_drop(key)
                event = Event(DELETED, key[0], stored)
        self._notify(event)
        return stored

    def remove_finalizer(self, obj, finalizer: str) -> None:
        """Drop a finalizer; completes deletion if it was the last one and the
        object was marked deleted."""
        with self._lock:
            key = self._key(obj)
            stored = self._objects.get(key)
            if stored is None:
                return
            if finalizer in stored.metadata.finalizers:
                stored.metadata.finalizers.remove(finalizer)
            if not stored.metadata.finalizers and stored.metadata.deletion_timestamp is not None:
                del self._objects[key]
                self._by_uid.pop(stored.metadata.uid, None)
                self._index_drop(key)
                event = Event(DELETED, key[0], stored)
            else:
                self._bump(stored)
                event = Event(MODIFIED, key[0], stored)
        self._notify(event)

    def deleted(self, obj) -> bool:
        return obj.metadata.deletion_timestamp is not None

    # -- checkpoint (sim/twin.py) -----------------------------------------

    def export_objects(self) -> dict:
        """Deep-copied objects in insertion order plus the resource-version
        counter — the store side of a twin checkpoint. Insertion order IS
        part of cluster state here: list() serves it, and the reconcile
        roster's iteration (and therefore replay determinism) follows it."""
        with self._lock:
            return {
                "rv": self._rv,
                "objects": [copy.deepcopy(o) for o in self._objects.values()],
            }

    def import_objects(self, state: dict) -> None:
        """Restore an export_objects() dump into an EMPTY store. No watch
        events fire — informer consumers (controllers/state.Cluster) are
        constructed AFTER the import and ingest via their LIST pass, the
        same recovery shape a live informer has after a restart."""
        with self._lock:
            if self._objects:
                raise ValueError("import_objects requires an empty store")
            for obj in state["objects"]:
                stored = copy.deepcopy(obj)
                key = self._key(stored)
                self._objects[key] = stored
                self._by_uid[stored.metadata.uid] = key
                self._index_insert(key, stored)
            self._rv = int(state["rv"])

    @property
    def clock(self) -> Clock:
        return self._clock
