# Copied from karpenter_tpu/kube/filestore.py.
"""File-backed store: the second backend behind the Client seam.

The reference's controllers speak to ANY apiserver through client-go
(operator.go:105-223; its tests boot a real envtest apiserver,
pkg/test/environment.go:138-197). The in-process store (kube/store.py) is
this framework's default backend; this module proves the Client surface is
a genuine seam by providing a second implementation with *apiserver-like*
semantics the in-process store cannot check:

- every object round-trips through serialization on each CRUD — readers
  get fresh copies, so nothing in the control plane can depend on shared
  object references (the failure mode a real wire protocol would expose);
- all durable state lives on disk — a new FileClient over the same
  directory resumes the cluster (the checkpoint/resume story: the store IS
  the checkpoint, matching the reference's level-triggered recovery).

tests/test_housekeeping.py runs its controller suite over both backends;
tests/test_filestore.py covers the persistence/restart semantics.
"""

from __future__ import annotations

import os
import pickle
import threading
from contextlib import contextmanager
from typing import Optional

from .clock import Clock
from .store import Client, Event


def _fs_escape(part: str) -> str:
    return part.replace("/", "_SL_").replace(":", "_CO_")


class FileClient(Client):
    """Client with write-through pickle persistence and copy semantics."""

    def __init__(self, clock: Optional[Clock] = None, root: str = None):
        super().__init__(clock)
        if root is None:
            raise ValueError("FileClient requires a root directory")
        self._root = root
        self._tls = threading.local()
        os.makedirs(root, exist_ok=True)
        self._load()

    # -- persistence ------------------------------------------------------

    def _path(self, key) -> str:
        kind, ns, name = key
        return os.path.join(
            self._root, _fs_escape(kind),
            f"{_fs_escape(ns)}__{_fs_escape(name)}.pkl",
        )

    def _load(self) -> None:
        for kind in sorted(os.listdir(self._root)):
            kdir = os.path.join(self._root, kind)
            if not os.path.isdir(kdir):
                continue
            for fname in sorted(os.listdir(kdir)):
                with open(os.path.join(kdir, fname), "rb") as fh:
                    obj = pickle.load(fh)
                key = self._key(obj)
                self._objects[key] = obj
                self._by_uid[obj.metadata.uid] = key
                self._index_insert(key, obj)
                self._rv = max(self._rv, obj.metadata.resource_version or 0)

    def _sync(self, key) -> None:
        """Write-through: the stored object's file mirrors the dict."""
        path = self._path(key)
        obj = self._objects.get(key)
        if obj is None:
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(obj, fh)
        os.replace(tmp, path)

    @staticmethod
    def _copy(obj):
        # serialization round-trip, not copy.deepcopy: this is the point of
        # the backend — anything unpicklable or reference-dependent fails
        # HERE rather than at a future process boundary
        return pickle.loads(pickle.dumps(obj))

    # -- Client overrides -------------------------------------------------

    @contextmanager
    def _atomic(self):
        """Dict mutation + disk sync under one lock, watcher notification
        AFTER release. Without the lock, two racing writers can persist
        the OLDER version last (a restart would resume a state no watcher
        ever saw); but the base Client deliberately notifies OUTSIDE its
        lock — informer handlers take their own locks and also call back
        into client reads, so notifying under the store lock is a classic
        ABBA deadlock. Events buffer (with their under-lock snapshot
        copies) and emit on exit."""
        if getattr(self._tls, "pending", None) is not None:
            yield  # nested: the outermost frame owns emission
            return
        buf: list = []
        self._tls.pending = buf
        try:
            with self._lock:
                yield
        finally:
            self._tls.pending = None
        for ev in buf:
            for handler in list(self._watchers):
                # one fresh copy PER handler: watchers must not observe
                # each other's mutations either
                handler(Event(ev.type, ev.kind, self._copy(ev.object)))

    def _notify(self, event: Event) -> None:
        buf = getattr(self._tls, "pending", None)
        snapshot = Event(event.type, event.kind, self._copy(event.object))
        if buf is not None:
            buf.append(snapshot)
            return
        # safe despite running under the base class's lock on paths like
        # Client.create -> _notify: every FileClient CRUD enters through
        # _atomic, which installs the TLS pending buffer BEFORE taking the
        # lock, so under the lock this fallback is unreachable (the branch
        # above buffers). It only fires for lock-free notify paths.
        for handler in list(self._watchers):
            # analysis: ignore[LCK202] TLS pending buffer set before lock acquisition makes this branch lock-free
            handler(Event(snapshot.type, snapshot.kind, self._copy(snapshot.object)))

    def create(self, obj):
        stored = self._copy(obj)
        with self._atomic():
            super().create(stored)
            self._sync(self._key(stored))
        # the caller's handle gets the server-stamped metadata, like a
        # client receiving the created object back
        obj.metadata.resource_version = stored.metadata.resource_version
        obj.metadata.creation_timestamp = stored.metadata.creation_timestamp
        return obj

    def get(self, kind, name: str, namespace: str = "default"):
        return self._copy(super().get(kind, name, namespace))

    def get_by_uid(self, uid: str):
        return self._copy(super().get_by_uid(uid))

    def list(self, kind, namespace=None, predicate=None,
             label_selector=None, field_selector=None):
        out = [
            self._copy(o)
            for o in super().list(
                kind, namespace,
                label_selector=label_selector, field_selector=field_selector,
            )
        ]
        if predicate is not None:
            out = [o for o in out if predicate(o)]
        return out

    def update(self, obj):
        stored = self._copy(obj)
        with self._atomic():
            super().update(stored)
            self._sync(self._key(stored))
        obj.metadata.resource_version = stored.metadata.resource_version
        return obj

    def delete(self, obj, grace_period: Optional[float] = None):
        with self._atomic():
            stored = super().delete(obj, grace_period)
            self._sync(self._key(stored))
        return self._copy(stored)

    def remove_finalizer(self, obj, finalizer: str) -> None:
        key = self._key(obj)
        with self._atomic():
            super().remove_finalizer(obj, finalizer)
            self._sync(key)
