# Copied from karpenter_tpu/solver/vocab.py, 1 comment line reworded.
"""Label vocabulary interning: Requirements -> fixed-width boolean masks.

The tensor solver needs every requirement as a dense mask over a closed
per-key value vocabulary. Complement sets (NotIn/Exists) are exact over a
closed universe plus one reserved OVERFLOW slot per key that witnesses "some
value outside the vocabulary": a complement set always admits unseen values,
a concrete set never does. Gt/Lt bounds are evaluated per vocabulary value at
encode time; the overflow slot under bounds is set iff the open integer band
contains a value not in the vocabulary.

Array shapes are bucketed to powers of two so XLA recompiles only when the
snapshot outgrows the previous bucket.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as labels_mod
from ..api.requirements import Operator, Requirement, Requirements


def _next_pow2(n: int, floor: int = 4) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


_VOCAB_SERIAL = itertools.count(1)


class Vocab:
    """Interned label keys and per-key value vocabularies."""

    def __init__(self):
        # distinguishes vocab INSTANCES in cache-validity tags (id() can
        # be reused after GC; this never is). itertools.count is atomic
        # under the GIL — concurrent sidecar solves construct Vocabs
        # without an instance-level lock in scope.
        self.serial = next(_VOCAB_SERIAL)
        self.key_ids: Dict[str, int] = {}
        self.keys: List[str] = []
        self.value_ids: List[Dict[str, int]] = []  # per key
        self.values: List[List[str]] = []

    def key_id(self, key: str) -> int:
        kid = self.key_ids.get(key)
        if kid is None:
            kid = len(self.keys)
            self.key_ids[key] = kid
            self.keys.append(key)
            self.value_ids.append({})
            self.values.append([])
        return kid

    def value_id(self, key: str, value: str) -> int:
        kid = self.key_id(key)
        vid = self.value_ids[kid].get(value)
        if vid is None:
            vid = len(self.values[kid])
            self.value_ids[kid][value] = vid
            self.values[kid].append(value)
        return vid

    def observe(self, reqs: Requirements) -> None:
        """Register keys AND values. Only constraint-side entities (pods,
        templates) register values; provider-side entities (instance types,
        node labels) use observe_keys + the overflow slot, keeping the value
        axis small (800 instance-type names would otherwise inflate V1 for
        every key)."""
        for r in reqs:
            self.key_id(r.key)
            # CONTENT-ordered interning: Requirement.values is a set, and
            # bare set iteration assigns value ids in PYTHONHASHSEED order
            # — two processes would intern the same zones/hostnames at
            # different ids, and every argmin/argmax tie-break over value
            # ids (domain picks, hostname slots) would diverge, moving
            # packing cost ~0.2% across processes (PARITY.md).
            # Sorting pins the id order to the values themselves
            # (tests/test_solver_parity.py two-process determinism pin).
            for v in sorted(r.values):
                self.value_id(r.key, v)

    def observe_keys(self, reqs: Requirements) -> None:
        for r in reqs:
            self.key_id(r.key)

    def observe_label_keys(self, labels: Dict[str, str]) -> None:
        for k in labels:
            self.key_id(k)

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    def padded_shape(self) -> Tuple[int, int]:
        """(K, V+1) with V bucketed; last slot is OVERFLOW."""
        max_vals = max((len(v) for v in self.values), default=0)
        return _next_pow2(self.n_keys), _next_pow2(max_vals + 1)

    def well_known_mask(self, K: int) -> np.ndarray:
        out = np.zeros(K, dtype=bool)
        for key, kid in self.key_ids.items():
            out[kid] = key in labels_mod.WELL_KNOWN_LABELS
        return out

    # -- encoding ---------------------------------------------------------

    def _band_has_unseen(self, kid: int, gt: Optional[int], lt: Optional[int]) -> bool:
        """Does the integer band (gt, lt) contain a value not in the vocab?"""
        lo = gt + 1 if gt is not None else None
        hi = lt - 1 if lt is not None else None
        if lo is None or hi is None:
            return True  # open-ended band is infinite
        if lo > hi:
            return False
        band = hi - lo + 1
        if band > 4096:
            return True  # cheaper than scanning; a wide band surely has unseen values
        seen = 0
        for v in self.values[kid]:
            try:
                iv = int(v)
            except ValueError:
                continue
            if lo <= iv <= hi:
                seen += 1
        return seen < band

    def encode_requirement(
        self, r: Requirement, mask_row: np.ndarray
    ) -> None:
        """Fill mask_row (V+1 bools, last=overflow) with r's allowed set.

        Concrete values absent from the vocabulary set the OVERFLOW slot:
        "admits some value outside the vocabulary". Sound as long as two
        unseen-value sets are never intersected with each other — guaranteed
        because all constraint-side (pod/template) values are registered and
        provider-side entities are only ever compared against
        constraint-side masks.
        """
        kid = self.key_ids[r.key]
        vals = self.values[kid]
        ids = self.value_ids[kid]
        gt, lt = r.greater_than, r.less_than
        if r.complement:
            for i, v in enumerate(vals):
                mask_row[i] = v not in r.values and _within(v, gt, lt)
            mask_row[-1] = self._band_has_unseen(kid, gt, lt) if (gt is not None or lt is not None) else True
        else:
            # idempotent mask bit-sets keyed by interned value id, so the
            # analysis: sanctioned[DET1101] order cannot reach the row bytes
            for v in r.values:
                # concrete sets have bounds stripped by intersection, but a
                # raw Gt-filtered In set may carry them
                if not _within(v, gt, lt):
                    continue
                vid = ids.get(v)
                if vid is None:
                    mask_row[-1] = True  # unseen concrete value
                else:
                    mask_row[vid] = True

    def encode(
        self, reqs: Requirements, K: int, V1: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Requirements -> (defined[K], neg[K], mask[K, V1]).

        Undefined keys get the all-true mask (Exists semantics) so kernels
        can intersect unconditionally; ``defined`` gates the custom-label
        rule, ``neg`` marks NotIn/DoesNotExist for the double-negation
        exemption (requirements.go:247-254).
        """
        defined = np.zeros(K, dtype=bool)
        neg = np.zeros(K, dtype=bool)
        mask = np.ones((K, V1), dtype=bool)
        for r in reqs:
            kid = self.key_ids[r.key]
            defined[kid] = True
            op = r.operator()
            neg[kid] = op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST)
            row = np.zeros(V1, dtype=bool)
            self.encode_requirement(r, row)
            mask[kid] = row
        return defined, neg, mask


def _within(value: str, gt: Optional[int], lt: Optional[int]) -> bool:
    if gt is None and lt is None:
        return True
    try:
        iv = int(value)
    except ValueError:
        return False
    if gt is not None and iv <= gt:
        return False
    if lt is not None and iv >= lt:
        return False
    return True
