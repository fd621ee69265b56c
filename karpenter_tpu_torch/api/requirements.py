# Copied from karpenter_tpu/api/requirements.py.
"""Requirements set algebra.

Host-side exact mirror of the reference's pkg/scheduling/requirement.go and
requirements.go. A Requirement is a per-label-key constraint represented as
either a concrete value set or a complement set (plus optional integer
bounds); Requirements is a keyed collection with intersection semantics and
the well-known/custom-label compatibility asymmetry.

This module is the semantic source of truth; solver/encode.py lowers these
objects onto fixed-width boolean masks over an interned value vocabulary for
the TPU kernels, and tests assert the two agree.
"""

from __future__ import annotations

from functools import lru_cache

import random
from enum import Enum
from typing import Dict, FrozenSet, Iterable, Iterator, List, Optional, Set

from . import labels as labels_mod


class Operator(str, Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _within_bounds(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    """Numeric bound check (reference: requirement.go:313-326).

    Non-numeric values fail any active bound.
    """
    if greater_than is None and less_than is None:
        return True
    try:
        v = int(value)
    except ValueError:
        return False
    if greater_than is not None and v <= greater_than:
        return False
    if less_than is not None and v >= less_than:
        return False
    return True


class Requirement:
    """A single label-key constraint (reference: requirement.go:33-118).

    Internal form: ``complement=False`` means the allowed values are exactly
    ``values``; ``complement=True`` means every value EXCEPT ``values``
    (optionally limited by Gt/Lt integer bounds) is allowed.
    """

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(
        self,
        key: str,
        operator: Operator | str,
        values: Iterable[str] = (),
        min_values: Optional[int] = None,
    ):
        operator = Operator(operator)
        self.key = labels_mod.normalize(key)
        self.min_values = min_values
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        values = list(values)
        if operator is Operator.IN:
            self.complement = False
            self.values: Set[str] = set(values)
        elif operator is Operator.DOES_NOT_EXIST:
            self.complement = False
            self.values = set()
        elif operator is Operator.NOT_IN:
            self.complement = True
            self.values = set(values)
        elif operator is Operator.EXISTS:
            self.complement = True
            self.values = set()
        elif operator is Operator.GT:
            self.complement = True
            self.values = set()
            self.greater_than = int(values[0])
        elif operator is Operator.LT:
            self.complement = True
            self.values = set()
            self.less_than = int(values[0])
        else:  # pragma: no cover
            raise ValueError(f"unknown operator {operator}")

    @classmethod
    def _raw(
        cls,
        key: str,
        complement: bool,
        values: Set[str],
        greater_than: Optional[int],
        less_than: Optional[int],
        min_values: Optional[int],
    ) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = values
        r.greater_than = greater_than
        r.less_than = less_than
        r.min_values = min_values
        return r

    def operator(self) -> Operator:
        """Reference: requirement.go:269-283."""
        if self.greater_than is not None:
            return Operator.GT
        if self.less_than is not None:
            return Operator.LT
        if self.complement:
            return Operator.NOT_IN if self.values else Operator.EXISTS
        return Operator.IN if self.values else Operator.DOES_NOT_EXIST

    def intersection(self, other: "Requirement") -> "Requirement":
        """Constrain self by other (reference: requirement.go:155-189)."""
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        min_values = _max_opt(self.min_values, other.min_values)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return Requirement(self.key, Operator.DOES_NOT_EXIST, min_values=min_values)
        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = {v for v in values if _within_bounds(v, greater_than, less_than)}
        if not complement:
            greater_than, less_than = None, None
        return Requirement._raw(self.key, complement, values, greater_than, less_than, min_values)

    def has_intersection(self, other: "Requirement") -> bool:
        """Allocation-free intersection test (reference: requirement.go:191-228)."""
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return False
        if self.complement and other.complement:
            return True
        if self.complement and not other.complement:
            return any(
                v not in self.values and _within_bounds(v, greater_than, less_than)
                for v in other.values
            )
        if not self.complement and other.complement:
            return any(
                v not in other.values and _within_bounds(v, greater_than, less_than)
                for v in self.values
            )
        return any(
            v in other.values and _within_bounds(v, greater_than, less_than)
            for v in self.values
        )

    def has(self, value: str) -> bool:
        """True if the requirement allows the value (requirement.go:249-254)."""
        if self.complement:
            return value not in self.values and _within_bounds(
                value, self.greater_than, self.less_than
            )
        return value in self.values and _within_bounds(value, self.greater_than, self.less_than)

    def any(self) -> str:
        """Pick an arbitrary allowed value (requirement.go:231-247)."""
        op = self.operator()
        if op is Operator.IN:
            return min(self.values)  # deterministic, unlike the reference's map order
        if op in (Operator.NOT_IN, Operator.EXISTS):
            lo = (self.greater_than + 1) if self.greater_than is not None else 0
            hi = self.less_than if self.less_than is not None else 2**63
            if hi <= lo:
                return ""
            for _ in range(64):
                candidate = str(random.randrange(lo, hi))
                if candidate not in self.values:
                    return candidate
        return ""

    def values_list(self) -> List[str]:
        return sorted(self.values)

    def len(self) -> int:
        """Cardinality used by flexibility checks; complement sets are 'infinite'
        (reference: requirement.go:256-262)."""
        if self.complement:
            return 2**31
        return len(self.values)

    def copy(self) -> "Requirement":
        return Requirement._raw(
            self.key,
            self.complement,
            set(self.values),
            self.greater_than,
            self.less_than,
            self.min_values,
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Requirement):
            return NotImplemented
        return (
            self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
            and self.min_values == other.min_values
        )

    def __hash__(self):
        return hash(
            (
                self.key,
                self.complement,
                frozenset(self.values),
                self.greater_than,
                self.less_than,
                self.min_values,
            )
        )

    def __repr__(self) -> str:
        op = self.operator()
        if op in (Operator.EXISTS, Operator.DOES_NOT_EXIST):
            return f"{self.key} {op.value}"
        if op in (Operator.GT,):
            return f"{self.key} Gt {self.greater_than}"
        if op in (Operator.LT,):
            return f"{self.key} Lt {self.less_than}"
        return f"{self.key} {op.value} {sorted(self.values)}"


class IntersectsError:
    """Deferred-formatting intersection failure (reference badKeyError,
    requirements.go:219-230): built from the failing (key, incoming,
    existing) triples, stringified only if anyone actually reads it."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items

    def __str__(self) -> str:
        return "; ".join(
            f"key {key}, {incoming!r} not in {existing!r}"
            for key, incoming, existing in self.items
        )

    def __repr__(self) -> str:
        return str(self)

    def __contains__(self, needle: str) -> bool:
        return needle in str(self)


class Requirements:
    """Keyed requirement collection (reference: requirements.go:36-45).

    Adding a requirement for an existing key intersects with the existing
    one (requirements.go:128-136).
    """

    __slots__ = ("_by_key",)

    def __init__(self, *requirements: Requirement):
        self._by_key: Dict[str, Requirement] = {}
        self.add(*requirements)

    @classmethod
    def from_labels(cls, labels: Dict[str, str]) -> "Requirements":
        return cls(*(_label_requirement(k, v) for k, v in labels.items()))

    def add(self, *requirements: Requirement) -> None:
        for req in requirements:
            existing = self._by_key.get(req.key)
            if existing is not None:
                req = req.intersection(existing)
            self._by_key[req.key] = req

    def copy(self) -> "Requirements":
        out = Requirements()
        out._by_key = {k: v.copy() for k, v in self._by_key.items()}
        return out

    def keys(self) -> Set[str]:
        return set(self._by_key)

    def values(self) -> List[Requirement]:
        return list(self._by_key.values())

    def has(self, key: str) -> bool:
        return key in self._by_key

    def get(self, key: str) -> Requirement:
        """Undefined keys behave as Exists (requirements.go:151-157)."""
        req = self._by_key.get(key)
        if req is None:
            return Requirement(key, Operator.EXISTS)
        return req

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._by_key.values())

    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: str) -> bool:
        return key in self._by_key

    def is_compatible(
        self, other: "Requirements", allow_undefined: FrozenSet[str] = frozenset()
    ) -> bool:
        return self.compatible(other, allow_undefined) is None

    def compatible(self, other: "Requirements", allow_undefined: FrozenSet[str] = frozenset()):
        """Asymmetric compatibility (reference: requirements.go:177-196).

        Custom labels (not in ``allow_undefined``) that ``other`` constrains
        positively must be defined on self; well-known labels may be
        undefined. Returns a stringable error (str or IntersectsError) or
        None.
        """
        for key in other.keys():
            if key in allow_undefined:
                continue
            op = other.get(key).operator()
            if key in self._by_key or op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                continue
            return f"label {key!r} does not have known values"
        return self.intersects(other)

    def intersects(self, other: "Requirements") -> Optional["IntersectsError"]:
        """Overlap check over shared keys with the double-negation exemption
        (reference: requirements.go:241-262). Returns a lazily-formatted error
        or None — most callers only test for None on the hot path, so no
        strings are built here (mirrors the reference's lazy badKeyError,
        requirements.go:219-230).
        """
        errs = None
        small, large = (
            (self._by_key, other._by_key)
            if len(self._by_key) <= len(other._by_key)
            else (other._by_key, self._by_key)
        )
        for key in small:
            if key not in large:
                continue
            existing = self.get(key)
            incoming = other.get(key)
            if not existing.has_intersection(incoming):
                if incoming.operator() in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                    if existing.operator() in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                        continue
                if errs is None:
                    errs = []
                errs.append((key, incoming, existing))
        return IntersectsError(errs) if errs else None

    def single_valued_labels(self) -> Dict[str, str]:
        """key -> value for every requirement pinned to exactly one value
        (the label projection providers stamp onto launched claims and
        serialized catalogs)."""
        return {
            key: next(iter(req.values))
            for key, req in self._by_key.items()
            if not req.complement and len(req.values) == 1
        }

    def labels(self) -> Dict[str, str]:
        """Concrete node labels implied by the requirements
        (reference: requirements.go:264-274)."""
        out = {}
        for key, req in self._by_key.items():
            if not labels_mod.is_restricted_node_label(key):
                value = req.any()
                if value:
                    out[key] = value
        return out

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self._by_key.values())

    def __eq__(self, other) -> bool:
        if not isinstance(other, Requirements):
            return NotImplemented
        return self._by_key == other._by_key

    def __repr__(self) -> str:
        return ", ".join(
            repr(r)
            for r in sorted(self._by_key.values(), key=lambda r: r.key)
            if r.key not in labels_mod.RESTRICTED_LABELS
        )


def pod_requirements(pod) -> Requirements:
    """Pod requirements with the heaviest preferred term treated as required
    (reference: requirements.go:89-110).
    """
    return _pod_requirements(pod, include_preferred=True)


def strict_pod_requirements(pod) -> Requirements:
    """Only hard requirements (reference: requirements.go:79-81)."""
    return _pod_requirements(pod, include_preferred=False)


def _pod_requirements(pod, include_preferred: bool) -> Requirements:
    reqs = Requirements.from_labels(pod.spec.node_selector or {})
    affinity = pod.spec.node_affinity
    if affinity is None:
        return reqs
    if include_preferred and affinity.preferred:
        heaviest = max(affinity.preferred, key=lambda t: t.weight)
        reqs.add(
            *(
                Requirement(t.key, t.operator, t.values, min_values=t.min_values)
                for t in heaviest.requirements
            )
        )
    # Only the first required OR-term is considered; relaxation removes terms
    # (reference: requirements.go:104-108).
    if affinity.required:
        reqs.add(
            *(
                Requirement(t.key, t.operator, t.values, min_values=t.min_values)
                for t in affinity.required[0]
            )
        )
    return reqs


def has_preferred_node_affinity(pod) -> bool:
    affinity = pod.spec.node_affinity
    return affinity is not None and bool(affinity.preferred)


@lru_cache(maxsize=65536)
def _label_requirement(key: str, value: str) -> Requirement:
    """Shared single-value IN requirement for a node label. Requirement
    objects are never mutated in place (set algebra builds new instances),
    so one instance per (key, value) serves every ExistingNode/Topology
    construction — from_labels runs per node per simulation probe, and the
    re-parse dominated consolidation's host-side profile."""
    return Requirement(key, Operator.IN, [value])
