# Copied from karpenter_tpu/api/resources.py.
"""Resource quantity algebra.

Quantities are stored as exact integer milli-units (1 cpu == 1000, 1 byte of
memory == 1000 millibytes) so that first-fit-decreasing sort order and fit
checks are bit-exact with the reference's infinite-precision
``resource.Quantity`` arithmetic (reference: pkg/utils/resources/resources.go).

A ResourceList is a plain ``dict[str, int]`` of resource name -> milli-units.
The tensor encoder (solver/encode.py) lowers ResourceLists onto a dense
float32/int64 resource axis; this module is the exact host-side form.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, Iterable, Mapping

# Canonical resource names (mirror of corev1.ResourceName constants).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

MILLI = 1000

_SUFFIXES = {
    "": 1,
    "m": Fraction(1, 1000),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}

_QUANTITY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]*)$")

ResourceList = Dict[str, int]


def parse_quantity(value) -> int:
    """Parse a Kubernetes quantity string into integer milli-units.

    Accepts ints/floats (interpreted as whole units) and strings such as
    "100m", "1.5Gi", "2", "1e3". Fractions below one milli-unit round up,
    matching kubernetes' milli-scale ceiling behavior.
    """
    if isinstance(value, bool):
        raise ValueError(f"invalid quantity {value!r}")
    if isinstance(value, int):
        return value * MILLI
    if isinstance(value, float):
        frac = Fraction(value).limit_denominator(10**9) * MILLI
        return _ceil_fraction(frac)
    if not isinstance(value, str):
        raise ValueError(f"invalid quantity {value!r}")
    m = _QUANTITY_RE.match(value.strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    number, suffix = m.groups()
    if suffix not in _SUFFIXES:
        raise ValueError(f"invalid quantity suffix {suffix!r} in {value!r}")
    if "e" in number or "E" in number:
        mantissa, exp = re.split("[eE]", number)
        base = Fraction(mantissa) * Fraction(10) ** int(exp)
    else:
        base = Fraction(number)
    return _ceil_fraction(base * _SUFFIXES[suffix] * MILLI)


def _ceil_fraction(f: Fraction) -> int:
    return -((-f.numerator) // f.denominator)


def format_quantity(millis: int) -> str:
    """Render milli-units back to a human-readable quantity string."""
    if millis % MILLI == 0:
        return str(millis // MILLI)
    return f"{millis}m"


def parse_resource_list(spec: Mapping[str, object] | None) -> ResourceList:
    return {name: parse_quantity(q) for name, q in (spec or {}).items()}


def merge(*lists: Mapping[str, int]) -> ResourceList:
    """Sum of resource lists (reference: resources.go:50-66)."""
    out: ResourceList = {}
    for rl in lists:
        for name, q in rl.items():
            out[name] = out.get(name, 0) + q
    return out


def merge_into(dest: ResourceList, src: Mapping[str, int]) -> ResourceList:
    for name, q in src.items():
        dest[name] = dest.get(name, 0) + q
    return dest


def subtract(lhs: Mapping[str, int], rhs: Mapping[str, int]) -> ResourceList:
    """lhs - rhs over lhs's keys only (reference: resources.go:81-94)."""
    return {name: q - rhs.get(name, 0) for name, q in lhs.items()}


def max_resources(*lists: Mapping[str, int]) -> ResourceList:
    """Element-wise max (reference: resources.go:172-183)."""
    out: ResourceList = {}
    for rl in lists:
        for name, q in rl.items():
            if name not in out or q > out[name]:
                out[name] = q
    return out


def fits(candidate: Mapping[str, int], total: Mapping[str, int]) -> bool:
    """True iff candidate fits within total.

    Mirrors reference resources.go:217-231: any negative value in ``total``
    fails immediately; every candidate resource must be <= total (missing in
    total == 0).
    """
    for q in total.values():
        if q < 0:
            return False
    for name, q in candidate.items():
        if q > total.get(name, 0):
            return False
    return True


def cmp(lhs: int, rhs: int) -> int:
    return (lhs > rhs) - (lhs < rhs)


def is_zero(rl: Mapping[str, int]) -> bool:
    return all(q == 0 for q in rl.values())


def any_negative(rl: Mapping[str, int]) -> bool:
    return any(q < 0 for q in rl.values())


def to_string(rl: Mapping[str, int]) -> str:
    return ",".join(f"{k}={format_quantity(v)}" for k, v in sorted(rl.items()))


def resource_names(lists: Iterable[Mapping[str, int]]) -> list[str]:
    """Stable union of resource names across lists (cpu/memory first)."""
    seen = dict.fromkeys([CPU, MEMORY])
    for rl in lists:
        for name in rl:
            seen.setdefault(name)
    return list(seen)
