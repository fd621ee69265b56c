# Copied from karpenter_tpu/cloudprovider/corpus.py.
"""Synthetic instance-type corpus generator.

Plays the role of the reference's kwok/tools/gen_instance_types.go: a grid of
instance families x sizes x architectures, each offered spot and on-demand in
every zone with a deterministic price model. Used by the kwok-style provider
and the benchmark harness.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from ..api import labels as labels_mod
from ..api import resources as res
from ..api.requirements import Operator, Requirement, Requirements
from .types import InstanceType, InstanceTypeOverhead, Offering

# provider instance labels live in api/labels.py (registered well-known);
# aliased here for the corpus's public surface
INSTANCE_FAMILY_LABEL = labels_mod.INSTANCE_FAMILY_LABEL
INSTANCE_SIZE_LABEL = labels_mod.INSTANCE_SIZE_LABEL
INSTANCE_CPU_LABEL = labels_mod.INSTANCE_CPU_LABEL
INSTANCE_MEMORY_LABEL = labels_mod.INSTANCE_MEMORY_LABEL

DEFAULT_ZONES = ("test-zone-a", "test-zone-b", "test-zone-c")

# family -> (memory GiB per vCPU, gpus per vCPU)
FAMILIES: Dict[str, tuple] = {
    "c": (2, 0),  # compute optimized
    "m": (4, 0),  # general purpose
    "r": (8, 0),  # memory optimized
    "g": (4, 1 / 4),  # accelerated
}

SIZES = (1, 2, 4, 8, 16, 32, 48, 64, 96)


def price_of(cpu: int, mem_gib: float, gpus: float, capacity_type: str, zone_idx: int = 0) -> float:
    """Deterministic price model: linear in resources, spot ~30% discount,
    small per-zone perturbation so price ordering is exercised."""
    base = cpu * 0.024 + mem_gib * 0.0032 + gpus * 0.40
    if capacity_type == labels_mod.CAPACITY_TYPE_SPOT:
        base *= 0.70
    return round(base * (1.0 + 0.01 * zone_idx), 9)


def make_instance_type(
    family: str,
    cpu: int,
    arch: str = labels_mod.ARCHITECTURE_AMD64,
    zones: Sequence[str] = DEFAULT_ZONES,
    capacity_types: Sequence[str] = (
        labels_mod.CAPACITY_TYPE_SPOT,
        labels_mod.CAPACITY_TYPE_ON_DEMAND,
    ),
    os: str = "linux",
    variant: int = 0,
) -> InstanceType:
    mem_per_cpu, gpu_per_cpu = FAMILIES[family]
    # variants perturb the memory ratio so extended corpora stay diverse
    mem_gib = cpu * mem_per_cpu + variant * cpu
    gpus = int(cpu * gpu_per_cpu)
    size = f"{cpu}x" if not variant else f"{cpu}x-v{variant}"
    name = f"{family}-{size}-{arch}-{os}"

    offerings = [
        Offering(
            requirements=Requirements(
                Requirement(labels_mod.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [ct]),
                Requirement(labels_mod.TOPOLOGY_ZONE, Operator.IN, [zone]),
            ),
            price=price_of(cpu, mem_gib, gpus, ct, zone_idx),
            available=True,
        )
        for zone_idx, zone in enumerate(zones)
        for ct in capacity_types
    ]

    capacity = {
        res.CPU: cpu * res.MILLI,
        res.MEMORY: mem_gib * 2**30 * res.MILLI,
        res.PODS: min(110 + cpu * 4, 512) * res.MILLI,
        res.EPHEMERAL_STORAGE: 100 * 2**30 * res.MILLI,
    }
    if gpus:
        capacity["nvidia.com/gpu"] = gpus * res.MILLI

    requirements = Requirements(
        Requirement(labels_mod.INSTANCE_TYPE, Operator.IN, [name]),
        Requirement(labels_mod.ARCH, Operator.IN, [arch]),
        Requirement(labels_mod.OS, Operator.IN, [os]),
        Requirement(labels_mod.TOPOLOGY_ZONE, Operator.IN, list(zones)),
        Requirement(labels_mod.CAPACITY_TYPE_LABEL_KEY, Operator.IN, list(capacity_types)),
        Requirement(INSTANCE_FAMILY_LABEL, Operator.IN, [family]),
        Requirement(INSTANCE_SIZE_LABEL, Operator.IN, [size]),
        Requirement(INSTANCE_CPU_LABEL, Operator.IN, [str(cpu)]),
        Requirement(INSTANCE_MEMORY_LABEL, Operator.IN, [str(int(mem_gib * 1024))]),
    )

    overhead = InstanceTypeOverhead(
        kube_reserved={
            res.CPU: max(100, cpu * 10),
            res.MEMORY: int(0.01 * mem_gib * 2**30 * res.MILLI) + 200 * 2**20 * res.MILLI,
        },
        system_reserved={res.CPU: 100, res.MEMORY: 100 * 2**20 * res.MILLI},
        eviction_threshold={res.MEMORY: 100 * 2**20 * res.MILLI},
    )
    return InstanceType(
        name=name,
        requirements=requirements,
        offerings=offerings,
        capacity=capacity,
        overhead=overhead,
    )


def generate(
    count: Optional[int] = None,
    zones: Sequence[str] = DEFAULT_ZONES,
    archs: Sequence[str] = (labels_mod.ARCHITECTURE_AMD64, labels_mod.ARCHITECTURE_ARM64),
) -> List[InstanceType]:
    """Full grid corpus: families x sizes x archs (72 types for defaults);
    ``count`` takes a prefix, or cycles sizes with scaled variants when more
    are requested (benchmarks use 400+)."""
    out: List[InstanceType] = []
    grid = [
        (family, cpu, arch)
        for family in FAMILIES
        for cpu in SIZES
        for arch in archs
    ]
    if count is None:
        count = len(grid)
    i = 0
    while len(out) < count:
        family, cpu, arch = grid[i % len(grid)]
        # Past the base grid, emit memory-ratio variants with distinct names.
        variant = i // len(grid)
        out.append(make_instance_type(family, cpu, arch, zones=zones, variant=variant))
        i += 1
    return out


# -- JSON corpus files ------------------------------------------------------
#
# kwok parity: the reference ships a JSON corpus
# (kwok/cloudprovider/instance_types.json, loaded via
# --instance-types-file-path, kwok/options/options.go). Our schema is a list
# of objects:
#   {"name": ..., "capacity": {"cpu": "4", "memory": "16Gi", ...},
#    "labels": {label-key: value, ...},          # single-value requirements
#    "overhead": {"cpu": "100m", ...},           # optional, kube-reserved
#    "offerings": [{"zone": ..., "capacityType": ..., "price": 0.1,
#                   "available": true}, ...]}


def load_file(path: str) -> List[InstanceType]:
    """Load an instance-type corpus from a JSON file."""
    import json

    with open(path) as f:
        raw = json.load(f)
    out: List[InstanceType] = []
    for entry in raw:
        labels = dict(entry.get("labels", {}))
        labels.setdefault(labels_mod.INSTANCE_TYPE, entry["name"])
        offerings = []
        zones = []
        capacity_types = []
        for o in entry.get("offerings", []):
            zone, ct = o["zone"], o["capacityType"]
            if zone not in zones:
                zones.append(zone)
            if ct not in capacity_types:
                capacity_types.append(ct)
            offerings.append(
                Offering(
                    requirements=Requirements(
                        Requirement(
                            labels_mod.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [ct]
                        ),
                        Requirement(labels_mod.TOPOLOGY_ZONE, Operator.IN, [zone]),
                    ),
                    price=float(o["price"]),
                    available=bool(o.get("available", True)),
                )
            )
        reqs = Requirements(
            *(Requirement(k, Operator.IN, [v]) for k, v in labels.items())
        )
        if zones:
            reqs.add(Requirement(labels_mod.TOPOLOGY_ZONE, Operator.IN, zones))
        if capacity_types:
            reqs.add(
                Requirement(
                    labels_mod.CAPACITY_TYPE_LABEL_KEY, Operator.IN, capacity_types
                )
            )
        overhead = InstanceTypeOverhead(
            kube_reserved=res.parse_resource_list(entry.get("overhead", {}))
        )
        out.append(
            InstanceType(
                name=entry["name"],
                requirements=reqs,
                offerings=offerings,
                capacity=res.parse_resource_list(entry["capacity"]),
                overhead=overhead,
            )
        )
    return out


def dump_file(path: str, instance_types: List[InstanceType]) -> None:
    """Write a corpus to the JSON schema load_file reads (the gen tool)."""
    import json

    entries = []
    for it in instance_types:
        labels = it.requirements.single_valued_labels()
        entries.append(
            {
                "name": it.name,
                "capacity": {
                    k: res.format_quantity(v) for k, v in it.capacity.items()
                },
                "labels": labels,
                "overhead": {
                    k: res.format_quantity(v)
                    for k, v in it.overhead.total().items()
                },
                "offerings": [
                    {
                        "zone": o.zone(),
                        "capacityType": o.capacity_type(),
                        "price": o.price,
                        "available": o.available,
                    }
                    for o in it.offerings
                ],
            }
        )
    with open(path, "w") as f:
        json.dump(entries, f, indent=1)
