# Copied from karpenter_tpu/api/validation.py.
"""Schema-tier object validation: the CRD/CEL rule analog.

The reference enforces two validation tiers: CEL rules compiled into the
CRDs (nodepool.go:79,176-184, nodeclaim.go:38-41,145) and runtime Go
validation (nodepool_validation.go:27-66, nodeclaim_validation.go:62-160).
There is no apiserver here, so both tiers run at admission time in
``validate_node_pool`` / ``validate_node_claim`` — the nodepool validation
controller flips the pool's readiness on failures exactly like the
reference's validation controller does.
"""

from __future__ import annotations

import re
from typing import List, Optional

from . import labels as labels_mod
from .objects import Budget, NodeClaim, NodePool

SUPPORTED_OPERATORS = frozenset(
    {"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"}
)

_NAME_PART = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]*[A-Za-z0-9])?$")
_DNS_LABEL = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?$")
_CRON_FIELD = re.compile(r"^(\*|[0-9]+(-[0-9]+)?)(/[0-9]+)?(,(\*|[0-9]+(-[0-9]+)?)(/[0-9]+)?)*$")
_BUDGET_NODES = re.compile(r"^((100|[0-9]{1,2})%|[0-9]+)$")
_CRON_SHORTHANDS = frozenset({
    "@yearly", "@annually", "@monthly", "@weekly", "@daily", "@midnight",
    "@hourly",
})


def _is_qualified_name(key: str) -> Optional[str]:
    """k8s qualified name: [dns-subdomain/]name, name <= 63 chars of
    alphanumerics, '-', '_' or '.', starting and ending alphanumeric."""
    parts = key.split("/")
    if len(parts) > 2:
        return "a qualified name must have at most one '/'"
    if len(parts) == 2:
        prefix, name = parts
        if not prefix or len(prefix) > 253:
            return "prefix part must be a DNS subdomain"
        for seg in prefix.split("."):
            if not _DNS_LABEL.match(seg):
                return f"prefix segment {seg!r} is not a DNS label"
    else:
        name = parts[0]
    if not name or len(name) > 63 or not _NAME_PART.match(name):
        return (
            "name part must be 1-63 alphanumerics, '-', '_' or '.', starting"
            " and ending with an alphanumeric"
        )
    return None


def _is_valid_label_value(value: str) -> Optional[str]:
    if value == "":
        return None
    if len(value) > 63 or not _NAME_PART.match(value):
        return (
            "label values must be 0-63 alphanumerics, '-', '_' or '.',"
            " starting and ending with an alphanumeric"
        )
    return None


def validate_requirement(req) -> List[str]:
    """ValidateRequirement (nodeclaim_validation.go:113-160) over a
    NodeSelectorRequirement-shaped object (key/operator/values/min_values)."""
    errs: List[str] = []
    key = labels_mod.normalize(req.key)
    op = req.operator
    values = list(req.values)
    if op not in SUPPORTED_OPERATORS:
        errs.append(f"key {key} has an unsupported operator {op}")
    restricted = labels_mod.is_restricted_label(key)
    if restricted:
        errs.append(restricted)
    err = _is_qualified_name(key)
    if err:
        errs.append(f"key {key} is not a qualified name, {err}")
    for v in values:
        verr = _is_valid_label_value(v)
        if verr:
            errs.append(f"invalid value {v!r} for key {key}, {verr}")
    if op == "In" and not values:
        errs.append(f"key {key} with operator In must have a value defined")
    min_values = getattr(req, "min_values", None)
    if op == "In" and min_values is not None and len(values) < min_values:
        errs.append(
            f"key {key} with operator In must have at least minValues"
            f" ({min_values}) values"
        )
    if op in ("Gt", "Lt"):
        ok = len(values) == 1
        if ok:
            try:
                ok = int(values[0]) >= 0
            except ValueError:
                ok = False
        if not ok:
            errs.append(
                f"key {key} with operator {op} must have a single positive"
                " integer value"
            )
    return errs


def _validate_taints(taints, field: str) -> List[str]:
    """validateTaintsField (nodeclaim_validation.go:62-102): valid keys,
    valid effects, no (key, effect) duplicates."""
    errs: List[str] = []
    seen = set()
    for t in taints:
        err = _is_qualified_name(t.key)
        if err:
            errs.append(f"invalid taint key {t.key!r} in {field}, {err}")
        if t.value:
            verr = _is_valid_label_value(t.value)
            if verr:
                errs.append(f"invalid taint value {t.value!r} in {field}")
        if t.effect not in ("NoSchedule", "PreferNoSchedule", "NoExecute"):
            errs.append(f"invalid taint effect {t.effect!r} in {field}")
        ke = (t.key, t.effect)
        if ke in seen:
            errs.append(f"duplicate taint {t.key}:{t.effect} in {field}")
        seen.add(ke)
    return errs


def _validate_budget(budget: Budget) -> List[str]:
    errs: List[str] = []
    if not _BUDGET_NODES.match(budget.nodes):
        errs.append(f"budget nodes {budget.nodes!r} must be a count or percent")
    # CEL: 'schedule' must be set with 'duration' (nodepool.go:79)
    if (budget.schedule is None) != (budget.duration is None):
        errs.append("budget 'schedule' must be set together with 'duration'")
    if budget.schedule is not None:
        if budget.schedule.startswith("@"):
            if budget.schedule.split()[0] not in _CRON_SHORTHANDS:
                errs.append(
                    f"budget schedule {budget.schedule!r} is not a known"
                    " cron shorthand"
                )
        else:
            fields = budget.schedule.split()
            if len(fields) != 5 or not all(
                _CRON_FIELD.match(f) for f in fields
            ):
                errs.append(
                    f"budget schedule {budget.schedule!r} is not valid cron"
                )
    return errs


def validate_node_pool(pool: NodePool) -> List[str]:
    """NodePool.RuntimeValidate + the CRD CEL rules
    (nodepool_validation.go:27-66, nodepool.go:79,130-138,176-184)."""
    errs: List[str] = []
    template = pool.spec.template
    for key, value in template.labels.items():
        if key == labels_mod.NODEPOOL_LABEL_KEY:
            errs.append(f"invalid key name {key!r} in labels, restricted")
        err = _is_qualified_name(key)
        if err:
            errs.append(f"invalid key name {key!r} in labels, {err}")
        verr = _is_valid_label_value(value)
        if verr:
            errs.append(f"invalid value {value!r} for label[{key}]")
        restricted = labels_mod.is_restricted_label(key)
        if restricted:
            errs.append(f"invalid key name {key!r} in labels, {restricted}")
    errs += _validate_taints(template.spec.taints, "taints")
    errs += _validate_taints(template.spec.startup_taints, "startupTaints")
    for req in template.spec.requirements:
        errs += validate_requirement(req)
        if req.key == labels_mod.NODEPOOL_LABEL_KEY:
            errs.append(
                f"invalid key {req.key!r} in requirements, restricted"
            )
    if not 1 <= pool.spec.weight <= 100:
        errs.append(f"weight {pool.spec.weight} must be within [1, 100]")
    for budget in pool.spec.disruption.budgets:
        errs += _validate_budget(budget)
    return errs


def validate_node_claim(claim: NodeClaim) -> List[str]:
    """NodeClaim spec validation (nodeclaim.go:38-41 CEL analogs)."""
    errs: List[str] = []
    for req in claim.spec.requirements:
        errs += validate_requirement(req)
    errs += _validate_taints(claim.spec.taints, "taints")
    errs += _validate_taints(claim.spec.startup_taints, "startupTaints")
    return errs
