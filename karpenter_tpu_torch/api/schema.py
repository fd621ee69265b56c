# Copied from karpenter_tpu/api/schema.py.
"""Declarative schema export: the generated-CRD/CEL artifact analog.

The reference ships generated CRD YAML with CEL rules compiled in
(pkg/apis/crds/karpenter.sh_nodepools.yaml; markers at nodepool.go:79,
176-184, nodeclaim.go:38-41) so the admission contract is machine-readable
outside the Go process. Here the runtime schema tier lives in
api/validation.py; this module emits the SAME rule content as OpenAPI-v3
style schemas (plus ``x-validations`` entries for the cross-field CEL
analogs), sourced from validation.py's own constants — the round-trip test
(tests/test_schema_export.py) regenerates the artifacts and fails when
they drift from either the checked-in files or the Python rules.

Regenerate with ``python -m karpenter_tpu.api.schema``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

from . import labels as labels_mod
from . import validation as val

CRD_DIR = os.path.join(os.path.dirname(__file__), "crds")

# single sources of truth, shared with the runtime validator
_KEY_PATTERN = val._NAME_PART.pattern
_VALUE_PATTERN = val._NAME_PART.pattern
_BUDGET_NODES_PATTERN = val._BUDGET_NODES.pattern
_CRON_FIELD_PATTERN = val._CRON_FIELD.pattern
_TAINT_EFFECTS = ["NoSchedule", "PreferNoSchedule", "NoExecute"]


def _requirement_schema() -> Dict:
    return {
        "type": "object",
        "required": ["key", "operator"],
        "properties": {
            "key": {
                "type": "string",
                "maxLength": 316,  # 253 prefix + '/' + 63 name
                "x-name-pattern": _KEY_PATTERN,
            },
            "operator": {
                "type": "string",
                "enum": sorted(val.SUPPORTED_OPERATORS),
            },
            "values": {
                "type": "array",
                "items": {
                    "type": "string",
                    "maxLength": 63,
                    "x-name-pattern": _VALUE_PATTERN,
                },
            },
            "minValues": {"type": "integer", "minimum": 1, "maximum": 50},
        },
        "x-validations": [
            {
                "rule": "self.operator == 'In' ? self.values.size() != 0 : true",
                "message": "operator In requires at least one value",
            },
            {
                "rule": (
                    "has(self.minValues) && self.operator == 'In' ?"
                    " self.values.size() >= self.minValues : true"
                ),
                "message": "minValues cannot exceed the number of values",
            },
            {
                "rule": (
                    "self.operator in ['Gt', 'Lt'] ?"
                    " self.values.size() == 1 && int(self.values[0]) >= 0"
                    " : true"
                ),
                "message": (
                    "Gt/Lt require a single non-negative integer value"
                ),
            },
            {
                "rule": "!(self.key in %s)"
                % json.dumps(sorted(labels_mod.RESTRICTED_LABELS)),
                "message": "restricted label keys cannot be constrained",
                # the full rule (labels.go:109-118 analog,
                # api/labels.py:is_restricted_label): restricted domains
                # apply unless the key is well-known or under an exception
                "x-restricted-domains": sorted(
                    labels_mod.RESTRICTED_LABEL_DOMAINS
                ),
                "x-domain-exceptions": sorted(
                    labels_mod.LABEL_DOMAIN_EXCEPTIONS
                ),
            },
        ],
    }


def _taints_schema() -> Dict:
    return {
        "type": "array",
        "items": {
            "type": "object",
            "required": ["key", "effect"],
            "properties": {
                "key": {"type": "string", "x-name-pattern": _KEY_PATTERN},
                "value": {
                    "type": "string",
                    "maxLength": 63,
                    "x-name-pattern": _VALUE_PATTERN,
                },
                "effect": {"type": "string", "enum": _TAINT_EFFECTS},
            },
        },
        "x-validations": [
            {
                "rule": (
                    "self.all(t, self.filter(o, o.key == t.key &&"
                    " o.effect == t.effect).size() == 1)"
                ),
                "message": "no duplicate (key, effect) taints",
            }
        ],
    }


def _budget_schema() -> Dict:
    return {
        "type": "object",
        "required": ["nodes"],
        "properties": {
            "reasons": {
                "type": "array",
                "items": {
                    "type": "string",
                    "enum": ["Underutilized", "Empty", "Drifted"],
                },
            },
            "nodes": {"type": "string", "pattern": _BUDGET_NODES_PATTERN},
            "schedule": {
                "type": "string",
                "x-cron-field-pattern": _CRON_FIELD_PATTERN,
                "x-cron-shorthands": sorted(val._CRON_SHORTHANDS),
            },
            "duration": {"type": "string"},
        },
        "x-validations": [
            {
                # the reference's CEL marker at nodepool.go:79
                "rule": "has(self.schedule) == has(self.duration)",
                "message": (
                    "schedule and duration must be set together"
                ),
            }
        ],
    }


def nodepool_schema() -> Dict:
    return {
        "apiVersion": "karpenter-tpu/v1",
        "kind": "NodePoolSchema",
        "metadata": {"name": "nodepools.karpenter-tpu"},
        "spec": {
            "type": "object",
            "required": ["template"],
            "properties": {
                "weight": {"type": "integer", "minimum": 1, "maximum": 100},
                "limits": {
                    "type": "object",
                    "additionalProperties": {"type": "string"},
                },
                "disruption": {
                    "type": "object",
                    "properties": {
                        "consolidationPolicy": {
                            "type": "string",
                            "enum": [
                                "WhenEmpty",
                                "WhenEmptyOrUnderutilized",
                            ],
                        },
                        "consolidateAfter": {"type": "string"},
                        "budgets": {
                            "type": "array",
                            "items": _budget_schema(),
                        },
                    },
                },
                "template": {
                    "type": "object",
                    "properties": {
                        "metadata": {
                            "type": "object",
                            "properties": {
                                "labels": {
                                    "type": "object",
                                    "additionalProperties": {
                                        "type": "string",
                                        "maxLength": 63,
                                        "x-name-pattern": _VALUE_PATTERN,
                                    },
                                    "x-restricted-keys": sorted(
                                        labels_mod.RESTRICTED_LABELS
                                        | {labels_mod.NODEPOOL_LABEL_KEY}
                                    ),
                                },
                            },
                        },
                        "spec": {
                            "type": "object",
                            "properties": {
                                "requirements": {
                                    "type": "array",
                                    "items": _requirement_schema(),
                                },
                                "taints": _taints_schema(),
                                "startupTaints": _taints_schema(),
                                "expireAfter": {"type": "string"},
                                "terminationGracePeriod": {"type": "string"},
                            },
                        },
                    },
                },
            },
        },
    }


def nodeclaim_schema() -> Dict:
    return {
        "apiVersion": "karpenter-tpu/v1",
        "kind": "NodeClaimSchema",
        "metadata": {"name": "nodeclaims.karpenter-tpu"},
        "spec": {
            "type": "object",
            "properties": {
                "requirements": {
                    "type": "array",
                    "items": _requirement_schema(),
                },
                "taints": _taints_schema(),
                "startupTaints": _taints_schema(),
                "nodePoolName": {"type": "string"},
                "expireAfter": {"type": "string"},
            },
        },
    }


def generate(directory: str = CRD_DIR) -> Dict[str, str]:
    """Write the schema artifacts; returns {filename: yaml_text}."""
    import yaml

    os.makedirs(directory, exist_ok=True)
    out = {}
    for name, schema in (
        ("karpenter_tpu_nodepools.yaml", nodepool_schema()),
        ("karpenter_tpu_nodeclaims.yaml", nodeclaim_schema()),
    ):
        text = (
            "# Generated by `python -m karpenter_tpu.api.schema` — do not"
            " edit.\n# Rule content mirrors api/validation.py; the"
            " round-trip test keeps them in lockstep.\n"
            + yaml.safe_dump(schema, sort_keys=True)
        )
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(text)
        out[name] = text
    return out


if __name__ == "__main__":
    for name in generate():
        print(f"wrote {os.path.join(CRD_DIR, name)}")
