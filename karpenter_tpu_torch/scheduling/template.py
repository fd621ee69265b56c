# Copied from karpenter_tpu/scheduling/template.py.
"""NodeClaimTemplate: NodePool -> launchable claim template.

Mirror of the reference's nodeclaimtemplate.go:35-97: precomputed
Requirements from the pool template (requirements + labels + pool identity),
with price-ordered truncation to MAX_INSTANCE_TYPES at claim-creation time.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..api import labels as labels_mod
from ..api.objects import (
    NodeClaim,
    NodeClaimSpec,
    NodePool,
    NodeSelectorRequirement,
    ObjectMeta,
    new_uid,
)
from ..api.requirements import Operator, Requirement, Requirements
from ..cloudprovider import types as cp

MAX_INSTANCE_TYPES = 60


class NodeClaimTemplate:
    def __init__(self, node_pool: NodePool):
        self.node_pool_name = node_pool.name
        self.node_pool_uid = node_pool.uid
        self.node_pool_weight = node_pool.spec.weight
        template = node_pool.spec.template
        self.labels = dict(template.labels)
        self.labels[labels_mod.NODEPOOL_LABEL_KEY] = node_pool.name
        self.annotations = dict(template.annotations)
        self.spec = template.spec
        self.taints = list(template.spec.taints)
        self.startup_taints = list(template.spec.startup_taints)
        self.instance_type_options: List[cp.InstanceType] = []
        self.requirements = Requirements()
        self.requirements.add(
            *(r.to_requirement() for r in template.spec.requirements)
        )
        self.requirements.add(*Requirements.from_labels(self.labels).values())

    def new_claim_name(self) -> str:
        return f"{self.node_pool_name}-{new_uid()[:8]}"

    def to_node_claim(
        self, instance_type_options=None, requirements=None
    ) -> NodeClaim:
        """Materialize a NodeClaim CR, truncating instance types by price
        (nodeclaimtemplate.go:71-97).

        Callers pass the claim's OWN narrowed options/requirements (the
        reference embeds a per-claim template copy; this template object is
        shared, so the narrowing travels explicitly).
        """
        options = (
            instance_type_options
            if instance_type_options is not None
            else self.instance_type_options
        )
        reqs = Requirements(
            *(
                r
                for r in (requirements if requirements is not None else self.requirements)
                # the scheduling hostname placeholder must not reach the CR
                # (reference FinalizeScheduling, nodeclaim.go:242-258)
                if r.key != labels_mod.HOSTNAME
            )
        )
        # minValues is re-validated AFTER the 60-type truncation: the
        # cheapest prefix may span too few distinct values even though the
        # full option set satisfied the floor (nodeclaimtemplate
        # ToNodeClaim; instance_selection_test.go:1337). Solve results are
        # pre-validated (Results.truncate_instance_types); this guards
        # direct launches.
        ordered, err = cp.truncate(options, reqs, MAX_INSTANCE_TYPES)
        if err is not None:
            raise ValueError(
                "minValues requirement is not met after truncation: " + err
            )
        reqs.add(
            Requirement(
                labels_mod.INSTANCE_TYPE,
                Operator.IN,
                [it.name for it in ordered],
                min_values=reqs.get(labels_mod.INSTANCE_TYPE).min_values,
            )
        )
        name = self.new_claim_name()
        spec = NodeClaimSpec(
            requirements=[
                NodeSelectorRequirement(
                    r.key,
                    r.operator().value,
                    tuple(r.values_list()),
                    min_values=r.min_values,
                )
                for r in reqs
            ],
            taints=list(self.taints),
            startup_taints=list(self.startup_taints),
            node_class_ref=self.spec.node_class_ref,
            expire_after=self.spec.expire_after,
            termination_grace_period=self.spec.termination_grace_period,
        )
        return NodeClaim(
            metadata=ObjectMeta(
                name=name,
                labels=dict(self.labels),
                annotations=dict(self.annotations),
                owner_uids=[self.node_pool_uid],
            ),
            spec=spec,
        )
