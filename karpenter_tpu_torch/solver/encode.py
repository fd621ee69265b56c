# Copied from karpenter_tpu/solver/encode.py, 3 comment lines reworded.
"""Snapshot encoding: scheduling problem -> dense device arrays.

The TPU formulation departs from the reference's pod-by-pod loop in two ways:

1. **Pod grouping.** Pods with identical requests + requirements +
   tolerations are one *group* with a count. A 50k-pod deployment becomes a
   single group; the FFD scan runs over groups, not pods, and places whole
   groups by water-filling (ops/packing.py).
2. **Mask algebra.** Requirements become boolean masks over an interned
   vocabulary (solver/vocab.py) so compatibility is a batched AND/ANY
   reduction instead of per-key set walks (the vectorization of
   filterInstanceTypesByRequirements, reference nodeclaim.go:363-426).

Resource quantities are quantized to per-resource integer units that fit
float32 exactly (cpu: milli, memory-like: MiB ceil-for-requests /
floor-for-capacity, counts: whole): conservative, never over-packs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as labels_mod
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import Pod
from ..api.requirements import Operator, Requirement, Requirements, pod_requirements
from ..cloudprovider import types as cp
from ..scheduling.template import NodeClaimTemplate
from ..scheduling.topology import MAX_SKEW_UNBOUNDED, TopologyType
from .vocab import Vocab, _next_pow2

_MEMORY_LIKE = ("memory", "storage", "hugepages")

HCAP_NONE = 2**30  # sentinel: no per-entity topology cap

# domain-constraint modes for the kernel's quota machinery (ops/packing.py)
DMODE_NONE = 0
DMODE_SPREAD = 1
DMODE_AFFINITY = 2
# gate modes: the group is constrained by the counts but does not move them
# (the owner pod is NOT selected by its own constraint; the reference checks
# skew/options against counts other pods' placements evolve,
# topologygroup.go:205-251 / :277-290 with selects(pod)=false). Admissible
# domains are re-derived each step from the shared carry.
DMODE_GATE_SPREAD = 3
DMODE_GATE_AFF = 4

# topology keys whose domains are interned in the offering vocabulary and
# therefore ride the TPU as a dense domain axis (solver/vocab.py)
DOMAIN_KEYS = (labels_mod.TOPOLOGY_ZONE, labels_mod.CAPACITY_TYPE_LABEL_KEY)
_DRANK_NONE = 2**28

# synthetic per-CSI-driver resource columns: pods with volumes consume
# attach slots as an ordinary resource the pack phase ledgers (requests
# ceil per pod, node capacity = remaining CSINode attach limit). Fresh
# claims have no CSINode yet, so their columns carry the no-limit
# sentinel — exactly the oracle's "limits only apply to existing nodes"
# (scheduling/volumeusage.py).
VOL_RES_PREFIX = "ktpu.io/vol-"
VOL_UNLIMITED = float(2**24)  # float32-exact; far above any attach limit
# per-pod memoized routing verdict sentinel; a STRING so it survives
# copy.deepcopy of a pod (an object() sentinel would deep-copy to a new
# identity and masquerade as a group key)
_NOT_TENSORIZABLE = "__not_tensorizable__"

# EncodedSnapshot array fields with a G or N axis (padded by .padded()) and
# those provably without one; .padded() refuses unclassified fields so a
# new axis-carrying field cannot silently ship unpadded
_PADDED_FIELDS = frozenset({
    "g_count", "g_req", "g_def", "g_neg", "g_mask", "g_hcap", "g_haff",
    "g_dmode", "g_dkey", "g_dskew", "g_dmin0", "g_dprior", "g_dreg",
    "g_drank", "g_hstg", "g_hscap", "g_dtg",
    "g_hself", "g_hcontrib", "g_dcontrib",
    "p_tol", "n_tol", "n_hcnt",
    "n_avail", "n_base", "n_def", "n_mask", "n_dzone", "n_dct", "nh_cnt0",
})
_GN_FREE_FIELDS = frozenset({
    "t_alloc", "t_cap", "t_def", "t_mask", "t_price",
    "o_avail", "o_zone", "o_ct", "o_price",
    "p_def", "p_neg", "p_mask", "p_daemon", "p_limit", "p_has_limit",
    "p_titype_ok",
    "p_mvmin", "t_mvoh",
    "dd0", "dtg_key", "well_known",
    # the compacted segment index rides its own live-pair axis (L / LZ,
    # power-of-two bucketed); entries name REAL group rows, which padding
    # never moves, so the arrays are valid for any padded G
    "gk_g", "gk_k", "gk_w", "goff_idx",
})


def _unit_divisor(resource_name: str) -> int:
    if resource_name == res.CPU:
        return 1  # milli-cpu
    if resource_name.startswith(VOL_RES_PREFIX):
        # attach-slot columns are whole-unit counts regardless of the CSI
        # driver's NAME — "pd.csi.storage.gke.io" must not quantize as
        # memory-like or the kernel over-packs past the attach limit
        return res.MILLI
    if any(tag in resource_name for tag in _MEMORY_LIKE):
        return 2**20 * res.MILLI  # MiB
    return res.MILLI  # whole units (pods, gpus, ...)


def quantize_requests(rl: res.ResourceList, names: Sequence[str]) -> np.ndarray:
    """Ceil to units (requests must never be under-counted)."""
    out = np.zeros(len(names), dtype=np.float32)
    for i, name in enumerate(names):
        q = rl.get(name, 0)
        d = _unit_divisor(name)
        out[i] = -((-q) // d)
    return out

def quantize_capacity(rl: res.ResourceList, names: Sequence[str]) -> np.ndarray:
    """Floor to units (capacity must never be over-counted)."""
    out = np.zeros(len(names), dtype=np.float32)
    for i, name in enumerate(names):
        out[i] = rl.get(name, 0) // _unit_divisor(name)
    return out


def _node_single_value(en, key: str) -> Optional[str]:
    """The node's concrete value for a label key, if single-valued."""
    if not en.requirements.has(key):
        return None
    r = en.requirements.get(key)
    if r.complement or len(r.values) != 1:
        return None
    return next(iter(r.values))


def _observe_node_domains(vocab: "Vocab", en) -> None:
    for key in DOMAIN_KEYS:
        v = _node_single_value(en, key)
        if v is not None:
            vocab.value_id(key, v)


def _node_domain_id(vocab: "Vocab", en, key: str) -> int:
    v = _node_single_value(en, key)
    return vocab.value_id(key, v) if v is not None else -1


@dataclass
class SharedHostTG:
    """A hostname-keyed constraint shared by several pod groups (e.g. one
    Deployment's anti-affinity across request shapes). Counts live in the
    kernel carry, indexed by the slot encode() assigns; ``counts`` are the
    cluster priors per hostname. ``tg`` back-references the oracle
    TopologyGroup this descriptor distilled from (host-side only — never
    encoded; the scenario axis uses it to re-derive per-scenario priors)."""

    cap: int
    counts: Dict[str, int] = field(default_factory=dict)
    tg: object = None

    def content(self) -> tuple:
        return (self.cap, tuple(sorted(self.counts.items())))


@dataclass
class SharedDomainTG:
    """A zone/capacity-type-keyed constraint shared by several pod groups.
    Descriptor fields mirror TopoSpec's d* fields; the evolving counts ride
    the kernel's domain carry. ``tg`` is the host-side oracle back-ref."""

    key: str
    mode: int
    skew: int = 0
    min0: bool = False
    prior: Dict[str, int] = field(default_factory=dict)
    reg: frozenset = frozenset()
    tg: object = None

    def content(self) -> tuple:
        return (
            self.key, self.mode, self.skew, self.min0,
            tuple(sorted(self.prior.items())), tuple(sorted(self.reg)),
        )


@dataclass
class TopoSpec:
    """Tensorized topology state for one pod group.

    Host-side distillation of the oracle's TopologyGroups
    (scheduling/topology.py) into the forms the kernel consumes:

    - hostname-keyed constraints collapse to a per-entity cap: hostname
      domains have a global min of 0 (reference topologygroup.go:253-274),
      so "count+1-min <= maxSkew" is just "<= maxSkew pods of this group per
      node/claim"; self anti-affinity is the maxSkew=1 case of the same rule
      (empty-domain selection, topologygroup.go:340-366).
    - domain-keyed (zone / capacity-type) constraints become a per-group
      descriptor over the interned value slots: self-selecting spread
      (DMODE_SPREAD) carries maxSkew + priors + the registered universe for
      the kernel's quota water-fill (topologygroup.go:205-251); affinity
      with no compatible placed pods (DMODE_AFFINITY) triggers the
      bootstrap single-domain rule (topologygroup.go:277-324).
      Non-self-selecting gates and affinity-with-priors need no kernel
      state at all — they intersect the group's requirement mask in
      _resolve_topology.
    - prior counts come from cluster pods already selected by the
      constraint (topology.go:322-420), keyed by node name / domain value.
    """

    host_cap: Optional[int] = None  # per-entity cap; None = unconstrained
    host_counts: Dict[str, int] = field(default_factory=dict)  # node -> prior
    # hostname-keyed POD_AFFINITY: the whole group co-locates on ONE entity
    # (topologygroup.go:277-324 hostname case). With priors, candidates are
    # exactly the prior-holding nodes; without, the bootstrap pins the
    # first fitting entity and the rest follow (overflow = pod errors).
    haff: bool = False
    haff_prior: Dict[str, int] = field(default_factory=dict)  # node -> count
    dmode: int = DMODE_NONE
    dkey: Optional[str] = None  # TOPOLOGY_ZONE or CAPACITY_TYPE_LABEL_KEY
    dskew: int = 0
    dmin0: bool = False  # minDomains unsatisfied: global min pinned to 0
    dprior: Dict[str, int] = field(default_factory=dict)  # domain -> count
    dreg: frozenset = frozenset()  # registered ∧ pod-admissible domains
    # constraints shared across groups: same descriptor object on every
    # sharing group's spec; encode() assigns carry slots by object identity
    shared_h: Optional[SharedHostTG] = None
    shared_d: Optional[SharedDomainTG] = None
    # shared-hostname role: True = self-selecting owner (per-entity cap of
    # h_capval, counts itself), False = gated-only owner (entities whose
    # carry count exceeds h_capval are blocked; placements never counted)
    h_self: bool = True
    h_capval: Optional[int] = None  # overrides shared_h.cap when set
    # shared constraints this group's placements COUNT toward without being
    # gated by them (the group's pods match the selector but don't own the
    # constraint — the oracle counts them at record(), topology.py:491-498)
    contrib_h: List[SharedHostTG] = field(default_factory=list)
    contrib_d: List[SharedDomainTG] = field(default_factory=list)
    # host-side oracle back-refs (never encoded): the TopologyGroups the
    # dynamic state above distilled from — ``src_h`` the self-selecting
    # hostname constraints folded into host_cap/host_counts, ``src_d`` the
    # private domain-dynamic constraint. The scenario-batched axis walks
    # these to re-derive per-scenario priors when candidate nodes' bound
    # pods count toward a constraint.
    src_h: List[object] = field(default_factory=list)
    src_d: object = None
    # total hostname constraints folded into host_cap/host_counts (self +
    # gate): the scenario corrections are additive only for a single-source
    # fold, so the count gates representability
    host_nsrc: int = 0

    def content_sig(self) -> tuple:
        """Canonical content signature for the delta-encode contract: two
        groups whose sig (plus slot structure, added by the caller) match
        encode to identical g_* topology rows."""
        return (
            self.host_cap,
            tuple(sorted(self.host_counts.items())),
            self.haff,
            tuple(sorted(self.haff_prior.items())),
            self.dmode, self.dkey, self.dskew, self.dmin0,
            tuple(sorted(self.dprior.items())),
            tuple(sorted(self.dreg)),
            self.h_self, self.h_capval,
        )


@dataclass
class PodGroup:
    """An equivalence class of schedulable pods."""

    pods: List[Pod]
    requirements: Requirements
    requests: res.ResourceList
    topo: Optional[TopoSpec] = None

    @property
    def count(self) -> int:
        return len(self.pods)


def _tsc_key(t) -> tuple:
    """Memoized identity tuple for a TopologySpreadConstraint (hot in the
    50k-pod grouping loop; constraint objects are immutable in practice)."""
    k = getattr(t, "_key_cache", None)
    if k is None:
        k = (
            t.max_skew, t.topology_key, t.when_unsatisfiable,
            t.label_selector.key() if t.label_selector else None,
            t.min_domains, t.node_affinity_policy, t.node_taints_policy,
        )
        object.__setattr__(t, "_key_cache", k)
    return k


def _term_key(t) -> tuple:
    """Memoized identity tuple for a PodAffinityTerm."""
    k = getattr(t, "_key_cache", None)
    if k is None:
        k = (
            t.topology_key,
            t.label_selector.key() if t.label_selector else None,
            t.namespaces,
        )
        object.__setattr__(t, "_key_cache", k)
    return k


def group_key(pod: Pod) -> tuple:
    """Equivalence key from raw spec primitives — no Requirements objects
    are built per pod (hot for 50k-pod snapshots); the group's Requirements
    are constructed once in build_groups. Frozensets, not sorted tuples:
    only equality/hash matter here and set construction is ~2x faster.

    Pods carrying topology constraints additionally key on namespace +
    labels + the constraint signatures: their placement depends on selector
    matching, so only pods that count identically may share a group."""
    spec = pod.spec
    affinity_key = ()
    if spec.node_affinity is not None and spec.node_affinity.required:
        affinity_key = tuple(
            (t.key, t.operator, tuple(t.values), t.min_values)
            for t in spec.node_affinity.required[0]
        )
    base = (
        frozenset(spec.requests.items()),
        frozenset(spec.node_selector.items()) if spec.node_selector else (),
        affinity_key,
        frozenset(
            (t.key, t.operator, t.value, t.effect) for t in spec.tolerations
        ) if spec.tolerations else (),
    )
    if not (spec.topology_spread_constraints or spec.pod_anti_affinity or spec.pod_affinity):
        return base
    topo = (
        pod.metadata.namespace,
        frozenset(pod.metadata.labels.items()),
        tuple(_tsc_key(t) for t in spec.topology_spread_constraints),
        tuple(_term_key(t) for t in spec.pod_affinity),
        tuple(_term_key(t) for t in spec.pod_anti_affinity),
    )
    return base + topo


_EMPTY_FS = frozenset()


def _sel_signature(pod: Pod, sel_keys: frozenset) -> tuple:
    """(namespace, selector-relevant labels) appended to the group key of
    pods whose own key carries no labels: selector matching for the
    shared-constraint contributor role must be uniform per group."""
    lbl = pod.metadata.labels
    return (
        pod.metadata.namespace,
        frozenset((k, v) for k, v in lbl.items() if k in sel_keys)
        if lbl
        else _EMPTY_FS,
    )


def is_tensorizable(
    pod: Pod, allow_topology: bool = False, allow_volumes: bool = False
) -> bool:
    """Pods the TPU fast path handles; the rest route to the host oracle.

    ``allow_topology`` admits the topology shapes the kernel models —
    hostname-keyed spread / anti-affinity (per-entity caps) and zone- or
    capacity-type-keyed spread / pod-affinity (domain quotas / mask gates)
    — subject to the global cross-group checks in partition_and_group (a
    Topology context is required for those). ``allow_volumes`` admits pods
    whose volumes the driver has resolved into attach-slot requests
    (driver.prepare_volume_routing: fresh non-shared volumes become
    synthetic resource columns the pack-phase ledger consumes; zonal
    constraints were already injected as node affinity upstream).
    Everything else with sequential state (host ports, preference
    relaxation, Gt/Lt) stays host-side."""
    spec = pod.spec
    if not allow_topology and (
        spec.topology_spread_constraints or spec.pod_anti_affinity or spec.pod_affinity
    ):
        return False
    if allow_topology:
        for tsc in spec.topology_spread_constraints:
            if tsc.topology_key != labels_mod.HOSTNAME and (
                tsc.topology_key not in DOMAIN_KEYS
            ):
                return False  # custom topology keys stay host-side
            if tsc.when_unsatisfiable != "DoNotSchedule":
                return False  # ScheduleAnyway relaxes host-side
            if tsc.node_taints_policy == "Honor":
                return False  # taint-gated counting stays host-side
        for term in spec.pod_anti_affinity:
            # zonal anti-affinity serializes host-side: the oracle records
            # EVERY domain of a multi-domain claim as occupied
            # (topology.go:205-214), which the quota form cannot express
            if term.topology_key != labels_mod.HOSTNAME:
                return False
        if len(spec.pod_anti_affinity) > 1:
            return False
        for term in spec.pod_affinity:
            # zone/ct affinity rides the domain machinery; hostname
            # affinity (co-locate on one node) rides the single-entity
            # pin (_resolve_topology admits only the self-selecting,
            # group-private shape)
            if (
                term.topology_key not in DOMAIN_KEYS
                and term.topology_key != labels_mod.HOSTNAME
            ):
                return False
        if len(spec.pod_affinity) > 1:
            return False
    if spec.preferred_pod_affinity or spec.preferred_pod_anti_affinity:
        return False
    if spec.host_ports or (spec.volumes and not allow_volumes):
        return False
    if spec.node_affinity is not None:
        if spec.node_affinity.preferred or len(spec.node_affinity.required) > 1:
            return False  # relaxation loop is host-side
        for term in spec.node_affinity.required[:1]:
            for r in term:
                if r.min_values is not None:
                    return False
                # Gt/Lt carry operator identity the mask algebra can't retain
                # through intersections (the double-negation exemption
                # distinguishes NotIn from Gt); rare enough to stay host-side
                if r.operator in ("Gt", "Lt"):
                    return False
    return True


@dataclass
class EncodedSnapshot:
    """Device-ready arrays for one solve. Shapes:
    G groups, T types, P templates(pools), N existing nodes, R resources,
    K keys, V1 value slots (last = overflow), O offerings per type.
    """

    vocab: Vocab
    resource_names: List[str]
    groups: List[PodGroup]
    templates: List[NodeClaimTemplate]
    instance_types: List[cp.InstanceType]
    existing_names: List[str]

    # groups
    g_count: np.ndarray  # [G] int32
    g_req: np.ndarray  # [G, R] f32
    g_def: np.ndarray  # [G, K] bool
    g_neg: np.ndarray  # [G, K] bool
    g_mask: np.ndarray  # [G, K, V1] bool
    g_hcap: np.ndarray  # [G] int32 per-entity cap (hostname topology; HCAP_NONE=free)
    n_hcnt: np.ndarray  # [N, G] int32 prior selected-pod counts per existing
    # node — per-entity-cap priors for capped groups; for g_haff groups the
    # SAME rows hold the hostname-affinity matching-pod priors (the two
    # never combine: _resolve_topology demotes the combo)
    g_haff: np.ndarray  # [G] bool hostname-affinity single-entity pin
    # domain-keyed (zone / capacity-type) constraint descriptors
    g_dmode: np.ndarray  # [G] int32 DMODE_*
    g_dkey: np.ndarray  # [G] int32 0=zone 1=capacity-type
    g_dskew: np.ndarray  # [G] int32 maxSkew
    g_dmin0: np.ndarray  # [G] bool minDomains pins global min to 0
    g_dprior: np.ndarray  # [G, V1] int32 prior counts per domain slot
    g_dreg: np.ndarray  # [G, V1] bool registered ∧ pod-admissible domains
    g_drank: np.ndarray  # [G, V1] int32 sorted-domain rank (bootstrap order)
    n_dzone: np.ndarray  # [N] int32 node zone value id (-1 = none)
    n_dct: np.ndarray  # [N] int32 node capacity-type value id (-1 = none)
    # shared-constraint carries (cross-group counting)
    g_hstg: np.ndarray  # [G] int32 shared hostname-constraint slot (-1 none)
    g_hscap: np.ndarray  # [G] int32 per-entity cap (self) / gate threshold
    g_dtg: np.ndarray  # [G] int32 shared domain-constraint slot (-1 none)
    g_hself: np.ndarray  # [G] bool shared-hostname role (True = counts itself)
    g_hcontrib: np.ndarray  # [G, JH] bool slots this group counts toward
    g_dcontrib: np.ndarray  # [G, JD] bool slots this group counts toward
    nh_cnt0: np.ndarray  # [N, JH] int32 shared-constraint node priors
    dd0: np.ndarray  # [JD, V1] int32 shared domain-count carry init (zeros)
    dtg_key: np.ndarray  # [JD] int32 shared domain-constraint axis (0=zone)

    # instance types
    t_alloc: np.ndarray  # [T, R] f32
    t_cap: np.ndarray  # [T, R] f32 (capacity, for limits accounting)
    t_def: np.ndarray  # [T, K] bool
    t_mask: np.ndarray  # [T, K, V1] bool
    t_price: np.ndarray  # [T] f32 cheapest available offering (unconstrained)

    # offerings
    o_avail: np.ndarray  # [T, O] bool
    o_zone: np.ndarray  # [T, O] int32 (value id in zone vocab; -1 pad)
    o_ct: np.ndarray  # [T, O] int32
    o_price: np.ndarray  # [T, O] f32

    # templates (nodepools, weight-desc order)
    p_def: np.ndarray  # [P, K] bool
    p_neg: np.ndarray  # [P, K] bool
    p_mask: np.ndarray  # [P, K, V1] bool
    p_daemon: np.ndarray  # [P, R] f32
    p_limit: np.ndarray  # [P, R] f32 (inf when unlimited)
    p_has_limit: np.ndarray  # [P] bool
    p_titype_ok: np.ndarray  # [P, T] bool  template prefilter
    p_tol: np.ndarray  # [P, G] bool  group tolerates template taints
    # dense minValues: MV = distinct requirement keys carrying min_values
    # across templates, W = padded distinct-value bound over the catalog.
    # p_mvmin[p, j] is template p's floor for key slot j (0 = none);
    # t_mvoh[t, j, w] marks instance type t offering catalog value w of key
    # slot j (the raw per-type value union satisfies_min_values counts,
    # cloudprovider/types.go:155-233). MV == 0 traces the whole minValues
    # machinery out of the kernels.
    p_mvmin: np.ndarray  # [P, MV] int32
    t_mvoh: np.ndarray  # [T, MV, W] bool

    # existing nodes (priority order: initialized first, then name)
    n_avail: np.ndarray  # [N, R] f32 (available to new pods)
    n_base: np.ndarray  # [N, R] f32 (already-committed daemon remainder)
    n_def: np.ndarray  # [N, K] bool
    n_mask: np.ndarray  # [N, K, V1] bool
    n_tol: np.ndarray  # [N, G] bool

    zone_kid: int
    ct_kid: int
    well_known: np.ndarray  # [K] bool

    # compacted nonzero-mask segment index over the group requirement axis
    # (build_segment_index): the (group, key) pairs whose requirement row
    # differs from the neutral all-true row. The sparse feasibility kernels
    # (ops/feasibility.py:*_sparse) contract over these L live pairs with
    # segment_sum instead of materializing the dense [P, G, T, K, V1] join,
    # so feasibility cost scales with live pairs, not G x K. Both axes are
    # power-of-two bucketed so group churn shares compiled programs.
    gk_g: np.ndarray  # [L] int32 group id per live pair (0 on padding)
    gk_k: np.ndarray  # [L] int32 key id per live pair (0 on padding)
    gk_w: np.ndarray  # [L] int32 1 live / 0 padding
    goff_idx: np.ndarray  # [LZ] int32 groups whose zone/ct row is non-neutral

    def padded(self, g_target: int, n_target: int) -> "EncodedSnapshot":
        """A copy with the group and existing-node axes padded to bucket
        sizes, so repeat solves of nearby shapes (e.g. consolidation's
        binary-search probes, each with a slightly different candidate set)
        share one compiled program instead of recompiling per probe.

        Padded groups have count 0 and place nothing; padded nodes have no
        capacity and no tolerance, so they never receive fills. Decode
        reads ``groups``/``existing_names`` (unpadded) and only walks
        nonzero fills, so outputs stay correct.
        """
        import dataclasses

        G = len(self.g_count)
        N = self.n_avail.shape[0]
        gp = max(g_target - G, 0)
        np_pad = max(n_target - N, 0)
        if not gp and not np_pad:
            return self
        # exhaustiveness guard: every array field must either be padded
        # below or be known G/N-free — a new G/N-axis field silently
        # shipping unpadded would clamp-index real groups inside jit
        known = _PADDED_FIELDS | _GN_FREE_FIELDS
        for f in dataclasses.fields(self):
            if isinstance(getattr(self, f.name), np.ndarray) and f.name not in known:
                raise AssertionError(
                    f"EncodedSnapshot.{f.name} is not classified for padded();"
                    " add it to _PADDED_FIELDS or _GN_FREE_FIELDS"
                )

        def pad(arr, axis, width, fill=0):
            if not width:
                return arr
            widths = [(0, 0)] * arr.ndim
            widths[axis] = (0, width)
            return np.pad(arr, widths, constant_values=fill)

        return dataclasses.replace(
            self,
            g_count=pad(self.g_count, 0, gp),
            g_req=pad(self.g_req, 0, gp),
            g_def=pad(self.g_def, 0, gp),
            g_neg=pad(self.g_neg, 0, gp),
            g_mask=pad(self.g_mask, 0, gp, fill=1),
            g_hcap=pad(self.g_hcap, 0, gp, fill=HCAP_NONE),
            g_haff=pad(self.g_haff, 0, gp),
            g_dmode=pad(self.g_dmode, 0, gp),
            g_dkey=pad(self.g_dkey, 0, gp),
            g_dskew=pad(self.g_dskew, 0, gp),
            g_dmin0=pad(self.g_dmin0, 0, gp),
            g_dprior=pad(self.g_dprior, 0, gp),
            g_dreg=pad(self.g_dreg, 0, gp),
            g_drank=pad(self.g_drank, 0, gp, fill=_DRANK_NONE),
            g_hstg=pad(self.g_hstg, 0, gp, fill=-1),
            g_hscap=pad(self.g_hscap, 0, gp, fill=HCAP_NONE),
            g_dtg=pad(self.g_dtg, 0, gp, fill=-1),
            g_hself=pad(self.g_hself, 0, gp, fill=1),
            g_hcontrib=pad(self.g_hcontrib, 0, gp),
            g_dcontrib=pad(self.g_dcontrib, 0, gp),
            p_tol=pad(self.p_tol, 1, gp),
            n_tol=pad(pad(self.n_tol, 1, gp), 0, np_pad),
            n_hcnt=pad(pad(self.n_hcnt, 1, gp), 0, np_pad),
            n_avail=pad(self.n_avail, 0, np_pad),
            n_base=pad(self.n_base, 0, np_pad),
            n_def=pad(self.n_def, 0, np_pad),
            n_mask=pad(self.n_mask, 0, np_pad, fill=1),
            n_dzone=pad(self.n_dzone, 0, np_pad, fill=-1),
            n_dct=pad(self.n_dct, 0, np_pad, fill=-1),
            nh_cnt0=pad(self.nh_cnt0, 0, np_pad),
        )

    def solve_args(
        self,
        a_tzc: np.ndarray,
        res_cap0: Optional[np.ndarray] = None,
        a_res: Optional[np.ndarray] = None,
    ) -> tuple:
        """The positional argument tuple for ops/solve.py:solve_core — the
        single authority on that ordering (driver, examples, the multi-chip
        padding, and the scenario axis all build from this; SOLVE_ARG_NAMES
        below names each position for axis selection)."""
        if res_cap0 is None:
            res_cap0 = np.zeros((0,), np.int32)
        if a_res is None:
            a_res = np.zeros((0,) + a_tzc.shape, bool)
        return (
            self.g_count, self.g_req, self.g_def, self.g_neg, self.g_mask,
            self.g_hcap, self.g_haff,
            self.g_dmode, self.g_dkey, self.g_dskew, self.g_dmin0,
            self.g_dprior, self.g_dreg, self.g_drank,
            self.g_hstg, self.g_hscap, self.g_dtg,
            self.g_hself, self.g_hcontrib, self.g_dcontrib,
            self.p_def, self.p_neg, self.p_mask, self.p_daemon,
            self.p_limit, self.p_has_limit, self.p_tol, self.p_titype_ok,
            self.t_def, self.t_mask, self.t_alloc, self.t_cap,
            self.o_avail, self.o_zone, self.o_ct,
            a_tzc, res_cap0, a_res,
            self.n_def, self.n_mask, self.n_avail, self.n_base, self.n_tol,
            self.n_hcnt,
            self.n_dzone, self.n_dct,
            self.nh_cnt0, self.dd0, self.dtg_key,
            self.well_known,
            self.p_mvmin, self.t_mvoh,
            self.gk_g, self.gk_k, self.gk_w, self.goff_idx,
        )


# Position names for EncodedSnapshot.solve_args' tuple, in order. The
# scenario-batched dispatch (ops/solve.py:solve_all_scenarios_packed) maps
# batched axes by name through this tuple, so it must track solve_args
# exactly (tests/test_scenario_batch.py pins the correspondence).
SOLVE_ARG_NAMES = (
    "g_count", "g_req", "g_def", "g_neg", "g_mask",
    "g_hcap", "g_haff",
    "g_dmode", "g_dkey", "g_dskew", "g_dmin0",
    "g_dprior", "g_dreg", "g_drank",
    "g_hstg", "g_hscap", "g_dtg",
    "g_hself", "g_hcontrib", "g_dcontrib",
    "p_def", "p_neg", "p_mask", "p_daemon",
    "p_limit", "p_has_limit", "p_tol", "p_titype_ok",
    "t_def", "t_mask", "t_alloc", "t_cap",
    "o_avail", "o_zone", "o_ct",
    "a_tzc", "res_cap0", "a_res",
    "n_def", "n_mask", "n_avail", "n_base", "n_tol",
    "n_hcnt",
    "n_dzone", "n_dct",
    "nh_cnt0", "dd0", "dtg_key",
    "well_known",
    "p_mvmin", "t_mvoh",
    "gk_g", "gk_k", "gk_w", "goff_idx",
)


def build_segment_index(
    g_def: np.ndarray,
    g_neg: np.ndarray,
    g_mask: np.ndarray,
    zone_kid: int,
    ct_kid: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compacted nonzero-mask index over the group requirement axis.

    A (group, key) pair is *live* when its requirement row differs from the
    neutral row (undefined, non-negated, all-true mask) — the only rows
    that can change a feasibility term away from the group-independent
    base. Returns (gk_g, gk_k, gk_w, goff_idx):

    - ``gk_g``/``gk_k``/``gk_w`` [L]: group id, key id, and 0/1 live weight
      per pair. L is power-of-two bucketed (floor 8) so group churn of
      nearby live-pair counts shares one compiled program; padding rows
      carry weight 0 and never contribute to a segment sum.
    - ``goff_idx`` [LZ]: ids of groups whose zone or capacity-type row is
      non-neutral — the only groups whose merged offering row differs from
      the template's. Padding repeats group 0: the sparse kernel scatters
      each listed group's *recomputed true row*, so duplicate writes are
      idempotent by construction.
    """
    neutral = (~g_def) & (~g_neg) & g_mask.all(axis=2)
    live = ~neutral  # [G, K]
    gg, kk = np.nonzero(live)
    L = _next_pow2(max(len(gg), 1), floor=8)
    gk_g = np.zeros((L,), np.int32)
    gk_k = np.zeros((L,), np.int32)
    gk_w = np.zeros((L,), np.int32)
    gk_g[: len(gg)] = gg
    gk_k[: len(gg)] = kk
    gk_w[: len(gg)] = 1
    offl = np.flatnonzero(live[:, zone_kid] | live[:, ct_kid])
    LZ = _next_pow2(max(len(offl), 1), floor=8)
    goff_idx = np.zeros((LZ,), np.int32)
    goff_idx[: len(offl)] = offl
    return gk_g, gk_k, gk_w, goff_idx


# -- incremental (delta) encoding -------------------------------------------


def shared_slot_ids(
    groups: Sequence["PodGroup"],
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """(hostname-slot, domain-slot) maps keyed by id(descriptor), assigned
    by first appearance over the group walk — EXACTLY _encode_groups'
    assignment, so callers (the scenario-batched prior corrections, the
    delta content tags) address the same carry columns the kernel reads."""
    h_slots: Dict[int, int] = {}
    d_slots: Dict[int, int] = {}
    for g in groups:
        t = g.topo
        if t is None:
            continue
        if t.shared_h is not None:
            h_slots.setdefault(id(t.shared_h), len(h_slots))
        if t.shared_d is not None:
            d_slots.setdefault(id(t.shared_d), len(d_slots))
        for d in t.contrib_h:
            h_slots.setdefault(id(d), len(h_slots))
        for d in t.contrib_d:
            d_slots.setdefault(id(d), len(d_slots))
    return h_slots, d_slots


def topo_content_sigs(groups: Sequence["PodGroup"]) -> tuple:
    """Per-group topology content signatures for the delta-encode
    contract: ``None`` for topology-free groups, else the TopoSpec content
    plus the shared-carry SLOT STRUCTURE (slot index + descriptor content
    per shared/contributed constraint). Slot indices are assigned by
    first-appearance order over the group walk — exactly
    ``_encode_groups``'s assignment — so equal sig tuples guarantee
    byte-identical g_* topology arrays AND carry layouts (dd0/dtg_key
    shapes, g_hcontrib/g_dcontrib columns)."""
    h_slots: Dict[int, int] = {}
    d_slots: Dict[int, int] = {}

    def _h(desc) -> int:
        return h_slots.setdefault(id(desc), len(h_slots))

    def _d(desc) -> int:
        return d_slots.setdefault(id(desc), len(d_slots))

    sigs = []
    for g in groups:
        t = g.topo
        if t is None:
            sigs.append(None)
            continue
        shared_h = (
            (_h(t.shared_h), t.shared_h.content())
            if t.shared_h is not None
            else None
        )
        shared_d = (
            (_d(t.shared_d), t.shared_d.content())
            if t.shared_d is not None
            else None
        )
        contrib_h = tuple((_h(d), d.content()) for d in t.contrib_h)
        contrib_d = tuple((_d(d), d.content()) for d in t.contrib_d)
        sigs.append(
            t.content_sig() + (shared_h, shared_d, contrib_h, contrib_d)
        )
    return tuple(sigs)


def _req_content_key(reqs) -> tuple:
    """Content identity of a Requirements object for cross-solve row
    reuse: everything vocab.encode reads, order-normalized."""
    return tuple(
        sorted(
            (
                r.key, r.complement, tuple(sorted(r.values)),
                r.greater_than, r.less_than,
            )
            for r in reqs
        )
    )


@dataclass
class EncodeDelta:
    """What changed between this encode and the previous one, in the
    shape the device-residency layer (solver/residency.py) consumes.

    ``reused`` means the prior EncodedSnapshot's arrays were returned
    verbatim (content-hash fast path: nothing relevant changed).
    ``full`` means no delta information is available (first encode, vocab
    growth, catalog change, topology in the batch) and every device
    buffer must be restaged. Otherwise the ``*_rows`` arrays name the
    ordered axis positions whose rows changed — ``node_rows`` for the
    pure node-content arrays (n_avail/n_base/n_def/n_mask/n_dzone/n_dct),
    ``group_rows`` for the g_* group-axis arrays, ``cross_rows`` for the
    node x group arrays (n_tol/n_hcnt/nh_cnt0). ``v_*`` are monotonic
    version counters per device-argument class; the residency store
    reuses a device buffer iff its class version is unchanged."""

    reused: bool = False
    full: bool = True
    delta_rows: int = 0
    node_rows: Optional[np.ndarray] = None
    group_rows: Optional[np.ndarray] = None
    count_rows: Optional[np.ndarray] = None
    cross_rows: Optional[np.ndarray] = None
    v_static: int = 0
    v_groups: int = 0
    v_gcount: int = 0
    v_nodes: int = 0
    v_cross: int = 0
    groups_unchanged: bool = False
    # group SHAPES (requests/requirements/tolerations/topology-freedom)
    # unchanged, only per-group counts moved — the steady-state churn
    # shape: every G-side array except g_count is reusable verbatim
    groups_shape_unchanged: bool = False


class ClusterEncoding:
    """Persistent incremental encoding of one cluster across solves.

    Owned by EncodeCache (one per control plane / sidecar), consulted by
    ``encode()`` when passed as ``cluster=``. Three layers, fastest first:

    1. **Content-hash fast path** — a fingerprint over (vocab generation,
       padded shape, resource axis, per-group content tags, per-node
       content tags, pool limits / daemon overhead) matches the previous
       encode's: the prior EncodedSnapshot's arrays are returned verbatim
       (fresh ``groups``/``existing_names`` metadata so decode binds the
       NEW pod/node objects), and the delta reports ``reused``.
    2. **Row banks** — content-keyed caches of the expensive per-row
       work (vocab.encode masks per requirement content, tolerance rows
       per taint content, quantized node rows per node content) so churn
       re-encodes only the changed rows; the assembled arrays are
       byte-identical to a from-scratch encode because the banks cache
       exactly what the from-scratch loops compute
       (tests/test_delta_encode.py pins this over random churn scripts).
    3. **Full re-encode** — vocab growth (a genuinely new label value),
       catalog change, or a topology-carrying batch drops the fast paths
       for that encode; the banks re-warm on the next pass.

    Delta tracking: each encode compares its ordered content-tag lists
    against the previous encode's and reports the changed axis positions
    plus per-class version counters (EncodeDelta above) — the device-
    residency layer transfers only those rows. Banks are periodically
    compacted: entries unused for ``2 * compact_every`` encodes are
    evicted every ``compact_every`` encodes, so one-off shapes don't
    accumulate across days of reconciles.

    Not thread-safe on its own: callers serialize on EncodeCache.lock
    (the same discipline encode's shared vocab already requires).
    """

    def __init__(self, compact_every: int = 64, owner: str = ""):
        self.compact_every = compact_every
        # multi-tenant attribution (solver/tenancy.py): whose warm banks
        # these are. Rides the ENCODE_DELTA fault ctx so tenant-scoped
        # chaos plans can match a specific tenant's encode leases.
        self.owner = owner
        self._epoch = None
        self._tol_epoch = None
        # content-keyed row banks; values are (last_used_tick, payload)
        # where the tick is the bank's OWN use clock — advanced only on
        # encodes that actually consult that bank, so a quiet cluster
        # (consecutive content-hash reuses, or count-only churn that
        # skips the group loop) cannot age live entries to eviction
        self.node_bank: Dict[tuple, tuple] = {}
        self.group_bank: Dict[tuple, tuple] = {}
        self.tol_bank: Dict[tuple, np.ndarray] = {}
        self._encodes = 0
        self._nuses = 0
        self._guses = 0
        # previous encode's state
        self._prior_snap: Optional[EncodedSnapshot] = None
        self._prior_gtags: Optional[tuple] = None
        self._prior_ntags: Optional[tuple] = None
        self._prior_tkeys: Optional[tuple] = None
        # per-class device-buffer versions (monotonic)
        self.v_static = 0
        self.v_groups = 0
        self.v_gcount = 0
        self.v_nodes = 0
        self.v_cross = 0
        self.last_delta = EncodeDelta(
            v_static=0, v_groups=0, v_nodes=0, v_cross=0
        )
        # scratch state between begin() and finish()
        self._gkeys: List[Optional[tuple]] = []
        self._gtags: Optional[tuple] = None
        self._ntags: Optional[tuple] = None
        self._tkeys: Optional[tuple] = None
        self._banks_on = False

    # -- lifecycle --------------------------------------------------------

    def invalidate(self, reason: str = "") -> None:
        """Drop every bank and the prior snapshot; the next encode is
        full. Called on catalog changes (EncodeCache.lease reset) and by
        the driver's corrupt-delta fallback half-step."""
        self._epoch = None
        self._tol_epoch = None
        self.node_bank.clear()
        self.group_bank.clear()
        self.tol_bank.clear()
        self._prior_snap = None
        self._prior_gtags = None
        self._prior_ntags = None
        self._prior_tkeys = None
        self.v_static += 1
        self.v_groups += 1
        self.v_gcount += 1
        self.v_nodes += 1
        self.v_cross += 1

    def _vocab_gen(self, vocab: Vocab) -> tuple:
        # serial pins the instance; the value total pins growth (complement
        # masks cached at one growth state would be stale after an intern)
        return (
            vocab.serial,
            len(vocab.keys),
            sum(len(v) for v in vocab.values),
        )

    def begin(
        self,
        vocab: Vocab,
        K: int,
        V1: int,
        resource_names: Sequence[str],
        groups: Sequence[PodGroup],
        existing_nodes: Sequence,
        daemon_overhead,
        pool_limits,
        hn_interned: bool,
    ) -> EncodeDelta:
        """Compute content tags + decide reuse. Called by encode() after
        vocab observation; scratch tags feed the bank lookups in the
        assembly loops and finish()'s delta computation."""
        self._encodes += 1
        epoch = (
            self._vocab_gen(vocab), K, V1, tuple(resource_names),
            hn_interned,
            tuple(
                sorted(
                    (getattr(nct, "node_pool_name", ""), tuple(sorted(rl.items())))
                    for nct, rl in (daemon_overhead or {}).items()
                )
            ),
            tuple(
                sorted(
                    (pool, tuple(sorted(rl.items())))
                    for pool, rl in (pool_limits or {}).items()
                )
            ),
        )
        if epoch != self._epoch:
            self.node_bank.clear()
            self.group_bank.clear()
            self._tol_epoch = None
            self._prior_snap = None
            self._prior_gtags = None
            self._prior_ntags = None
            self._prior_tkeys = None
            self._epoch = epoch
            self.v_static += 1
        self._banks_on = not hn_interned
        # per-group content tags; topology-carrying groups tag the FULL
        # TopoSpec content + shared-carry slot structure (topo_content_sigs)
        # so topology batches participate in the content-hash/delta fast
        # paths instead of forcing FULL re-encodes — an extension of the
        # incremental-encode contract. Equal sigs guarantee identical g_* topology
        # arrays and carry layouts; any prior/universe/role change breaks
        # the tag and restages.
        topo_sigs = topo_content_sigs(groups)
        gkeys: List[Optional[tuple]] = []
        gtags = []
        for g, tsig in zip(groups, topo_sigs):
            gk = _req_content_key(g.requirements)
            gkeys.append(gk)
            tolk = (
                tuple(
                    (t.key, t.operator, t.value, t.effect)
                    for t in g.pods[0].spec.tolerations
                )
                if g.pods[0].spec.tolerations
                else ()
            )
            gtags.append(
                (
                    g.count,
                    frozenset(g.requests.items()),
                    gk,
                    tolk,
                    tsig,
                )
            )
        # node identity extensions: hostname joins the tag whenever any
        # group carries topology (n_hcnt/nh_cnt0 rows are keyed by the
        # node's hostname — a positional node swap must break the fast
        # path); volume-ledger state joins when the resource axis carries
        # attach-slot columns (n_avail vol columns derive from it)
        has_topo = any(s is not None for s in topo_sigs)
        vol_cols = any(n.startswith(VOL_RES_PREFIX) for n in resource_names)
        ntags = []
        tkeys = []
        for en in existing_nodes:
            # the bank-sharing key excludes the hostname VALUE (it encodes
            # to the overflow slot identically across nodes) — but only
            # while no hostname value is interned. With one interned (a
            # pod node-selector naming a node), two nodes differing only
            # by hostname encode DIFFERENT mask rows, so the identity tag
            # must carry the full requirement content or a positional
            # node swap would pass the fast path undetected.
            ck = tuple(
                sorted(
                    (
                        r.key, r.complement, tuple(sorted(r.values)),
                        r.greater_than, r.less_than,
                    )
                    for r in en.requirements
                    if hn_interned or r.key != labels_mod.HOSTNAME
                )
            ) + (en.requirements.has(labels_mod.HOSTNAME),)
            ext: tuple = ()
            if has_topo:
                ext += (
                    en.state_node.hostname()
                    if hasattr(en, "state_node")
                    else en.name,
                )
            if vol_cols:
                vu = getattr(en, "volume_usage", None)
                ext += (
                    tuple(sorted((getattr(en, "volume_limits", None) or {}).items())),
                    tuple(sorted(vu.attached_counts().items()))
                    if vu is not None
                    else (),
                )
            ntags.append(
                (
                    ck,
                    tuple(sorted(en.cached_available.items())),
                    tuple(sorted(en.requests.items())),
                )
                + ext
            )
            tkeys.append(
                tuple((t.key, t.value, t.effect) for t in en.cached_taints)
            )
        self._gkeys = gkeys
        self._gtags = tuple(gtags)
        self._ntags = tuple(ntags)
        self._tkeys = tuple(tkeys)
        # tolerance-row bank epoch: rows are [G]-wide and keyed by group
        # toleration content in order, so any group change re-derives them
        tol_epoch = (epoch, tuple(t[3] for t in gtags), len(gtags))
        if tol_epoch != self._tol_epoch:
            self.tol_bank.clear()
            self._tol_epoch = tol_epoch
        groups_unchanged = (
            self._prior_snap is not None and self._gtags == self._prior_gtags
        )
        # count-only churn: same shapes in the same order, different
        # per-group counts — the common steady-state reconcile shape
        groups_shape_unchanged = groups_unchanged or (
            self._prior_snap is not None
            and tuple(t[1:] for t in self._gtags)
            == tuple(t[1:] for t in self._prior_gtags)
        )
        reused = (
            groups_unchanged
            and self._ntags == self._prior_ntags
            and self._tkeys == self._prior_tkeys
        )
        # advance each bank's use clock only when this encode will
        # consult it (eviction horizons count uses, not encodes)
        if not reused and self._banks_on:
            self._nuses += 1
            if not groups_shape_unchanged:
                self._guses += 1
        delta = EncodeDelta(
            reused=reused,
            full=not reused,
            groups_unchanged=groups_unchanged,
            groups_shape_unchanged=groups_shape_unchanged,
            v_static=self.v_static,
            v_groups=self.v_groups,
            v_gcount=self.v_gcount,
            v_nodes=self.v_nodes,
            v_cross=self.v_cross,
        )
        self.last_delta = delta
        return delta

    def reused_snapshot(
        self, groups, templates, instance_types, existing_nodes
    ) -> EncodedSnapshot:
        """The content-hash fast path: prior arrays verbatim, fresh
        metadata so decode binds this solve's pod/node objects (group i
        has the same count and content as last time — begin() proved it —
        so fills map positionally)."""
        import dataclasses

        from .. import faults

        faults.hit(faults.ENCODE_DELTA, reused=True, rows=0, owner=self.owner)
        self._maybe_compact()
        return dataclasses.replace(
            self._prior_snap,
            groups=list(groups),
            templates=list(templates),
            instance_types=list(instance_types),
            existing_names=[en.name for en in existing_nodes],
        )

    # -- bank accessors (called from encode()'s assembly loops) ----------

    def group_rows(self, i: int, vocab: Vocab, reqs, K: int, V1: int):
        """(g_def, g_neg, g_mask) rows for group i, bank-cached by
        requirement content."""
        if not self._banks_on:
            return vocab.encode(reqs, K, V1)
        gk = self._gkeys[i]
        hit = self.group_bank.get(gk)
        if hit is not None:
            self.group_bank[gk] = (self._guses, hit[1])
            return hit[1]
        rows = vocab.encode(reqs, K, V1)
        self.group_bank[gk] = (self._guses, rows)
        return rows

    def node_mask_rows(self, i: int, compute):
        """(n_def, n_mask, n_dzone, n_dct) for ordered node i, bank-cached
        by the node's non-hostname requirement content (the same sharing
        key the per-call row_cache uses); ``compute`` is the from-scratch
        fallback. The quantized capacity rows are NOT banked — they are a
        cheap per-node quantize and their content feeds the node tag, so
        staleness is impossible either way."""
        ck = self._ntags[i][0]
        hit = self.node_bank.get(ck)
        if hit is not None:
            self.node_bank[ck] = (self._nuses, hit[1])
            return hit[1]
        rows = compute()
        self.node_bank[ck] = (self._nuses, rows)
        return rows

    def tol_row(self, i: int, compute) -> np.ndarray:
        """The [G] tolerance row for ordered node i, keyed by taint
        content under the current group-toleration epoch."""
        tkey = self._tkeys[i]
        row = self.tol_bank.get(tkey)
        if row is None:
            row = compute()
            self.tol_bank[tkey] = row
        return row

    # -- delta bookkeeping ------------------------------------------------

    @staticmethod
    def _diff_positions(prev: Optional[tuple], cur: tuple) -> Optional[np.ndarray]:
        if prev is None:
            return None
        m = min(len(prev), len(cur))
        changed = [i for i in range(m) if prev[i] != cur[i]]
        changed.extend(range(m, max(len(prev), len(cur))))
        return np.asarray(changed, dtype=np.int32)

    def finish(self, snap: EncodedSnapshot) -> EncodeDelta:
        """Record this encode's snapshot as the new prior and derive the
        delta report (changed axis positions + class versions)."""
        from .. import faults

        delta = self.last_delta
        node_rows = self._diff_positions(self._prior_ntags, self._ntags)
        group_rows = self._diff_positions(self._prior_gtags, self._gtags)
        count_rows = (
            self._diff_positions(
                tuple(t[0] for t in self._prior_gtags),
                tuple(t[0] for t in self._gtags),
            )
            if delta.groups_shape_unchanged and self._prior_gtags is not None
            else None
        )
        tol_rows = self._diff_positions(self._prior_tkeys, self._tkeys)
        if self._gtags != self._prior_gtags:
            self.v_gcount += 1
            if not delta.groups_shape_unchanged:
                # shapes moved too: every G-side array restages
                self.v_groups += 1
        if self._ntags != self._prior_ntags:
            self.v_nodes += 1
        prior_tolsig = (
            tuple(t[3] for t in self._prior_gtags)
            if self._prior_gtags is not None
            else None
        )
        tolsig = tuple(t[3] for t in self._gtags)
        # topology batches ride the delta contract through their content
        # tags (topo_content_sigs): n_hcnt/nh_cnt0/g_dprior derive from
        # TopoSpec priors that the GROUP sigs now model fully, and the node
        # tags carry the hostname whenever topology is present — so the
        # cross arrays restage only when either side's content moved
        toposig = tuple(t[4] for t in self._gtags)
        prior_toposig = (
            tuple(t[4] for t in self._prior_gtags)
            if self._prior_gtags is not None
            else None
        )
        cross_changed = (
            toposig != prior_toposig
            or self._tkeys != self._prior_tkeys
            or self._ntags != self._prior_ntags
            or tolsig != prior_tolsig
            or (
                self._prior_gtags is not None
                and len(self._gtags) != len(self._prior_gtags)
            )
        )
        if cross_changed or self._prior_gtags is None:
            self.v_cross += 1
        # cross-row delta only when the group axis kept its shape,
        # toleration signature, AND topology signature: then a node x group
        # row changes only via its node's taints or node-content position
        cross_rows = None
        if (
            toposig == prior_toposig
            and tolsig == prior_tolsig
            and node_rows is not None
            and tol_rows is not None
        ):
            cross_rows = np.union1d(node_rows, tol_rows).astype(np.int32)
        had_prior = self._prior_snap is not None
        delta.full = not had_prior
        delta.node_rows = node_rows if had_prior else None
        delta.group_rows = group_rows if had_prior else None
        delta.count_rows = count_rows if had_prior else None
        delta.cross_rows = cross_rows if had_prior else None
        delta.delta_rows = int(
            (len(node_rows) if delta.node_rows is not None else 0)
            + (
                len(count_rows)
                if delta.count_rows is not None
                else (len(group_rows) if delta.group_rows is not None else 0)
            )
            + (len(cross_rows) if delta.cross_rows is not None else 0)
        )
        delta.v_static = self.v_static
        delta.v_groups = self.v_groups
        delta.v_gcount = self.v_gcount
        delta.v_nodes = self.v_nodes
        delta.v_cross = self.v_cross
        self._prior_snap = snap
        self._prior_gtags = self._gtags
        self._prior_ntags = self._ntags
        self._prior_tkeys = self._tkeys
        faults.hit(
            faults.ENCODE_DELTA, reused=False, rows=delta.delta_rows,
            owner=self.owner,
        )
        self._maybe_compact()
        return delta

    def _maybe_compact(self) -> None:
        """Periodic compaction: drop bank entries unused for two
        compaction windows of that bank's OWN use clock, so churn's
        one-off shapes don't accumulate — and a quiet cluster (whose
        encodes never consult a bank) can't age live entries out."""
        for bank, uses in (
            (self.node_bank, self._nuses),
            (self.group_bank, self._guses),
        ):
            if not uses or uses % self.compact_every:
                continue
            horizon = uses - 2 * self.compact_every
            stale = [k for k, (used, _) in bank.items() if used < horizon]
            for k in stale:
                del bank[k]


def _encode_groups(
    groups: List[PodGroup],
    vocab: Vocab,
    cluster: Optional[ClusterEncoding],
    resource_names: Sequence[str],
    K: int,
    V1: int,
    R: int,
    G: int,
):
    """The G-side arrays of one encode (split out of encode() so the
    delta path can skip it whole when the group tags are unchanged).
    ``cluster`` provides the cross-solve requirement-mask bank."""
    g_count = np.array([g.count for g in groups], dtype=np.int32)
    g_req = np.stack(
        [quantize_requests(g.requests, resource_names) for g in groups]
    ) if G else np.zeros((0, R), np.float32)
    g_def = np.zeros((G, K), bool)
    g_neg = np.zeros((G, K), bool)
    g_mask = np.ones((G, K, V1), bool)
    g_hcap = np.full((G,), HCAP_NONE, np.int32)
    g_haff = np.zeros((G,), bool)
    g_dmode = np.zeros((G,), np.int32)
    g_dkey = np.zeros((G,), np.int32)
    g_dskew = np.zeros((G,), np.int32)
    g_dmin0 = np.zeros((G,), bool)
    g_dprior = np.zeros((G, V1), np.int32)
    g_dreg = np.zeros((G, V1), bool)
    g_drank = np.full((G, V1), _DRANK_NONE, np.int32)
    # shared-constraint carry slots, assigned by descriptor identity
    g_hstg = np.full((G,), -1, np.int32)
    g_hscap = np.full((G,), HCAP_NONE, np.int32)
    g_dtg = np.full((G,), -1, np.int32)
    g_hself = np.ones((G,), bool)
    shared_h_descs: List[SharedHostTG] = []
    shared_d_descs: List[SharedDomainTG] = []
    _h_slots: Dict[int, int] = {}
    _d_slots: Dict[int, int] = {}

    def _h_slot(desc: SharedHostTG) -> int:
        j = _h_slots.setdefault(id(desc), len(_h_slots))
        if j == len(shared_h_descs):
            shared_h_descs.append(desc)
        return j

    def _d_slot(desc: SharedDomainTG) -> int:
        j = _d_slots.setdefault(id(desc), len(_d_slots))
        if j == len(shared_d_descs):
            shared_d_descs.append(desc)
        return j

    for i, g in enumerate(groups):
        t = g.topo
        if t is None:
            continue
        if t.shared_h is not None:
            g_hstg[i] = _h_slot(t.shared_h)
            g_hscap[i] = t.h_capval if t.h_capval is not None else t.shared_h.cap
            g_hself[i] = t.h_self
        if t.shared_d is not None:
            g_dtg[i] = _d_slot(t.shared_d)
        for desc in t.contrib_h:
            _h_slot(desc)
        for desc in t.contrib_d:
            _d_slot(desc)
    JH = max(len(shared_h_descs), 1)
    JD = max(len(_d_slots), 1)
    dd0 = np.zeros((JD, V1), np.int32)
    dtg_key = np.zeros((JD,), np.int32)
    for j, desc in enumerate(shared_d_descs):
        dtg_key[j] = 0 if desc.key == labels_mod.TOPOLOGY_ZONE else 1
    # contribution rows: slots this group's placements count toward (the
    # oracle's record() rule, scheduling/topology.py:491-498)
    g_hcontrib = np.zeros((G, JH), bool)
    g_dcontrib = np.zeros((G, JD), bool)
    for i, g in enumerate(groups):
        t = g.topo
        if t is None:
            continue
        for desc in t.contrib_h:
            g_hcontrib[i, _h_slots[id(desc)]] = True
        for desc in t.contrib_d:
            g_dcontrib[i, _d_slots[id(desc)]] = True
    for i, g in enumerate(groups):
        if cluster is not None:
            g_def[i], g_neg[i], g_mask[i] = cluster.group_rows(
                i, vocab, g.requirements, K, V1
            )
        else:
            g_def[i], g_neg[i], g_mask[i] = vocab.encode(g.requirements, K, V1)
        if g.topo is not None:
            if g.topo.host_cap is not None:
                g_hcap[i] = g.topo.host_cap
            g_haff[i] = g.topo.haff
            if g.topo.dmode != DMODE_NONE:
                t = g.topo
                g_dmode[i] = t.dmode
                g_dkey[i] = 0 if t.dkey == labels_mod.TOPOLOGY_ZONE else 1
                g_dskew[i] = min(t.dskew, HCAP_NONE)
                g_dmin0[i] = t.dmin0
                # rank = sorted-domain order, the oracle's tie-break and
                # bootstrap preference (topologygroup.go:291-324)
                for rank, d in enumerate(sorted(t.dreg)):
                    vid = vocab.value_id(t.dkey, d)
                    g_dreg[i, vid] = True
                    g_drank[i, vid] = rank
                    g_dprior[i, vid] = t.dprior.get(d, 0)
    return (
        g_count, g_req, g_def, g_neg, g_mask, g_hcap, g_haff,
        g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior, g_dreg, g_drank,
        g_hstg, g_hscap, g_dtg, g_hself, g_hcontrib, g_dcontrib,
        dd0, dtg_key, shared_h_descs, JH,
    )


def encode(
    groups: List[PodGroup],
    templates: List[NodeClaimTemplate],
    instance_types_by_pool: Dict[str, List[cp.InstanceType]],
    existing_nodes: Sequence = (),
    daemon_overhead: Optional[Dict] = None,
    pool_limits: Optional[Dict[str, res.ResourceList]] = None,
    vocab: Optional[Vocab] = None,
    cache: Optional[dict] = None,
    cluster: Optional[ClusterEncoding] = None,
) -> EncodedSnapshot:
    """Encode a snapshot. ``vocab``/``cache`` (both owned by one TpuSolver)
    let repeat solves skip the instance-type/template side: those arrays
    only depend on the vocab padding (K, V1) and the resource axis, both of
    which are part of the cache key — value ids assigned to NEW group values
    land inside the existing padding, where cached IN-masks are already
    False (non-matching) and complement masks already True (matching), so
    reuse is exact."""
    cache = cache if cache is not None else {}
    if vocab is None:
        vocab = Vocab()
    # pin the topology keys so ids are stable
    zone_kid = vocab.key_id(labels_mod.TOPOLOGY_ZONE)
    ct_kid = vocab.key_id(labels_mod.CAPACITY_TYPE_LABEL_KEY)

    # union of all instance types, stable order, deduped by name
    instance_types = cache.get("instance_types")
    if instance_types is None:
        seen = {}
        for its in instance_types_by_pool.values():
            for it in its:
                seen.setdefault(it.name, it)
        instance_types = cache["instance_types"] = list(seen.values())

    # Constraint-side entities register values; provider-side entities only
    # register keys and fall back to the overflow slot (see Vocab.observe) —
    # this keeps the value axis independent of the instance-type count.
    for g in groups:
        vocab.observe(g.requirements)
        if g.topo is not None and g.topo.dmode != DMODE_NONE:
            # domain-constraint universes must be interned before the
            # padded shape is fixed; sorted so value-id assignment (the
            # water-fill's deficit tie-break) is deterministic across
            # processes and matches the oracle's sorted-domain order
            for d in sorted(g.topo.dreg | set(g.topo.dprior)):
                vocab.value_id(g.topo.dkey, d)
    if not cache.get("static_observed"):
        for nct in templates:
            vocab.observe(nct.requirements)
        for it in instance_types:
            vocab.observe_keys(it.requirements)
            for o in it.offerings:
                # zone/capacity-type values are indexed by the offering tables
                z = o.requirements.get(labels_mod.TOPOLOGY_ZONE)
                c = o.requirements.get(labels_mod.CAPACITY_TYPE_LABEL_KEY)
                for v in z.values:
                    vocab.value_id(labels_mod.TOPOLOGY_ZONE, v)
                for v in c.values:
                    vocab.value_id(labels_mod.CAPACITY_TYPE_LABEL_KEY, v)
        for en in existing_nodes:
            # ExistingNode models (scheduling/inflight.py); their requirement
            # keys come from concrete node labels. Zone / capacity-type
            # values are interned so nodes index into the domain axis.
            vocab.observe_keys(en.requirements)
            _observe_node_domains(vocab, en)
        cache["static_observed"] = True
    else:
        for en in existing_nodes:
            vocab.observe_keys(en.requirements)
            _observe_node_domains(vocab, en)

    K, V1 = vocab.padded_shape()
    static_names = cache.get("static_names")
    if static_names is None:
        static_names = cache["static_names"] = res.resource_names(
            [it.capacity for it in instance_types]
            + ([daemon_overhead[nct] for nct in templates] if daemon_overhead else [])
        )
    extras = [
        n
        for n in res.resource_names([g.requests for g in groups])
        if n not in static_names
    ]
    resource_names = static_names + extras if extras else static_names
    R = len(resource_names)
    G, T, P, N = len(groups), len(instance_types), len(templates), len(existing_nodes)

    # content-shared node rows (see the existing-nodes section below) are
    # keyed on non-hostname label shapes; an interned hostname value (a pod
    # node-selector naming a node) disables sharing for this encode
    hn_kid = vocab.key_ids.get(labels_mod.HOSTNAME)
    hn_interned = bool(vocab.values[hn_kid]) if hn_kid is not None else False

    delta = None
    if cluster is not None:
        delta = cluster.begin(
            vocab, K, V1, resource_names, groups, existing_nodes,
            daemon_overhead, pool_limits, hn_interned,
        )
        if delta.reused:
            # content-hash fast path: nothing row-relevant changed since
            # the previous encode — prior arrays verbatim, fresh metadata
            return cluster.reused_snapshot(
                groups, templates, instance_types, existing_nodes
            )

    # -- groups -----------------------------------------------------------
    p_tol_reuse = None
    if delta is not None and delta.groups_shape_unchanged:
        # every group SHAPE tag (requests, requirement content,
        # tolerations, no-topology) matched the prior encode: the G-side
        # arrays are byte-identical by construction, so share them;
        # count-only churn (the steady-state reconcile shape) rebuilds
        # just the [G] count vector
        ps = cluster._prior_snap
        g_count = (
            ps.g_count
            if delta.groups_unchanged
            else np.array([g.count for g in groups], dtype=np.int32)
        )
        g_req = ps.g_req
        g_def, g_neg, g_mask = ps.g_def, ps.g_neg, ps.g_mask
        g_hcap, g_haff = ps.g_hcap, ps.g_haff
        g_dmode, g_dkey, g_dskew = ps.g_dmode, ps.g_dkey, ps.g_dskew
        g_dmin0, g_dprior, g_dreg = ps.g_dmin0, ps.g_dprior, ps.g_dreg
        g_drank = ps.g_drank
        g_hstg, g_hscap, g_dtg = ps.g_hstg, ps.g_hscap, ps.g_dtg
        g_hself = ps.g_hself
        g_hcontrib, g_dcontrib = ps.g_hcontrib, ps.g_dcontrib
        dd0, dtg_key = ps.dd0, ps.dtg_key
        shared_h_descs = []
        JH = g_hcontrib.shape[1]
        p_tol_reuse = ps.p_tol
    else:
        g_count, g_req, g_def, g_neg, g_mask, g_hcap, g_haff, \
            g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior, g_dreg, g_drank, \
            g_hstg, g_hscap, g_dtg, g_hself, g_hcontrib, g_dcontrib, \
            dd0, dtg_key, shared_h_descs, JH = _encode_groups(
                groups, vocab, cluster, resource_names, K, V1, R, G
            )

    # -- instance types + templates (static side, cached per padding) -----
    static_key = (K, V1, tuple(resource_names))
    static = cache.get(static_key)
    if static is None:
        t_alloc = np.stack(
            [quantize_capacity(it.allocatable(), resource_names) for it in instance_types]
        ) if T else np.zeros((0, R), np.float32)
        t_cap = np.stack(
            [quantize_capacity(it.capacity, resource_names) for it in instance_types]
        ) if T else np.zeros((0, R), np.float32)
        # synthetic volume-attach columns: fresh claims have no CSINode, so
        # their capacity is the no-limit sentinel (volumeusage.py: limits
        # only apply to existing nodes); node columns are filled per encode
        # below from the live attach ledger
        for ri, rn in enumerate(resource_names):
            if rn.startswith(VOL_RES_PREFIX):
                if T:
                    t_alloc[:, ri] = VOL_UNLIMITED
                    t_cap[:, ri] = VOL_UNLIMITED
        t_def = np.zeros((T, K), bool)
        t_mask = np.ones((T, K, V1), bool)
        for i, it in enumerate(instance_types):
            t_def[i], _, t_mask[i] = vocab.encode(it.requirements, K, V1)

        O = _next_pow2(max((len(it.offerings) for it in instance_types), default=1))
        o_avail = np.zeros((T, O), bool)
        o_zone = np.full((T, O), -1, np.int32)
        o_ct = np.full((T, O), -1, np.int32)
        o_price = np.full((T, O), np.inf, np.float32)
        t_price = np.full((T,), np.inf, np.float32)
        for i, it in enumerate(instance_types):
            for j, o in enumerate(it.offerings):
                o_avail[i, j] = o.available
                o_price[i, j] = o.price
                z = o.requirements.get(labels_mod.TOPOLOGY_ZONE)
                c = o.requirements.get(labels_mod.CAPACITY_TYPE_LABEL_KEY)
                if not z.complement and len(z.values) == 1:
                    o_zone[i, j] = vocab.value_id(
                        labels_mod.TOPOLOGY_ZONE, next(iter(z.values))
                    )
                if not c.complement and len(c.values) == 1:
                    o_ct[i, j] = vocab.value_id(
                        labels_mod.CAPACITY_TYPE_LABEL_KEY, next(iter(c.values))
                    )
                if o.available and o.price < t_price[i]:
                    t_price[i] = o.price

        p_def = np.zeros((P, K), bool)
        p_neg = np.zeros((P, K), bool)
        p_mask = np.ones((P, K, V1), bool)
        p_daemon = np.zeros((P, R), np.float32)
        p_limit = np.full((P, R), np.inf, np.float32)
        p_has_limit = np.zeros((P,), bool)
        p_titype_ok = np.zeros((P, T), bool)
        type_index = {it.name: i for i, it in enumerate(instance_types)}
        for i, nct in enumerate(templates):
            p_def[i], p_neg[i], p_mask[i] = vocab.encode(nct.requirements, K, V1)
            if daemon_overhead and nct in daemon_overhead:
                p_daemon[i] = quantize_requests(daemon_overhead[nct], resource_names)
            limits = (pool_limits or {}).get(nct.node_pool_name)
            if limits:
                p_has_limit[i] = True
                # remaining-limit accounting is in capacity units (floor)
                for ri, rn in enumerate(resource_names):
                    if rn in limits:
                        p_limit[i, ri] = limits[rn] // _unit_divisor(rn)
            for it in nct.instance_type_options:
                p_titype_ok[i, type_index[it.name]] = True

        # dense minValues tables: distinct-value counting over
        # the per-key catalog value universe replaces the host-side
        # serialization the driver used to force for reachable minValues
        # pools. Values get their own per-key index (NOT the shared vocab:
        # provider-side values land in the overflow slot there, which
        # cannot count distinct values).
        mv_keys = sorted(
            {
                r.key
                for nct in templates
                for r in nct.requirements
                if r.min_values is not None
            }
        )
        MV = len(mv_keys)
        mv_vals: List[Dict[str, int]] = []
        for key in mv_keys:
            vals: Dict[str, int] = {}
            for it in instance_types:
                for v in sorted(it.requirements.get(key).values_list()):
                    vals.setdefault(v, len(vals))
            mv_vals.append(vals)
        W = _next_pow2(max((len(v) for v in mv_vals), default=1), floor=1)
        p_mvmin = np.zeros((P, max(MV, 0)), np.int32)
        t_mvoh = np.zeros((T, max(MV, 0), W), bool)
        for j, key in enumerate(mv_keys):
            for i, nct in enumerate(templates):
                r = (
                    nct.requirements.get(key)
                    if nct.requirements.has(key)
                    else None
                )
                if r is not None and r.min_values is not None:
                    p_mvmin[i, j] = r.min_values
            for t, it in enumerate(instance_types):
                for v in it.requirements.get(key).values_list():
                    t_mvoh[t, j, mv_vals[j][v]] = True

        static = cache[static_key] = (
            t_alloc, t_cap, t_def, t_mask, t_price,
            o_avail, o_zone, o_ct, o_price,
            p_def, p_neg, p_mask, p_daemon, p_limit, p_has_limit, p_titype_ok,
            p_mvmin, t_mvoh,
        )
    (t_alloc, t_cap, t_def, t_mask, t_price,
     o_avail, o_zone, o_ct, o_price,
     p_def, p_neg, p_mask, p_daemon, p_limit, p_has_limit, p_titype_ok,
     p_mvmin, t_mvoh) = static

    # -- template/group tolerance (depends on this solve's groups) --------
    if p_tol_reuse is not None:
        p_tol = p_tol_reuse
    else:
        p_tol = np.zeros((P, max(G, 1)), bool)
        for i, nct in enumerate(templates):
            for gi, g in enumerate(groups):
                p_tol[i, gi] = (
                    taints_mod.tolerates(nct.taints, g.pods[0].spec.tolerations)
                    is None
                )

    # -- existing nodes ---------------------------------------------------
    n_avail = np.zeros((N, R), np.float32)
    n_base = np.zeros((N, R), np.float32)
    n_def = np.zeros((N, K), bool)
    n_mask = np.ones((N, K, V1), bool)
    n_tol = np.zeros((N, max(G, 1)), bool)
    n_hcnt = np.zeros((N, max(G, 1)), np.int32)
    n_dzone = np.full((N,), -1, np.int32)
    n_dct = np.full((N,), -1, np.int32)
    nh_cnt0 = np.zeros((N, JH), np.int32)
    existing_names = []
    # content-shared node rows: fleets are homogeneous (a 2k-node cluster
    # snapshot typically carries a handful of distinct label shapes), so
    # the mask rows are computed once per distinct requirement content and
    # copied per node. The hostname requirement is excluded from the key:
    # hostname values are provider-side and encode to the OVERFLOW slot,
    # identical across nodes — UNLESS some hostname value has been interned
    # (a pod node-selector naming a node), which disables sharing for this
    # encode (hn_interned was derived above, before the delta fast path).
    # Caches are per-call: the vocab is stable here (all observation
    # happened above); cross-call reuse is the _enc_rows stash's job —
    # or the ClusterEncoding banks' when a ``cluster`` is leased.
    row_cache: Dict[tuple, tuple] = {}
    tol_cache: Dict[tuple, np.ndarray] = {}
    # groups with hostname-topology priors, walked per node; everything
    # else in the per-node group loop is the tolerance row (cached by
    # taint content below)
    topo_gis = [
        gi
        for gi, g in enumerate(groups)
        if g.topo is not None and (g.topo.host_counts or g.topo.haff_prior)
    ]
    # synthetic volume-attach columns (node side): remaining CSINode attach
    # slots per driver. Overwritten AFTER any cached-row retrieval — the
    # per-node row stashes/banks key on capacity+requests content, not the
    # volume ledger, so the columns are recomputed per encode (cheap) and
    # staleness is impossible.
    vol_cols = [
        (ri, rn[len(VOL_RES_PREFIX):])
        for ri, rn in enumerate(resource_names)
        if rn.startswith(VOL_RES_PREFIX)
    ]
    for i, en in enumerate(existing_nodes):
        # `en` is a scheduling.inflight.ExistingNode (carries the remaining
        # daemon requests and cached availability)
        existing_names.append(en.name)
        # per-node rows stash on the StateNode snapshot object:
        # consolidation's binary search re-encodes the SAME frozen snapshot
        # nodes once per probe, and these per-node Python/vocab walks
        # dominated the probe's encode. Safe because cluster.nodes() hands
        # each solve fresh deep copies (stale stashes die with their
        # snapshot), node label requirements are positive-only (rows are
        # stable under vocab growth at fixed K/V1), and the tag pins the
        # vocab instance, array shapes, and the daemon remainder.
        if cluster is not None and cluster._banks_on:
            # delta path: quantized rows are recomputed (cheap, and their
            # content is part of the node tag), the mask rows ride the
            # cross-solve content bank
            n_avail[i] = quantize_capacity(en.cached_available, resource_names)
            n_base[i] = quantize_requests(en.requests, resource_names)

            def _mask_rows(en=en):
                ndef, _, nmask = vocab.encode(en.requirements, K, V1)
                return (
                    ndef, nmask,
                    _node_domain_id(vocab, en, labels_mod.TOPOLOGY_ZONE),
                    _node_domain_id(
                        vocab, en, labels_mod.CAPACITY_TYPE_LABEL_KEY
                    ),
                )

            (n_def[i], n_mask[i], n_dzone[i],
             n_dct[i]) = cluster.node_mask_rows(i, _mask_rows)
            sn = None
            cached = tag = None
        else:
            sn = getattr(en, "state_node", None)
            tag = (
                vocab.serial, K, V1, tuple(resource_names),
                tuple(sorted(en.requests.items())),
            )
            cached = getattr(sn, "_enc_rows", None) if sn is not None else None
        if cached is not None and cached[0] == tag:
            (n_avail[i], n_base[i], n_def[i], n_mask[i], n_dzone[i],
             n_dct[i]) = cached[1]
        elif tag is not None:
            n_avail[i] = quantize_capacity(en.cached_available, resource_names)
            n_base[i] = quantize_requests(en.requests, resource_names)
            ck = None
            rows = None
            if not hn_interned:
                ck = tuple(
                    sorted(
                        (
                            r.key, r.complement, tuple(sorted(r.values)),
                            r.greater_than, r.less_than,
                        )
                        for r in en.requirements
                        if r.key != labels_mod.HOSTNAME
                    )
                ) + (en.requirements.has(labels_mod.HOSTNAME),)
                rows = row_cache.get(ck)
            if rows is None:
                n_def[i], _, n_mask[i] = vocab.encode(en.requirements, K, V1)
                n_dzone[i] = _node_domain_id(
                    vocab, en, labels_mod.TOPOLOGY_ZONE
                )
                n_dct[i] = _node_domain_id(
                    vocab, en, labels_mod.CAPACITY_TYPE_LABEL_KEY
                )
                if ck is not None:
                    row_cache[ck] = (
                        n_def[i].copy(), n_mask[i].copy(),
                        n_dzone[i], n_dct[i],
                    )
            else:
                n_def[i], n_mask[i], n_dzone[i], n_dct[i] = rows
            if sn is not None:
                sn._enc_rows = (
                    tag,
                    (n_avail[i].copy(), n_base[i].copy(), n_def[i].copy(),
                     n_mask[i].copy(), n_dzone[i], n_dct[i]),
                )
        for ri, drv in vol_cols:
            vu = getattr(en, "volume_usage", None)
            limit = (getattr(en, "volume_limits", None) or {}).get(drv)
            if limit is None:
                n_avail[i, ri] = VOL_UNLIMITED
            else:
                used = vu.attached_count(drv) if vu is not None else 0
                n_avail[i, ri] = max(limit - used, 0)
            n_base[i, ri] = 0.0
        if shared_h_descs:
            hostname = (
                en.state_node.hostname() if hasattr(en, "state_node") else en.name
            )
            for j, desc in enumerate(shared_h_descs):
                nh_cnt0[i, j] = desc.counts.get(hostname, 0)
        if G:

            def _trow(en=en):
                return np.fromiter(
                    (
                        taints_mod.tolerates(
                            en.cached_taints, g.pods[0].spec.tolerations
                        )
                        is None
                        for g in groups
                    ),
                    bool,
                    G,
                )

            if cluster is not None:
                # cross-solve tolerance bank, keyed by taint content under
                # the current group-toleration epoch (begin() cleared it
                # if the group axis changed)
                n_tol[i, :G] = cluster.tol_row(i, _trow)
            else:
                tkey = tuple(
                    (t.key, t.value, t.effect) for t in en.cached_taints
                )
                trow = tol_cache.get(tkey)
                if trow is None:
                    trow = _trow()
                    tol_cache[tkey] = trow
                n_tol[i, :G] = trow
        for gi in topo_gis:
            g = groups[gi]
            # hostname domains are the node's hostname label (node name
            # as fallback), mirroring Topology._count_domains. For haff
            # groups the row holds the affinity matching-pod priors
            # (the cap/affinity combo is demoted, so no overlap).
            domain = (
                en.state_node.hostname()
                if hasattr(en, "state_node")
                else en.name
            )
            n_hcnt[i, gi] = (
                g.topo.haff_prior.get(domain, 0)
                if g.topo.haff
                else g.topo.host_counts.get(domain, 0)
            )

    if p_tol_reuse is not None and cluster is not None:
        # group shapes unchanged: the index is a pure function of the
        # reused g_def/g_neg/g_mask rows, so the prior arrays are exact
        ps = cluster._prior_snap
        gk_g, gk_k, gk_w, goff_idx = ps.gk_g, ps.gk_k, ps.gk_w, ps.goff_idx
    else:
        gk_g, gk_k, gk_w, goff_idx = build_segment_index(
            g_def, g_neg, g_mask, zone_kid, ct_kid
        )

    snap = EncodedSnapshot(
        vocab=vocab,
        resource_names=resource_names,
        groups=groups,
        templates=templates,
        instance_types=instance_types,
        existing_names=existing_names,
        g_count=g_count,
        g_req=g_req,
        g_def=g_def,
        g_neg=g_neg,
        g_mask=g_mask,
        g_hcap=g_hcap,
        g_haff=g_haff,
        n_hcnt=n_hcnt,
        g_dmode=g_dmode,
        g_dkey=g_dkey,
        g_dskew=g_dskew,
        g_dmin0=g_dmin0,
        g_dprior=g_dprior,
        g_dreg=g_dreg,
        g_drank=g_drank,
        n_dzone=n_dzone,
        n_dct=n_dct,
        g_hstg=g_hstg,
        g_hscap=g_hscap,
        g_dtg=g_dtg,
        g_hself=g_hself,
        g_hcontrib=g_hcontrib,
        g_dcontrib=g_dcontrib,
        nh_cnt0=nh_cnt0,
        dd0=dd0,
        dtg_key=dtg_key,
        t_alloc=t_alloc,
        t_cap=t_cap,
        t_def=t_def,
        t_mask=t_mask,
        t_price=t_price,
        o_avail=o_avail,
        o_zone=o_zone,
        o_ct=o_ct,
        o_price=o_price,
        p_def=p_def,
        p_neg=p_neg,
        p_mask=p_mask,
        p_daemon=p_daemon,
        p_limit=p_limit,
        p_has_limit=p_has_limit,
        p_titype_ok=p_titype_ok,
        p_tol=p_tol,
        p_mvmin=p_mvmin,
        t_mvoh=t_mvoh,
        n_avail=n_avail,
        n_base=n_base,
        n_def=n_def,
        n_mask=n_mask,
        n_tol=n_tol,
        zone_kid=zone_kid,
        ct_kid=ct_kid,
        well_known=vocab.well_known_mask(K),
        gk_g=gk_g,
        gk_k=gk_k,
        gk_w=gk_w,
        goff_idx=goff_idx,
    )
    if cluster is not None:
        cluster.finish(snap)
    return snap


def class_partition(snap: "EncodedSnapshot", min_mean_size: float = 0.0):
    """Partition the (FFD-sorted, possibly padded) group axis into
    contiguous feasibility classes for ops/packing.py:pack_classed.

    With ``min_mean_size`` > 0 (the driver's auto-routing threshold), the
    partition bails out with None right after the vectorized signature
    pass when even the signature-run count proves the mean class size
    below the threshold — dkey splits and padding-class exclusion only
    INCREASE the class count, so this is a safe upper bound, and the
    rejected shapes (every group its own class, e.g. consolidation
    probes) skip the per-run Python walk entirely.

    Two adjacent groups share a class when every class-invariant input the
    kernel's head tables derive from is identical: requests (g_req),
    requirement masks (g_def/g_neg/g_mask), template tolerations (p_tol
    column), and node tolerations (n_tol column). A run additionally
    breaks when its dynamic (domain-keyed) members would mix axes — the
    head's per-domain tables are built for ONE axis per class.

    Returns (class_start, class_len, class_dyn, class_dkey, inv_idx, lmax)
    as numpy arrays / int, with the class axis padded to a power of two and
    lmax the power-of-two member-capacity bucket. Classes whose members
    are all count-0 padding get len 0 (the kernel skips them whole).
    """
    G = len(snap.g_count)
    # vectorized adjacent-equality over every class-invariant input: this
    # runs on the solve hot path for EVERY routed batch (including ones
    # the heuristic then sends to pack()), so no per-group Python loop
    same = np.zeros((G,), bool)
    if G > 1:
        same[1:] = (
            (snap.g_req[1:] == snap.g_req[:-1]).all(axis=1)
            & (snap.g_def[1:] == snap.g_def[:-1]).all(axis=1)
            & (snap.g_neg[1:] == snap.g_neg[:-1]).all(axis=1)
            & (snap.g_mask[1:] == snap.g_mask[:-1]).all(axis=(1, 2))
            & (snap.p_tol[:, 1:] == snap.p_tol[:, :-1]).all(axis=0)
        )
        if snap.n_tol.size:
            same[1:] &= (snap.n_tol[:, 1:] == snap.n_tol[:, :-1]).all(axis=0)
    sig_starts = np.flatnonzero(~same)
    if min_mean_size > 0:
        n_real_groups = len(snap.groups)
        if (
            not len(sig_starts)
            or n_real_groups / len(sig_starts) < min_mean_size
        ):
            return None
    dyn_g = np.asarray(snap.g_dmode) > 0
    dk_g = np.where(dyn_g, np.asarray(snap.g_dkey), -1)
    starts: List[int] = []
    lens: List[int] = []
    dyns: List[bool] = []
    dkeys: List[int] = []
    for ri, s in enumerate(sig_starts):
        e = sig_starts[ri + 1] if ri + 1 < len(sig_starts) else G
        # split the run wherever a dynamic member's axis conflicts with
        # the run's current one (the head's per-domain tables serve a
        # single axis per class); conflicts are rare, so the split walk
        # touches only the offending runs
        while s < e:
            dk_run = dk_g[s:e]
            dyn_idx = np.flatnonzero(dk_run >= 0)
            if dyn_idx.size:
                first_dk = dk_run[dyn_idx[0]]
                conflicts = dyn_idx[dk_run[dyn_idx] != first_dk]
                cut = int(conflicts[0]) if conflicts.size else e - s
            else:
                first_dk = -1
                cut = e - s
            starts.append(int(s))
            lens.append(int(cut))
            dyns.append(bool(dyn_idx.size and dyn_idx[0] < cut))
            dkeys.append(int(first_dk))
            s += cut
    # classes of pure padding (all counts 0) are skipped whole; their
    # original spans still map groups for inv_idx below
    spans = list(lens)
    for ci in range(len(starts)):
        s, l = starts[ci], lens[ci]
        if not snap.g_count[s : s + l].any():
            lens[ci] = 0
    n_real = len(starts)
    lmax = _next_pow2(max(lens) if lens else 1, floor=1)
    C = _next_pow2(n_real, floor=1)
    class_start = np.zeros((C,), np.int32)
    class_len = np.zeros((C,), np.int32)
    class_dyn = np.zeros((C,), bool)
    class_dkey = np.zeros((C,), np.int32)
    class_start[:n_real] = starts
    class_len[:n_real] = lens
    class_dyn[:n_real] = dyns
    class_dkey[:n_real] = np.maximum(dkeys, 0)
    # group gi of class ci at member offset j reads buffer row ci*lmax + j;
    # len-0 (padding) classes point at their cond-skipped zero rows, which
    # is correct for count-0 groups
    spans_arr = np.asarray(spans, np.int64)
    ci_of_g = np.repeat(np.arange(n_real, dtype=np.int64), spans_arr)
    j_of_g = np.arange(G, dtype=np.int64) - np.repeat(
        np.asarray(starts, np.int64), spans_arr
    )
    inv_idx = (ci_of_g * lmax + np.minimum(j_of_g, lmax - 1)).astype(np.int32)
    return class_start, class_len, class_dyn, class_dkey, inv_idx, lmax


def build_groups(pods: Sequence[Pod]) -> List[PodGroup]:
    """Group tensorizable pods into equivalence classes, FFD-ordered."""
    groups, rest = partition_and_group(pods)
    assert not rest, "build_groups expects pre-filtered tensorizable pods"
    return groups


def ffd_sort_key(g: "PodGroup"):
    """FFD pack-order key over groups: cpu desc, then memory desc
    (queue.go:76-112). The kernel scan processes groups in this order, and
    the shared-constraint admission guard in _resolve_topology reasons about
    pack order with this same key — keep them identical."""
    return (
        -g.requests.get(res.CPU, 0),
        -g.requests.get(res.MEMORY, 0),
    )


def partition_and_group(
    pods: Sequence[Pod],
    topology=None,
    merge_bootstrap_affinity: bool = True,
    volume_shapes: Optional[Dict[str, tuple]] = None,
) -> Tuple[List[PodGroup], List[Pod]]:
    """One pass over the batch: route non-tensorizable pods to the host
    oracle and group the rest into equivalence classes, FFD-ordered
    (queue.go:76-112). Fused because both checks walk the same 50k specs.

    With a ``topology`` (scheduling.topology.Topology, already updated with
    every pending pod), pods whose topology constraints the kernel models
    are admitted too, then re-checked globally:

    - a constraint's selector must match only its own group's pending pods
      (self-selecting) or none at all — cross-group selection serializes
      through the oracle;
    - any oracle-routed pod whose topology selectors match a tensorized
      group demotes that group (the oracle cannot see TPU placements);
    - inverse anti-affinity from already-bound cluster pods demotes the
      groups it selects (their placements are gated node-by-node).
    """
    by_key: Dict[tuple, PodGroup] = {}
    rest: List[Pod] = []
    allow_topo = topology is not None
    # label keys referenced by any pending forward constraint's selector:
    # constraint-FREE pods must additionally group on (namespace, these
    # labels) so selector matching — and hence the contributor role in the
    # shared-constraint carries — is uniform per group. Empty for
    # constraint-free batches, preserving the hot-path key shape.
    sel_keys = None
    if allow_topo and topology.topology_groups:
        keys = set()
        for tg in topology.topology_groups.values():
            sel = tg.selector
            if sel is None:
                continue
            keys.update(sel.match_labels)
            keys.update(e.key for e in sel.match_expressions)
        if keys:
            sel_keys = frozenset(keys)
    # fused per-pod check + key build: this loop walks every spec in a 50k
    # batch, so the common no-constraint shape takes one attribute sweep
    # (is_tensorizable + group_key stay the semantic reference and serve
    # the uncommon shapes)
    rest_append = rest.append
    get_group = by_key.get
    # routing verdicts memoize on the pod object, validated against the
    # store's resource_version (client.update bumps it, invalidating the
    # entry): the provisioner re-walks long-pending pods every batch and
    # consolidation's binary search re-walks the same reschedulable pods
    # once per probe. Oracle-side relaxation mutates pods WITHOUT a store
    # update, but only ever pods already cached non-tensorizable — a stale
    # verdict there keeps them oracle-routed (slower, never wrong).
    gk_attr = "_gk_cache" if allow_topo else "_gk_cache_nt"
    for pod in pods:
        if pod.spec.volumes:
            # volume routing is BATCH-dependent (cross-pod volume sharing
            # and already-attached volumes break the dense ledger), so the
            # verdict comes from the driver's per-solve resolution map and
            # is never memoized on the pod
            spec0 = pod.spec
            vs = volume_shapes.get(pod.uid) if volume_shapes else None
            if vs is None or not is_tensorizable(
                pod, allow_topology=allow_topo, allow_volumes=True
            ):
                rest_append(pod)
                continue
            key = group_key(pod) + ("__vol__", vs[0])
            if sel_keys and not (
                spec0.topology_spread_constraints
                or spec0.pod_anti_affinity
                or spec0.pod_affinity
            ):
                key = key + _sel_signature(pod, sel_keys)
            g = get_group(key)
            if g is None:
                req = dict(spec0.requests)
                for rn, rv in vs[1].items():
                    req[rn] = req.get(rn, 0) + rv
                by_key[key] = PodGroup([pod], pod_requirements(pod), req)
            else:
                g.pods.append(pod)
            continue
        cached = getattr(pod, gk_attr, None)
        key = None
        if (
            cached is not None
            and cached[0] == pod.metadata.resource_version
            and cached[1] == sel_keys
        ):
            key = cached[2]
            if key == _NOT_TENSORIZABLE:
                rest_append(pod)
                continue
        if key is None:
            spec = pod.spec
            affinity = spec.node_affinity
            if (
                spec.topology_spread_constraints
                or spec.pod_anti_affinity
                or spec.pod_affinity
                or spec.preferred_pod_affinity
                or spec.preferred_pod_anti_affinity
                or spec.host_ports
                or spec.volumes
            ):
                if not is_tensorizable(pod, allow_topology=allow_topo):
                    object.__setattr__(
                        pod, gk_attr,
                        (pod.metadata.resource_version, sel_keys,
                         _NOT_TENSORIZABLE),
                    )
                    rest_append(pod)
                    continue
                key = group_key(pod)
            elif affinity is not None:
                if not is_tensorizable(pod, allow_topology=allow_topo):
                    object.__setattr__(
                        pod, gk_attr,
                        (pod.metadata.resource_version, sel_keys,
                         _NOT_TENSORIZABLE),
                    )
                    rest_append(pod)
                    continue
                key = group_key(pod)
                if sel_keys:
                    key = key + _sel_signature(pod, sel_keys)
            else:
                # constraint-free fast shape: selector/tolerations only
                sel = spec.node_selector
                tol = spec.tolerations
                key = (
                    frozenset(spec.requests.items()),
                    frozenset(sel.items()) if sel else (),
                    (),
                    frozenset(
                        (t.key, t.operator, t.value, t.effect) for t in tol
                    ) if tol else (),
                )
                if sel_keys:
                    key = key + _sel_signature(pod, sel_keys)
            object.__setattr__(
                pod, gk_attr, (pod.metadata.resource_version, sel_keys, key)
            )
        g = get_group(key)
        if g is None:
            by_key[key] = PodGroup(
                [pod], pod_requirements(pod), dict(pod.spec.requests)
            )
        else:
            g.pods.append(pod)
    groups = list(by_key.values())
    if allow_topo and (topology.topology_groups or topology.inverse_topology_groups):
        # Constraint-free batches skip the cross-group resolution entirely:
        # an empty forward-group map means no pending pod owns a topology
        # constraint (Topology.update registered every pending pod before
        # this call), and an empty inverse map means no bound pod's
        # anti-affinity can gate placements — so there is nothing to demote
        # and no TopoSpec to build.
        groups, demoted = _resolve_topology(
            groups, rest, topology,
            merge_bootstrap_affinity=merge_bootstrap_affinity,
        )
        rest.extend(demoted)
    # FFD order over groups: cpu desc, then memory desc (queue.go:76-112)
    groups.sort(key=ffd_sort_key)
    return groups, rest


def _pod_constraint_selectors(pod: Pod):
    """(namespaces, selector) for every topology constraint on the pod,
    including preferred terms (they own TopologyGroups too)."""
    spec = pod.spec
    ns = pod.metadata.namespace
    for tsc in spec.topology_spread_constraints:
        yield {ns}, tsc.label_selector
    terms = list(spec.pod_affinity) + list(spec.pod_anti_affinity)
    terms += [wt.term for wt in spec.preferred_pod_affinity]
    terms += [wt.term for wt in spec.preferred_pod_anti_affinity]
    for term in terms:
        yield (set(term.namespaces) if term.namespaces else {ns}), term.label_selector


def _resolve_topology(
    groups: List[PodGroup], rest: List[Pod], topology,
    merge_bootstrap_affinity: bool = True,
) -> Tuple[List[PodGroup], List[Pod]]:
    """Global cross-group checks + TopoSpec construction (see
    partition_and_group docstring). Returns (kept groups, demoted pods)."""
    # constraints folded STATICALLY into group requirements this pass
    # (gates, affinity-with-priors): recorded on the topology so the
    # scenario-batched axis can decline when a candidate node's bound pods
    # would move counts a static fold already baked in
    topology.kernel_static_folds = []
    # distinct (namespace, labels) -> owning group indices (-1 = oracle side)
    _empty = frozenset()
    label_owners: Dict[tuple, set] = {}

    def _owner_key(p: Pod) -> tuple:
        labels = p.metadata.labels
        return (
            p.metadata.namespace,
            frozenset(labels.items()) if labels else _empty,
        )

    for gi, g in enumerate(groups):
        for p in g.pods:
            label_owners.setdefault(_owner_key(p), set()).add(gi)
    for p in rest:
        label_owners.setdefault(_owner_key(p), set()).add(-1)

    def matched_owners(namespaces: set, selector) -> set:
        out: set = set()
        if selector is None:
            return out  # nil selector selects nothing (labels.Nothing())
        for (ns, labels_fs), owners in label_owners.items():
            if ns in namespaces and selector.matches(dict(labels_fs)):
                out |= owners
        return out

    demote: set = set()

    # oracle-routed pods' constraints demote any tensorized group they
    # select: the oracle cannot see TPU placements. Demotion is transitive —
    # a demoted group's own constraints become oracle-side too — so iterate
    # to a fixpoint.
    seen_sigs = set()

    def demote_by_selectors(pod: Pod) -> None:
        for namespaces, selector in _pod_constraint_selectors(pod):
            sig = (frozenset(namespaces), selector.key() if selector else None)
            if sig in seen_sigs:
                continue
            seen_sigs.add(sig)
            demote.update(
                gi for gi in matched_owners(namespaces, selector) if gi >= 0
            )

    for p in rest:
        demote_by_selectors(p)

    # inverse anti-affinity owned by anyone outside the tensorized groups
    # (bound cluster pods, or pending pods already oracle-routed) gates
    # placements node-by-node in the oracle — demote every group it selects,
    # including constraint-free ones (their labels may match the selector).
    group_uids = [{p.uid for p in g.pods} for g in groups]
    all_uids = set().union(*group_uids) if group_uids else set()
    for tg in topology.inverse_topology_groups.values():
        if tg.owners - all_uids:
            demote.update(
                gi
                for gi in matched_owners(tg.namespaces, tg.selector)
                if gi >= 0
            )

    uid2gi: Dict[str, int] = {}
    for gi, uids in enumerate(group_uids):
        for uid in uids:
            uid2gi[uid] = gi
    # tg identity -> tg: constraints whose owners span groups (or select
    # beyond their own group) resolve in a second pass (shared carries)
    shared_pending: Dict[int, object] = {}
    group_specs: Dict[int, TopoSpec] = {}

    for gi, g in enumerate(groups):
        if gi in demote:
            continue
        rep = g.pods[0]
        if not (
            rep.spec.topology_spread_constraints
            or rep.spec.pod_anti_affinity
            or rep.spec.pod_affinity
        ):
            continue
        uids = group_uids[gi]
        owned = list(topology.owned_topologies(rep.uid))
        constraints = []  # (cap, counts) per hostname constraint
        spec = TopoSpec()
        group_specs[gi] = spec
        for tg in owned:
            # a TopologyGroup shared across groups (or selecting beyond its
            # own group) is deferred to the shared-constraint pass
            matched = matched_owners(tg.namespaces, tg.selector)
            if not tg.owners <= uids or matched - {gi}:
                shared_pending.setdefault(id(tg), tg)
                continue
            self_sel = tg.selects(rep)
            if tg.key == labels_mod.HOSTNAME:
                if tg.type is TopologyType.POD_AFFINITY:
                    # hostname co-location: the whole group pins to ONE
                    # entity (topologygroup.go:277-324 hostname case).
                    # Admit the self-selecting group-private shape; gate
                    # affinity (owner not selected — its candidates never
                    # grow) stays host-side, as does a second hostname
                    # affinity on the same group.
                    if not self_sel or spec.haff:
                        demote.add(gi)
                        break
                    prior = {d: c for d, c in tg.domains.items() if c > 0}
                    if prior:
                        # prior counts come from cluster pods, but the
                        # kernel's candidate rows are the solve's state
                        # nodes — a prior on a node outside the snapshot
                        # (cordoned/deleting) would silently degrade to
                        # the bootstrap; the oracle pins candidates to the
                        # prior node, so demote instead
                        known = set()
                        for sn in getattr(topology, "_state_nodes", ()):
                            hn = (
                                sn.hostname()
                                if hasattr(sn, "hostname")
                                else getattr(sn, "name", None)
                            )
                            if hn:
                                known.add(hn)
                        if not set(prior) <= known:
                            demote.add(gi)
                            break
                    spec.haff = True
                    spec.haff_prior = prior
                    continue
                if self_sel:
                    # self-selecting: the skew bound is a per-entity cap of
                    # maxSkew (anti: 1) minus pods already counted on the node
                    cap = (
                        tg.max_skew
                        if tg.type is TopologyType.SPREAD
                        else 1  # anti-affinity: only empty domains accept
                    )
                    constraints.append(
                        (cap, {d: c for d, c in tg.domains.items() if c > 0})
                    )
                    spec.src_h.append(tg)
                else:
                    # non-self-selecting: placements never change the counts,
                    # so the constraint is a binary per-node gate — blocked
                    # when the prior already exceeds the allowance (spread:
                    # > maxSkew, anti: > 0), unlimited otherwise. Encoded as
                    # an infinite effective prior on blocked nodes under an
                    # infinite cap.
                    threshold = (
                        tg.max_skew if tg.type is TopologyType.SPREAD else 0
                    )
                    constraints.append(
                        (
                            HCAP_NONE,
                            {
                                d: HCAP_NONE
                                for d, c in tg.domains.items()
                                if c > threshold
                            },
                        )
                    )
            elif (
                tg.key in DOMAIN_KEYS
                and tg.type is not TopologyType.POD_ANTI_AFFINITY
            ):
                # pod-admissible universe: the min (and every selection)
                # ranges over registered domains the pod itself admits
                # (topologygroup.go:231-251: candidate ∈ self.domains,
                # min over pod_domains)
                pod_dom = (
                    g.requirements.get(tg.key)
                    if g.requirements.has(tg.key)
                    else Requirement(tg.key, Operator.EXISTS)
                )
                counts = {
                    d: c for d, c in tg.domains.items() if pod_dom.has(d)
                }
                if tg.type is TopologyType.SPREAD:
                    min0 = (
                        tg.min_domains is not None
                        and len(counts) < tg.min_domains
                    )
                    m = (
                        0
                        if min0
                        else (min(counts.values()) if counts else MAX_SKEW_UNBOUNDED)
                    )
                    if self_sel:
                        if spec.dmode != DMODE_NONE:
                            demote.add(gi)  # one dynamic constraint per group
                            break
                        spec.dmode = DMODE_SPREAD
                        spec.dkey = tg.key
                        spec.dskew = tg.max_skew
                        spec.dmin0 = min0
                        spec.dprior = counts
                        spec.dreg = frozenset(counts)
                        spec.src_d = tg
                    else:
                        # static gate: placements never move the counts, so
                        # admissible domains are exactly those within skew
                        # today — intersect them into the group requirement
                        # (the oracle adds the same IN set per placement,
                        # topology.go:220-242)
                        allowed = [
                            d for d, c in counts.items() if c - m <= tg.max_skew
                        ]
                        g.requirements.add(
                            Requirement(tg.key, Operator.IN, allowed)
                        )
                        topology.kernel_static_folds.append(tg)
                else:  # POD_AFFINITY on zone / capacity-type
                    nonempty = [d for d, c in counts.items() if c > 0]
                    if nonempty:
                        # compatible pods already placed: a static
                        # nonempty-domain gate (topologygroup.go:277-290)
                        g.requirements.add(
                            Requirement(tg.key, Operator.IN, nonempty)
                        )
                        topology.kernel_static_folds.append(tg)
                    elif self_sel:
                        if spec.dmode != DMODE_NONE:
                            demote.add(gi)
                            break
                        # bootstrap: the whole group pins to one viable
                        # domain (topologygroup.go:291-324)
                        spec.dmode = DMODE_AFFINITY
                        spec.dkey = tg.key
                        spec.dprior = counts
                        spec.dreg = frozenset(counts)
                        spec.src_d = tg
                    else:
                        # no compatible placed pods and no bootstrap right:
                        # unsatisfiable (the oracle returns DoesNotExist)
                        g.requirements.add(
                            Requirement(tg.key, Operator.IN, [])
                        )
                        topology.kernel_static_folds.append(tg)
            else:
                # zone/ct anti-affinity and custom topology keys serialize
                # through the host oracle
                demote.add(gi)
                break
        if gi in demote:
            continue
        # fold hostname constraints: fresh-entity cap = min cap_i; a node's
        # residual is min_i (cap_i - prior_i), stored back as an effective
        # prior so the kernel's single (cap - prior) recovers it
        if spec.haff and (constraints or spec.dmode != DMODE_NONE):
            # the single-entity pin composing with hostname caps or a
            # domain-dynamic constraint shares kernel state (n_hcnt rows /
            # quota machinery) — serialize the combo through the oracle
            demote.add(gi)
            continue
        if constraints:
            spec.host_cap = min(c for c, _ in constraints)
            spec.host_nsrc = len(constraints)
            # sorted: host_counts insertion order is content-ordered, not
            # hash-ordered (its fold key already sorts items; this keeps
            # any future iteration deterministic too)
            for d in sorted({d for _, counts in constraints for d in counts}):
                residual = min(c - counts.get(d, 0) for c, counts in constraints)
                spec.host_counts[d] = spec.host_cap - max(residual, 0)
        g.topo = spec

    # -- shared constraints: one TopologyGroup spanning several groups -----
    # (e.g. a Deployment's anti-affinity across request shapes, or the
    # reference benchmark's cross-selecting spread classes). Tensorized via
    # kernel carries when counting stays fully inside the tensorized
    # groups: every owner pod grouped and no oracle-routed pod matches the
    # selector. Three per-group roles fall out of the oracle's semantics:
    #
    # - SELF owner (tg.selects(rep)): gated by the counts AND counted —
    #   DMODE_SPREAD/AFFINITY (or the hostname per-entity cap) plus the
    #   carry self-update.
    # - GATE owner (owns the constraint, not selected by it): gated by
    #   counts other groups' placements evolve, never counted —
    #   DMODE_GATE_* (or the hostname gate threshold, g_hself=False).
    # - CONTRIBUTOR (selected, doesn't own): counted, never gated —
    #   contrib_h/contrib_d rows; the kernel adds its placements to the
    #   carry by the record() rule (single-domain entities only,
    #   scheduling/topology.py:491-498).
    partners: Dict[int, set] = {}  # gi -> co-parties of any shared constraint

    def _filter_free(tg) -> bool:
        """Kernel carry counting is node-filter-blind; only constraints
        whose filter matches every node qualify for cross-group counting
        (topologynodefilter.go:26-97 zero-value shape)."""
        nf = tg.node_filter
        if nf.taint_policy == "Honor":
            return False
        return all(len(r.values()) == 0 for r in nf.requirements)

    for tg in shared_pending.values():
        owner_gis = set()
        oracle_owner = False
        for uid in tg.owners:
            gi = uid2gi.get(uid)
            if gi is None:
                oracle_owner = True  # an owner pod routed to the oracle
            else:
                owner_gis.add(gi)
        matched = matched_owners(tg.namespaces, tg.selector)
        contrib_gis = {gi for gi in matched - owner_gis if gi >= 0}
        oracle_matched = -1 in matched
        reps = {gi: groups[gi].pods[0] for gi in owner_gis}
        self_gis = {gi for gi, rep in reps.items() if tg.selects(rep)}
        gate_gis = owner_gis - self_gis
        # the original all-self, exactly-self-matching shape
        plain = not contrib_gis and not gate_gis

        def _admit() -> Optional[Tuple[str, object, Optional[int]]]:
            if oracle_owner or not owner_gis or oracle_matched:
                return None
            if not plain and not _filter_free(tg):
                return None
            if tg.key == labels_mod.HOSTNAME:
                if tg.type is TopologyType.POD_AFFINITY:
                    return None
                if tg.type is TopologyType.POD_ANTI_AFFINITY and not plain:
                    # Required anti-affinity is enforced symmetrically: the
                    # oracle's inverse gating (topology.go:509-525) blocks
                    # any SELECTED pod from entities where an owner already
                    # landed. The kernel gates only owners, so a selected-
                    # but-ungated placement AFTER an owner could co-locate.
                    # Admit only when FFD order makes that impossible:
                    # contributors pack strictly before every owner, and
                    # self owners strictly before gate owners (gate-owner
                    # placements are uncounted, so a later self owner would
                    # not see them in the carry). Ties are rejected — the
                    # post-sort order of equal keys is build-order-dependent.
                    def _ffd_key(gi: int):
                        return ffd_sort_key(groups[gi])

                    if contrib_gis and max(
                        _ffd_key(gi) for gi in contrib_gis
                    ) >= min(_ffd_key(gi) for gi in owner_gis):
                        return None
                    if (
                        gate_gis
                        and self_gis
                        and max(_ffd_key(gi) for gi in self_gis)
                        >= min(_ffd_key(gi) for gi in gate_gis)
                    ):
                        return None
                cap = tg.max_skew if tg.type is TopologyType.SPREAD else 1
                # gate threshold: blocked when the entity's count already
                # EXCEEDS the allowance (spread: > maxSkew with min 0;
                # anti: > 0), no count contribution
                thresh = tg.max_skew if tg.type is TopologyType.SPREAD else 0
                return (
                    "h",
                    SharedHostTG(
                        cap=cap,
                        counts={d: c for d, c in tg.domains.items() if c > 0},
                        tg=tg,
                    ),
                    thresh,
                )
            if (
                tg.key in DOMAIN_KEYS
                and tg.type is not TopologyType.POD_ANTI_AFFINITY
            ):
                # the min/selection universe must be identical across the
                # sharing groups (it is pod-admissibility-dependent)
                universes = set()
                for gi in owner_gis:
                    gr = groups[gi].requirements
                    pod_dom = (
                        gr.get(tg.key)
                        if gr.has(tg.key)
                        else Requirement(tg.key, Operator.EXISTS)
                    )
                    universes.add(
                        frozenset(d for d in tg.domains if pod_dom.has(d))
                    )
                if len(universes) != 1:
                    return None
                universe = next(iter(universes))
                counts = {d: tg.domains[d] for d in universe}
                if tg.type is TopologyType.SPREAD:
                    min0 = (
                        tg.min_domains is not None
                        and len(counts) < tg.min_domains
                    )
                    return (
                        "d",
                        SharedDomainTG(
                            key=tg.key,
                            mode=DMODE_SPREAD,
                            skew=tg.max_skew,
                            min0=min0,
                            prior=counts,
                            reg=frozenset(counts),
                            tg=tg,
                        ),
                        None,
                    )
                nonempty = [d for d, c in counts.items() if c > 0]
                if nonempty and plain:
                    # compatible pods already placed and no contributor can
                    # grow the options: a STATIC gate to all nonempty
                    # domains (topologygroup.go:277-290) — no carry. With
                    # contributors the options evolve mid-solve, so the
                    # dynamic follow rule in the kernel applies instead.
                    return ("gate", (tg.key, nonempty), None)
                return (
                    "d",
                    SharedDomainTG(
                        key=tg.key,
                        mode=DMODE_AFFINITY,
                        prior=counts,
                        reg=frozenset(counts),
                        tg=tg,
                    ),
                    None,
                )
            return None

        admitted = _admit()
        if admitted is not None:
            kind, desc, thresh = admitted
            # admitted flips to None when ANY owner fails; order never escapes
            # analysis: sanctioned[DET1101] check-only loop
            for gi in owner_gis:
                spec = group_specs.get(gi)
                if spec is None or gi in demote:
                    admitted = None
                    break
                if kind == "h" and spec.shared_h is not None:
                    admitted = None  # one shared hostname constraint/group
                    break
                if kind == "d" and (
                    spec.shared_d is not None
                    or spec.dmode != DMODE_NONE
                    or spec.haff
                ):
                    admitted = None  # one domain-dynamic per group
                    break
            if admitted is not None:
                if kind == "gate":
                    # analysis: sanctioned[DET1101] one keyed add per owner
                    for gi in owner_gis:
                        key, allowed = desc
                        groups[gi].requirements.add(
                            Requirement(key, Operator.IN, allowed)
                        )
                    topology.kernel_static_folds.append(tg)
                    # static gate: no carry, no partner coupling
                else:
                    # analysis: sanctioned[DET1101] per-owner writes commute
                    for gi in owner_gis:
                        spec = group_specs[gi]
                        is_self = gi in self_gis
                        if kind == "h":
                            spec.shared_h = desc
                            spec.h_self = is_self
                            spec.h_capval = desc.cap if is_self else thresh
                        else:
                            spec.shared_d = desc
                            spec.dmode = (
                                desc.mode
                                if is_self
                                else (
                                    DMODE_GATE_SPREAD
                                    if desc.mode == DMODE_SPREAD
                                    else DMODE_GATE_AFF
                                )
                            )
                            spec.dkey = desc.key
                            spec.dskew = desc.skew
                            spec.dmin0 = desc.min0
                            spec.dprior = desc.prior
                            spec.dreg = desc.reg
                    # one append per contributor's own list, so the cross-gi
                    # analysis: sanctioned[DET1101] order is unobservable
                    for gi in contrib_gis:
                        g = groups[gi]
                        if g.topo is None:
                            g.topo = TopoSpec()
                        if kind == "h":
                            g.topo.contrib_h.append(desc)
                        else:
                            g.topo.contrib_d.append(desc)
                    parties = owner_gis | contrib_gis
                    # partners is read by keyed .get() only, so its
                    # analysis: sanctioned[DET1101] insertion order never escapes
                    for gi in parties:
                        partners.setdefault(gi, set()).update(parties - {gi})
        if admitted is None:
            demote.update(owner_gis)

    # transitive closure: a demoted group's constraints join the oracle
    # side, and a demoted group drags every partner of its shared
    # constraints with it (split counting would be wrong)
    pending = set(demote)
    while pending:
        gi = pending.pop()
        before = set(demote)
        for p in groups[gi].pods:
            demote_by_selectors(p)
        demote.update(partners.get(gi, ()))
        pending |= demote - before

    # -- bootstrap-affinity group merge -------------------------------------
    # Indistinguishable DMODE_AFFINITY groups (identical shape/requirements/
    # domain universe, zero priors, no shared constraints or carries) all
    # bootstrap to the SAME domain when no existing node can host them and
    # the offering availability is static: d_fresh is the rank-min over
    # fresh-feasible registered domains, which none of their placements move
    # (topologygroup.go:291-324 run per group with identical inputs). The
    # reference's diverse benchmark mix creates ~1 such group per pod
    # (random self-affinity labels); merging collapses them to one scan
    # step each per shape. Gated off by the driver when existing nodes or a
    # reservation ledger make availability state-dependent.
    merged: set = set()
    if merge_bootstrap_affinity and not getattr(topology, "_state_nodes", ()):
        # single-group shared-affinity FAMILIES are mergeable across
        # families: the merge key pins (shape, requirements, universe), so
        # every merged member computes the SAME static d_fresh — d_fresh is
        # shape-dependent (fresh_ok_d is built from the group's own
        # type_ok row, ops/packing.py), which is exactly why families with
        # a second, differently-shaped sibling are excluded: the sibling
        # reads the family carry the merged-away member would have
        # written, and its own d_fresh may differ. Contributor-fed descs
        # (options evolve from outside the family) and priors (the family
        # follows its prior domain) are excluded too. Contributor descs
        # are collected from EVERY group's topo — constraint-free
        # contributor groups never enter group_specs.
        contrib_descs = set()
        for g in groups:
            if g.topo is not None:
                for d in g.topo.contrib_d:
                    contrib_descs.add(id(d))
        fam: Dict[int, List[int]] = {}
        for gj, sp in group_specs.items():
            if sp.shared_d is not None:
                fam.setdefault(id(sp.shared_d), []).append(gj)

        def _family_ok(spec) -> bool:
            if spec.shared_d is None:
                return True
            did = id(spec.shared_d)
            if did in contrib_descs:
                return False
            if any(spec.shared_d.prior.values()):
                return False
            return len(fam[did]) == 1

        by_merge_key: Dict[tuple, int] = {}
        for gi, g in enumerate(groups):
            if gi in demote:
                continue
            spec = group_specs.get(gi)
            if (
                spec is None
                or spec.dmode != DMODE_AFFINITY
                or any(spec.dprior.values())
                or spec.shared_h is not None
                or spec.contrib_h
                or spec.contrib_d
                or spec.host_cap is not None
                or spec.haff
                or not _family_ok(spec)
            ):
                continue
            key = (
                tuple(sorted(g.requests.items())),
                repr(g.requirements),
                spec.dkey,
                frozenset(spec.dreg),
            )
            prim = by_merge_key.get(key)
            if prim is None:
                by_merge_key[key] = gi
            else:
                groups[prim].pods.extend(g.pods)
                merged.add(gi)

    kept = [
        g for gi, g in enumerate(groups)
        if gi not in demote and gi not in merged
    ]
    # sorted: the demoted-pod list escapes to the oracle side; hash-order
    # here would reorder oracle processing across PYTHONHASHSEED twins
    demoted_pods = [p for gi in sorted(demote) for p in groups[gi].pods]
    return kept, demoted_pods
