# Copied from karpenter_tpu/scheduling/hostports.py.
"""Host-port conflict tracking (reference: pkg/scheduling/hostportusage.go)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# (host_ip, port, protocol)
PortKey = Tuple[str, int, str]


def _entries(pod) -> List[PortKey]:
    out = []
    for hp in pod.spec.host_ports:
        if hp.port:
            out.append((hp.host_ip or "0.0.0.0", hp.port, hp.protocol or "TCP"))
    return out


def _conflicts(a: PortKey, b: PortKey) -> bool:
    ip_a, port_a, proto_a = a
    ip_b, port_b, proto_b = b
    if port_a != port_b or proto_a != proto_b:
        return False
    return ip_a == ip_b or ip_a == "0.0.0.0" or ip_b == "0.0.0.0"


class HostPortUsage:
    """Per-node ledger of reserved host ports."""

    def __init__(self):
        self._used: Dict[str, List[PortKey]] = {}  # pod uid -> entries

    def conflicts(self, pod) -> Optional[str]:
        for entry in _entries(pod):
            for uid, entries in self._used.items():
                if uid == pod.uid:
                    continue
                for existing in entries:
                    if _conflicts(entry, existing):
                        return f"host port {entry} conflicts with pod {uid}"
        return None

    def add(self, pod) -> None:
        self._used[pod.uid] = _entries(pod)

    def delete_pod(self, uid: str) -> None:
        self._used.pop(uid, None)

    def copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        out._used = {k: list(v) for k, v in self._used.items()}
        return out
