# Copied from karpenter_tpu/scheduling/queue.py.
"""First-fit-decreasing pod queue with staleness detection.

Mirror of the reference's scheduling queue (queue.go:37-112): pods sorted by
CPU then memory descending; ``pop`` stops once a full cycle over the queue
makes no progress; relaxation resets the progress tracking.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import resources as res


def ffd_sort_key(pod, requests: res.ResourceList) -> tuple:
    """Descending cpu, then memory; stable tie-break by creation time then
    uid (queue.go:76-112)."""
    return (
        -requests.get(res.CPU, 0),
        -requests.get(res.MEMORY, 0),
        pod.metadata.creation_timestamp,
        pod.uid,
    )


class Queue:
    def __init__(self, pods: List, requests_by_uid: Dict[str, res.ResourceList]):
        self._pods = sorted(pods, key=lambda p: ffd_sort_key(p, requests_by_uid[p.uid]))
        self._last_len: Dict[str, int] = {}

    def pop(self) -> Optional[object]:
        """Next pod, or None once a full no-progress cycle completes."""
        if not self._pods:
            return None
        pod = self._pods[0]
        if self._last_len.get(pod.uid) == len(self._pods):
            return None
        self._pods.pop(0)
        return pod

    def push(self, pod, relaxed: bool = False) -> None:
        self._pods.append(pod)
        if relaxed:
            self._last_len = {}
        else:
            self._last_len[pod.uid] = len(self._pods)

    def list(self) -> List:
        return list(self._pods)

    def __len__(self) -> int:
        return len(self._pods)
