"""Seeded host crossings between solves: a residency store holds device
tensors across solves under the resident-attribute naming convention
(``dev_*`` / ``_dev_*``, solver/residency.py). Laundering one of them
through host numpy, branching on it, iterating it or reading it back
outside the sanctioned drain is a host sync the carrying ``self`` would
otherwise hide."""

import numpy as np
import torch


class ResidentStore:
    def __init__(self):
        self._dev_rows = None
        self.dev_avail = None

    def stage(self, host, dev):
        self._dev_rows = torch.from_numpy(host).to(dev)
        self.dev_avail = torch.zeros((4,), device=dev)

    def laundered_delta(self, idx):
        # DTX903: np.asarray on a resident buffer between solves
        rows = np.asarray(self._dev_rows)
        return rows[idx]

    def peek(self):
        if self.dev_avail[0] > 0:  # DTX901: truthiness on a resident buffer
            return True
        return False

    def drain_all(self):
        # DTX906: a readback of a resident buffer outside the drain
        return self._dev_rows.cpu()

    def walk(self):
        return list(self.dev_avail)  # DTX904: host iteration per element
