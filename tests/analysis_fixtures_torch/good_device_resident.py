"""Clean residency store: buffers held across solves never reach the
host except at the sanctioned drain; ``_device`` holds a torch.device,
which the resident convention (``_dev_*``) does not take for a buffer."""

import torch


class ResidentStore:
    def __init__(self):
        self._dev_rows = None
        self._device = None

    def stage(self, host, device):
        device = torch.device(device)
        if device != self._device:  # a torch.device, not a buffer: fine
            self._dev_rows = None
            self._device = device
        self._dev_rows = torch.from_numpy(host).to(device)

    def delta_apply(self, idx, vals):
        # an on-device row update: no host crossing
        self._dev_rows = self._dev_rows.index_copy(0, idx, vals)
        return self._dev_rows

    def shape(self):
        return self._dev_rows.shape  # host metadata, not a sync

    def drain(self):
        # the one readback, sanctioned at the boundary
        return self._dev_rows.cpu()  # analysis: sanctioned[DTX906] fixture drain point
