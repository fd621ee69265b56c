"""Clean twin for the torch host-sync rule: device tensors stay on the
card until the sanctioned drain; every host decision reads host values or
tensor metadata."""

import numpy as np
import torch


def disciplined_solve(xs, nmax: int, dev):
    staged = xs.to(dev)
    out = torch.cumsum(staged, 0)  # device math stays on the device
    if nmax > 4:  # host branch on a host value: fine
        out = out * 2
    # analysis: sanctioned[DTX906] fixture drain
    host = out.cpu().numpy()
    return np.asarray(host)  # host numpy on a host value: fine


def metadata(xs, dev):
    arr = torch.stack([xs, xs]).to(dev)
    n = arr.shape[0]  # shape/dtype/device projections are host metadata
    if n > 1 and arr.numel() > 2 and arr.dim() == 2 and arr.is_cuda:
        return arr.data_ptr()
    return arr.T


def dtype_casts_stay_on_the_host(xs):
    arr = torch.from_numpy(xs).to(torch.int32)  # a cast, not a move
    if arr[0] > 0:  # a host tensor: no sync
        return int(arr.sum())
    return 0


def cpu_device_literal(n):
    t = torch.zeros((n,), device="cpu")  # made on the host
    if t.sum() > 0:
        return float(t[0])
    return torch.ones((n,), device=torch.device("cpu")).tolist()


def poison_to_unknown(xs, blob, dev):
    mixed = xs.to(dev).sum() + blob.mystery()  # joins to unknown
    if mixed > 0:  # unknown, not device: silent by design
        return mixed
    for item in blob.rows():  # unknown iterable: silent
        print(item)  # unknown value: silent
    return None


def pack_reference(n, dev):
    # a plain version: outside the rule, with the helpers only it calls
    acc = torch.zeros((n,), device=dev)
    if acc.sum() > 0:
        return int(acc[0])
    return _plain_helper(n, dev)


def _plain_helper(n, dev):
    return torch.ones((n,), device=dev).cpu().tolist()
