"""Seeded host syncs for the torch host-sync rule: every DTX rule fires
here. Host-side driver-shaped code whose device tensors reach host sinks
outside any sanctioned site."""

import numpy as np
import torch

from karpenter_tpu_torch.ops.solve import dispatch_packed


def branch_on_device(xs, dev):
    scores = torch.cumsum(xs.to(dev), 0)  # device origin: .to(dev)
    if scores[0] > 0:  # DTX901: truthiness on a device tensor
        return scores
    while scores.sum() > 0:  # DTX901 again (device while-condition)
        scores = scores - 1
    flag = bool(scores[0])  # DTX901: bool() materializes the predicate
    return flag


def materialize_device(n):
    total = torch.ones((n,), device="cuda").sum()
    best = float(total)  # DTX902: host materialization
    exact = total.item()  # DTX902: .item() sync
    rows = total.tolist()  # DTX902: .tolist() sync
    arr = total.numpy()  # DTX902: .numpy()
    return best, exact, rows, arr


def numpy_on_device(xs):
    staged = xs.cuda()  # device origin: .cuda()
    host = np.asarray(staged)  # DTX903: an implicit readback
    arr = np.array(staged)  # DTX903 again
    return host, arr


def iterate_device(xs, dev):
    cols = torch.stack([xs, xs]).to(device=dev)
    out = []
    for row in cols:  # DTX904: python loop over a device tensor
        out.append(row)
    return out, list(cols)  # DTX904: list() iterates on host


def print_device(xs, dev):
    mean = xs.to(dev).mean()
    print("mean was", mean)  # DTX905: print syncs the value
    return f"mean={mean}"  # DTX905: f-string interpolation


def unsanctioned_waits(xs, dev):
    out = torch.sort(xs.to(dev)).values
    host = out.cpu()  # DTX906: a readback without a sanction
    torch.cuda.synchronize()  # DTX906: a wait without a sanction
    torch.cuda.current_stream().synchronize()  # DTX906: a stream's wait too
    return host, out.to("cpu")  # DTX906: .to("cpu") reads back too


def launcher_result(args):
    outs = dispatch_packed(*args)  # the kernel-launch convention
    if outs[3]:  # DTX901 on a launcher's output
        return None
    return outs


def helper_launders_device(xs):
    # interprocedural reach: _hidden_origin returns a device tensor, so
    # `masked` is one at this call site too
    masked = _hidden_origin(xs)
    if masked[0] > 0:  # DTX901 through the helper summary
        return masked
    return None


def _hidden_origin(xs):
    return torch.where(xs > 0, xs, torch.zeros((4,), device="cuda"))


def branch_merge_still_device(use_alt, dev):
    # the CFG join keeps DEVICE through the diamond: both arms bind a
    # device tensor, so the sink below must still flag
    if use_alt:
        acc = torch.zeros((4,), device=dev)
    else:
        acc = torch.ones((4,), device=dev)
    return int(acc[0])  # DTX902 after the join
