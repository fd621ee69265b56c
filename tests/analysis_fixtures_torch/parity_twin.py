"""Miniature Python side of the port's kernel-twin triple for the PAR5xx
tests: two plain scans over a tiny PackState, one carrying its state in
declared locals and one in the NamedTuple, paired with parity_good.cc
(the host core: the tiers only) and parity_good.cuh + parity_good.cu (the
CUDA twin over two files, with the tiled mode's phase)."""

from typing import NamedTuple

import torch

_BIG = 2**20


class PackState(NamedTuple):
    c_used: torch.Tensor
    c_npods: torch.Tensor
    overflow: torch.Tensor


def pack_reference(xs, n, tiled=False):
    # parity: state c_used, c_npods, overflow
    c_used = torch.zeros((n,), dtype=torch.float32)
    c_npods = torch.zeros((n,), dtype=torch.int32)
    overflow = torch.zeros((), dtype=torch.bool)
    # parity: phase tile-rows
    if tiled:
        xs = xs.clone()
    # parity: phase fill
    level = torch.argmin(torch.where(xs > 0, xs, _BIG))
    # parity: phase settle
    order = xs.cumsum(0) * 0.25
    return c_used + order, c_npods, overflow, level


def pack_classed_reference(xs, n, tiled=False):
    state = PackState(
        c_used=torch.zeros((n,), dtype=torch.float),
        c_npods=torch.zeros((n,), dtype=torch.int),
        overflow=torch.zeros((), dtype=torch.bool),
    )
    # parity: phase tile-rows
    if tiled:
        xs = xs.clone()
    # parity: phase fill
    level = torch.where(xs > 0, xs, _BIG).argmin()
    # parity: phase settle
    order = torch.cumsum(xs, 0) * 0.25
    return state._replace(c_used=state.c_used + order), level
