"""The solve's argument tuple on a torch device.

``EncodedSnapshot.solve_args`` (solver/encode.py) is the kernels' ABI: a
positional tuple of numpy arrays in ``SOLVE_ARG_NAMES`` order. The port
moves it onto a device one array at a time, keeping each dtype: bool ->
torch.bool, int32 -> torch.int32 (never int64), float32 -> torch.float32.
Any other dtype is an encoder bug and raises.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .encode import SOLVE_ARG_NAMES

# torch.from_numpy keeps each of these dtypes as is
_DTYPES = (np.dtype(bool), np.dtype(np.int32), np.dtype(np.float32))


def to_device_args(solve_args: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Each array of ``solve_args`` as a contiguous tensor on ``device``."""
    if len(solve_args) != len(SOLVE_ARG_NAMES):
        raise ValueError(
            f"solve_args has {len(solve_args)} entries, expected {len(SOLVE_ARG_NAMES)}"
        )
    out = []
    for name, arr in zip(SOLVE_ARG_NAMES, solve_args):
        arr = np.asarray(arr)
        if arr.dtype not in _DTYPES:
            raise TypeError(f"solve arg {name}: unsupported dtype {arr.dtype}")
        out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    return out
