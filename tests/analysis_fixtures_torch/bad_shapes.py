"""Seeded-bad fixture for the port's SHP6xx axis/dtype pass: a torch
rendering of tests/analysis_fixtures/bad_shapes.py, function by function
(``segment_sum`` is ``index_add_``; ``NamedSharding`` / ``PartitionSpec``
are the mesh's specs and its sinks ``place`` and ``cut``).

Each function below carries exactly the hazard its name says; the pass
must flag every rule at least once, and tests/test_torch_analysis.py holds
the (function, rule) pairs against JAX's pass on JAX's fixture.
"""

import torch

from karpenter_tpu_torch.parallel.mesh import cut, place, spec_of


def transposed_join(n, r):
    a = torch.zeros((n, r), dtype=torch.float32)
    b = torch.zeros((r, n), dtype=torch.float32)
    return a + b  # SHP601: [n, r] + [r, n]


def unexpanded_mask(n, r):
    mask = torch.zeros((n,), dtype=torch.bool)
    x = torch.ones((n, r), dtype=torch.float32)
    # SHP601: mask needs [:, None] — as written 'n' aligns against 'r'
    return torch.where(mask, x, 0.0)


def stale_einsum_spec(n, t):
    a = torch.zeros((n, t), dtype=torch.float32)
    b = torch.zeros((t, n), dtype=torch.float32)
    # SHP601: letter 'n' binds axis n (from a) AND axis t (from b)
    return torch.einsum("nt,nt->n", a, b)


def transposed_matmul(n, r, t):
    a = torch.zeros((n, r), dtype=torch.float32)
    b = torch.zeros((t, r), dtype=torch.float32)
    return a @ b  # SHP601: contracts r against t (b needs transposing)


def widened_accumulator(n):
    acc = torch.zeros((n,), dtype=torch.float64)  # SHP602: explicit f64 constructor
    x = torch.ones((n,), dtype=torch.float32)
    y = x.to(torch.float64)  # SHP602: .to a 64-bit dtype
    return acc + x, y  # SHP602: f64/f32 join widens


def widened_positional(spans):
    # SHP602: positional dtype slot, no dtype= keyword
    return torch.as_tensor(spans, torch.float64)


def unbucketed_scratch(n):
    pad = torch.zeros((n, 1000), dtype=torch.float32)  # SHP603: 1000 is not a bucket
    flat = pad.reshape(n, 40, 25)  # SHP603: literal 40/25 dims
    return flat


def misaligned_segment_ids(l, m, g):
    data = torch.zeros((l, m), dtype=torch.float32)
    ids = torch.zeros((m,), dtype=torch.int32)
    seg = torch.zeros((g, m), dtype=torch.float32)
    # SHP601: ids ride axis m but data's indexed axis is l
    return seg.index_add_(0, ids, data)


def segment_result_misjoined(l, m, g):
    data = torch.zeros((l, m), dtype=torch.float32)
    ids = torch.zeros((l,), dtype=torch.int32)
    seg = torch.zeros((g, m), dtype=torch.float32).index_add_(0, ids, data)  # [g, m]
    return seg + torch.zeros((l, m), dtype=torch.float32)  # SHP601: g joined with l


def sharded_unpadded_axis(mesh, m):
    # 48 rows never went through the pow2 shard padding; expand so the
    # constructor-literal rule (SHP603) stays out of this function
    row = torch.zeros((m,), dtype=torch.float32)
    x = row[None, :].expand(48, m)
    return place("gk_g", x, mesh)  # SHP604: ARG_SPECS' 'data' shards a 48-dim


def sharded_unpadded_via_names(mesh, m):
    spec = spec_of("p_titype_ok")
    key = ((1, 0),)
    x = torch.zeros((m,), dtype=torch.float32)[:, None].expand(m, 24)
    # SHP604: the name-resolved spec partitions the literal 24 column axis
    return cut(x, key, spec, mesh.shape)
