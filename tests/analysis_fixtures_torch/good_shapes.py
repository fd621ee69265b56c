"""Clean twin of bad_shapes.py (a torch rendering of
tests/analysis_fixtures/good_shapes.py): the same computations with the
axis order, dtypes and bucketed literal dims done right — the port's
SHP6xx pass must stay silent."""

import torch

from karpenter_tpu_torch.parallel.mesh import ARG_SPECS, cut, place, spec_of


def aligned_join(n, r):
    a = torch.zeros((n, r), dtype=torch.float32)
    b = torch.zeros((n, r), dtype=torch.float32)
    return a + b


def expanded_mask(n, r):
    mask = torch.zeros((n,), dtype=torch.bool)
    x = torch.ones((n, r), dtype=torch.float32)
    return torch.where(mask[:, None], x, 0.0)


def consistent_einsum_spec(n, t):
    a = torch.zeros((n, t), dtype=torch.float32)
    b = torch.zeros((t, n), dtype=torch.float32)
    return torch.einsum("nt,tn->n", a, b)


def aligned_matmul(n, r, t):
    a = torch.zeros((n, r), dtype=torch.float32)
    b = torch.zeros((r, t), dtype=torch.float32)
    return a @ b  # legal contraction: [n, r] @ [r, t] -> [n, t]


def narrow_positional(spans):
    return torch.as_tensor(spans, torch.float32)


def narrow_accumulator(n):
    acc = torch.zeros((n,), dtype=torch.float32)
    x = torch.ones((n,), dtype=torch.float32)
    y = x.to(torch.int32)
    return acc + x, y


def bucketed_scratch(n):
    pad = torch.zeros(n, 1024, dtype=torch.float32)
    flat = pad.view(n, 32, 32)
    return flat


def segment_contraction(l, m, g):
    """The sparse feasibility shape: compacted live pairs summed back to
    the group axis; the result's axes are (g, m) and join silently."""
    data = torch.zeros((l, m), dtype=torch.float32)
    ids = torch.zeros((l,), dtype=torch.int32)
    seg = torch.zeros((g, m), dtype=torch.float32)
    seg.index_add_(0, ids, data)  # [g, m]
    return seg + torch.zeros((g, m), dtype=torch.float32)


def gather_along_group_axis(g, m):
    seg = torch.zeros((g, m), dtype=torch.float32)
    idx = torch.zeros((g, m), dtype=torch.int32)
    picked = seg.gather(1, idx)  # the index's axes
    return picked + torch.zeros((g, m), dtype=torch.float32)


def bucketed_broadcast(g, m):
    row = torch.zeros((m,), dtype=torch.float32)
    wide = row[None, :].expand(g, m)
    return wide + torch.zeros((g, m), dtype=torch.float32)


def unpacked_axes(p_tol, type_ok):
    """Axes named at .shape unpacking: [P, G] against [P, G, T] with the
    pair axis expanded, the types moved last and back."""
    P, G = p_tol.shape
    T = type_ok.shape[-1]
    ok = type_ok & p_tol[:, :, None]
    flat = ok.permute(2, 0, 1).reshape(T, P * G)
    return ok.sum(-1, dtype=torch.int32) + torch.zeros((P, G), dtype=torch.int32), flat.t()


def sharded_padded_axis(mesh, m):
    """A pow2 leading dim under a mesh-axis entry divides any pow2 mesh
    axis — silent."""
    row = torch.zeros((m,), dtype=torch.float32)
    x = row[None, :].expand(64, m)
    spec = ("data", None)
    y = cut(x, ((0, 0),), spec, mesh.shape)
    return y + torch.zeros((64, m), dtype=torch.float32)


def replicated_any_size(mesh, m):
    """A replicated spec places the whole buffer on every device: no
    divisibility constraint, any dim is fine."""
    row = torch.zeros((m,), dtype=torch.float32)
    x = row[None, :].expand(48, m)
    return place("g_mask", x, mesh), cut(x, (), ARG_SPECS["g_req"], mesh.shape)


def sharded_named_dim(mesh, n, m):
    """A named (non-literal) dim under a mesh axis: unknowable statically,
    the pass must not guess."""
    row = torch.zeros((m,), dtype=torch.float32)
    x = row[None, :].expand(n, m)
    return place("gk_g", x, mesh), cut(x, ((0, 0),), spec_of("t_alloc"), mesh.shape)
