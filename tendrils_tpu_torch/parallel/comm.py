"""The collectives of the sharded frames, on `torch.distributed`: the
port's counterpart of the collectives inside the JAX package's
`shard_map` bodies (`psum`, `psum_scatter`, `all_gather`).

  `all_reduce_sum`       the data-parallel draw's one collective: K2's int64
                         sums (`draw_cuda.fused_draw(psum=...)`), or the
                         generic draw's f32 parts (`reduce_parts`);
  `reduce_scatter_rows`  the slab frame's parts, summed, each rank keeping
                         its row slab (`parallel.spatial`);
  `all_gather_rows`      the slab frame's two-channel decayed flow, whole on
                         every rank;
  `broadcast`            rank 0's state to every rank before it is sharded.

Each runs on the tensors as they lie, in the group's backend, which
`dist.get_backend(group)` reads: NCCL on the card's tensors; gloo on CPU
tensors (the tests, the dry run) and on CUDA tensors, which gloo takes for
each of these four collectives (PyTorch 2.11 on an H100: int64 and f32
all-reduce, `reduce_scatter_tensor`, `all_gather_into_tensor` and
`broadcast` on tensors of the card, two and four ranks sharing it; gloo
stages them through host memory itself), so no copy is made here. An NCCL
group refuses a CPU tensor (`ValueError`).

Every call counts, by kind, in `calls`, in `payload` (the bytes of the
tensor it hands over: the input of an all-reduce or a reduce-scatter, the
output of an all-gather, the broadcast tensor) and in `moved` (the bytes a
rank sends under the ring model: an all-reduce 2 (D - 1) / D of its
tensor, a reduce-scatter or an all-gather (D - 1) / D of the whole, a
broadcast the tensor once; 0 at D = 1), so that a test or
`chip_smoke.py` can pin a frame's collective set as the JAX dry run pins
it from the compiled HLO (`__graft_entry__.py:140-183`). A collective that
fails raises, and fails the frame.
"""

import collections

import torch
import torch.distributed as dist

calls = collections.Counter()
payload = collections.Counter()
moved = collections.Counter()


def reset_counts():
    calls.clear()
    payload.clear()
    moved.clear()


def _count(kind, group, t, share):
    """Count one call of `kind` on `t`; `share(d)`: the ring model's bytes
    a rank sends over the tensor's bytes, at world size d."""
    if dist.get_backend(group) == "nccl" and not t.is_cuda:
        raise ValueError(f"{kind}: an NCCL group takes CUDA tensors, got "
                         f"one on {t.device}")
    nbytes = t.numel() * t.element_size()
    calls[kind] += 1
    payload[kind] += nbytes
    moved[kind] += int(nbytes * share(dist.get_world_size(group)))


def all_reduce_sum(t, group=None):
    """Sum the contiguous `t` over the group's ranks, in place; returns
    it."""
    _count("all_reduce", group, t, lambda d: 2 * (d - 1) / d)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def reduce_scatter_rows(t, group=None, dim=1):
    """The sum over the group's ranks of `t` (`[C, H, W]` by default, rows
    at `dim`), of which this rank keeps its slab of H / D rows (rank r:
    rows r H / D to (r + 1) H / D); H must divide by the world size D."""
    d = dist.get_world_size(group)
    rows = t.shape[dim]
    if rows % d:
        raise ValueError(f"{rows} rows do not divide over {d} ranks")
    # Slab r contiguous, the r-th of D equal pieces along the first
    # dimension, as `reduce_scatter_tensor` cuts its input.
    slabs = t.unflatten(dim, (d, rows // d)).movedim(dim, 0)
    out = torch.empty(slabs.shape[1:], dtype=t.dtype, device=t.device)
    stacked = slabs.reshape(d * out.shape[0], *out.shape[1:])
    _count("reduce_scatter", group, stacked, lambda d: (d - 1) / d)
    dist.reduce_scatter_tensor(out, stacked, op=dist.ReduceOp.SUM,
                               group=group)
    return out


def all_gather_rows(t, group=None, dim=1):
    """Every rank's slab `t` (`[C, H / D, W]` by default, rows at `dim`)
    joined in rank order along `dim` into the whole `[C, H, W]`."""
    d = dist.get_world_size(group)
    # Rank r's slab the r-th of D equal pieces along the first dimension.
    out = torch.empty((d * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _count("all_gather", group, out, lambda d: (d - 1) / d)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.unflatten(0, (d, t.shape[0])).movedim(0, dim).flatten(
        dim, dim + 1)


def broadcast(t, group=None):
    """Rank 0's `t` (contiguous), in place on every rank; returns it."""
    _count("broadcast", group, t, lambda d: 1.0 if d > 1 else 0.0)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(t, src=src, group=group)
    return t


def reducer(psum):
    """The sum over the ranks as a callable on a tensor: `psum` itself
    when it is callable, else the all-reduce over `psum`, a process
    group."""
    if callable(psum):
        return psum
    return lambda t: all_reduce_sum(t, psum)


def reduce_parts(psum, *parts):
    """Splat parts (tuples of f32 tensors, `(num, wsum, logt)`) summed over
    the ranks in one collective (`reducer(psum)` on their concatenation),
    in the same structure."""
    flat = [t for part in parts for t in part]
    total = reducer(psum)(torch.cat([t.reshape(-1) for t in flat]))
    out = iter(total.split([t.numel() for t in flat]))
    return tuple(tuple(next(out).view(t.shape) for t in part)
                 for part in parts)
