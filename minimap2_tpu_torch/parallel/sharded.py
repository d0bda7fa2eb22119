"""The sharded mapping step over torch.distributed: the port of the JAX
package's make_sharded_step (batch.py:1527-1590) and stack_shards
(:1605-1607; here ``batch.stack_shards``).

Reads are split over ``n_data`` data rows, the index over ``n_idx``
key-range shards (``DeviceIndex.from_host(mi, n_shards=n_idx)``).  Rank
``d * n_idx + i`` holds data slice d and index shard i: the JAX mesh
``devices.reshape(n_data, n_idx)``.  Each rank sketches its reads,
compacts the minimizers and finds its shard's anchors; the anchors of a
data row's shards are gathered in rank order (JAX's tiled all_gather over
'idx') and merged by sort3, or past one row by the wide sort (``merge_anchors``), into the A first by (rev
<< 30 | rid, rpos, span << 20 | qpos): minimap2's merge_hits
(map.c:476-539) as a collective.  The chain scan and the score-only extension then run on the
merged anchors, and the mapped count is summed over the data column
(JAX's psum over 'data').

Each shard caps a read's anchors at A by itself (``_expand_anchors``), so
on a read whose anchors exceed A the merge keeps other anchors than the
one-shard step: the JAX step does the same, and this one equals it.

Collectives run on the process group's backend.  With gloo on CUDA
tensors (ranks that share one GPU: NCCL refuses two ranks on a device)
every collective is staged through host memory; ``init_rank`` says so
when it joins.
"""
from __future__ import annotations

import time
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.sketch import sketch_batch
from ..ops.sort import MAX_WIDTH
from .batch import (BatchParams, DeviceIndex, _chain_scan,
                    _compact_minimizers, _extend_best, _lookup_anchors,
                    anchor_keys, sort_anchor_keys, sort_keys)

OUT_FIELDS = ("chain_score", "ext_score", "rid", "rev", "qs", "qe", "rs",
              "re")
PG_TIMEOUT = timedelta(seconds=600)     # a collective's longest wait


def init_rank(rank: int, world: int, init_method: str,
              device=None) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` through
    ``init_method`` (``file://`` or ``tcp://localhost:<port>``) and return
    the rank's device: ``cuda:(rank % device_count)`` unless the caller
    names the CPU.  Ranks that share a GPU (world > device_count) and CPU
    ranks use gloo, ranks on distinct GPUs nccl.  Prints the backend."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_gpu = torch.cuda.device_count()
        dev = torch.device("cuda", rank % n_gpu)
        torch.cuda.set_device(dev)
        backend = "gloo" if world > n_gpu else "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    staged = backend == "gloo" and dev.type == "cuda"
    print(f"[sharded] rank {rank}/{world} on {dev}: backend {backend}"
          + (", collectives staged through host memory" if staged else ""),
          flush=True)
    return dev


def merge_anchors(parts, A: int, max_width: int = MAX_WIDTH):
    """The shards' sort keys (each a triple of (B, A) int32 planes from
    ``anchor_keys``) merged by sort3 launches (counted as
    ``sort3_shard_merge``); the first A lanes unpacked -> (rev, rid, rpos,
    qpos, span, av).  Parts that fit in one ``max_width``-lane row (the
    kernel's widest) are concatenated in shard order and sorted by one
    launch.  More are merged in groups of g (g * A lanes fit a row) as the
    rows of one launch, each row's first A kept, until one group is left:
    a group's first A hold every anchor of the whole first A that lies in
    the group, so the result is the one sort's.  When two parts exceed a
    row (A past max_width / 2), the concatenation goes to ``sort_keys``,
    whose width then picks the wide route (sort.sort3_wide).  The valid
    lanes equal the JAX merge's (lax.sort on the same three keys); invalid
    lanes hold the sentinel's unpacking."""
    parts = [tuple(p) for p in parts]
    B = parts[0][0].shape[0]
    g = max_width // (1 << (A - 1).bit_length())
    while g >= 2 and len(parts) > g:
        blank = tuple(torch.full_like(x, -1) for x in parts[0])
        parts += [blank] * (-len(parts) % g)
        rows = [torch.cat([torch.cat([p[j] for p in parts[q:q + g]], dim=1)
                           for q in range(0, len(parts), g)])
                for j in range(3)]
        s = sort_keys(rows, counter="sort3_shard_merge")
        parts = [tuple(x[q:q + B, :A] for x in s)
                 for q in range(0, s[0].shape[0], B)]
    keys = [torch.cat([p[j] for p in parts], dim=1) for j in range(3)]
    return sort_anchor_keys(keys, A, counter="sort3_shard_merge")


class ShardedStep:
    """One rank's part of the sharded step (see the module docstring).
    ``coll_s`` accumulates the seconds spent in collectives (the device
    synchronised around each)."""

    def __init__(self, p: BatchParams, n_data: int, n_idx: int):
        world = dist.get_world_size()
        if world != n_data * n_idx:
            raise ValueError(f"sharded step: {n_data} x {n_idx} ranks, "
                             f"the group has {world}")
        self.p, self.n_data, self.n_idx = p, n_data, n_idx
        self.rank = dist.get_rank()
        self.d, self.i = divmod(self.rank, n_idx)
        self.gloo = dist.get_backend() == "gloo"
        self.coll_s = 0.0

        def groups(rows):
            # every rank creates every group, in the same order
            return [dist.new_group(rs) for rs in rows]
        self.idx_group = groups([[d * n_idx + i for i in range(n_idx)]
                                 for d in range(n_data)])[self.d]
        self.data_group = groups([[d * n_idx + i for d in range(n_data)]
                                  for i in range(n_idx)])[self.i]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's data slice of a (B, ...) batch (contiguous blocks of
        B / n_data rows, as JAX's P('data'))."""
        return x.reshape(self.n_data, -1, *x.shape[1:])[self.d]

    def _sync(self, t):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def _staged(self, t) -> bool:
        return self.gloo and t.device.type == "cuda"

    def all_gather(self, t: torch.Tensor, group) -> list:
        """all_gather of t over group, in rank order; through host memory
        when the backend is gloo and t is on CUDA."""
        self._sync(t)
        t0 = time.perf_counter()
        x = t.cpu() if self._staged(t) else t.contiguous()
        outs = [torch.empty_like(x)
                for _ in range(dist.get_world_size(group))]
        dist.all_gather(outs, x, group=group)
        outs = [o.to(t.device) for o in outs]
        self._sync(t)
        self.coll_s += time.perf_counter() - t0
        return outs

    def all_reduce_sum(self, t: torch.Tensor, group) -> torch.Tensor:
        """SUM all_reduce of t over group (a new tensor), staged as
        all_gather is."""
        self._sync(t)
        t0 = time.perf_counter()
        x = t.cpu() if self._staged(t) else t.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x = x.to(t.device)
        self._sync(t)
        self.coll_s += time.perf_counter() - t0
        return x

    def __call__(self, di: DeviceIndex, codes, lens):
        """The step on this rank's shard and data slice: codes (B / n_data,
        L) uint8, lens (B / n_data,).  Returns (out, n_mapped,
        n_anc_local): out the 8 (B / n_data,) planes of OUT_FIELDS (the
        same on every rank of a data row), n_mapped the mapped reads of
        the whole batch, n_anc_local this shard's valid anchors before the
        merge."""
        p = self.p
        hhi, hlo, z, is_mini = sketch_batch(codes, lens, p.k, p.w)
        mh_hi, mh_lo, mz, mpos, mvalid = _compact_minimizers(hhi, hlo, z,
                                                             is_mini, p.M)
        rev, rid, rpos, qpos, span, av, _rep = _lookup_anchors(
            di, mh_hi, mh_lo, mz, mpos, mvalid, lens, p)
        n_anc_local = av.sum(dtype=torch.int32)
        if self.n_idx > 1:
            keys = torch.stack(anchor_keys(rev, rid, rpos, qpos, span, av))
            parts = self.all_gather(keys, self.idx_group)
            rev, rid, rpos, qpos, span, av = merge_anchors(parts, p.A)
        best, _ = _chain_scan(rev, rid, rpos, qpos, span, av, p)
        ext = _extend_best(di, codes, lens, best, p)
        b_sc, qs, qe, rs, re_, rv, rid_b = best
        n_mapped = self.all_reduce_sum((b_sc > 0).sum(dtype=torch.int32),
                                       self.data_group)
        out = dict(zip(OUT_FIELDS, (b_sc, ext, rid_b, rv, qs, qe, rs, re_)))
        return out, n_mapped, n_anc_local

    def gather_sharded(self, out: dict, n_anc: torch.Tensor):
        """Every rank's result gathered on every rank (the counterpart of
        multihost_utils.process_allgather): the (B,) planes of the whole
        batch (data rows in order, from each row's first rank) and the
        (n_data, n_idx) anchor counts."""
        planes = torch.stack([out[f].to(torch.int32) for f in OUT_FIELDS])
        every = self.all_gather(planes, None)
        rows = torch.cat([every[d * self.n_idx]
                          for d in range(self.n_data)], dim=1)
        counts = torch.stack(self.all_gather(
            n_anc.reshape(1).to(torch.int32), None))
        return (dict(zip(OUT_FIELDS, rows)),
                counts.reshape(self.n_data, self.n_idx))


def make_sharded_step(p: BatchParams, n_data: int,
                      n_idx: int) -> ShardedStep:
    """The sharded mapping step over the initialised default process
    group of n_data * n_idx ranks; see ShardedStep."""
    return ShardedStep(p, n_data, n_idx)
