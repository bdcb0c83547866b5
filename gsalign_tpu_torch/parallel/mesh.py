"""The device mesh: seed lanes and DP problems split over devices.

The reference has no distributed code (pthreads + one mutex,
src/GSAlign.cpp:8,492-526); the JAX package (parallel/mesh.py) adds one mesh
axis, "frag", over which the two batched device stages split: the seed scan's
lanes (query chunks) and the DP's problems, each device running the same
kernels on its own contiguous stripe while the FM-index tables stay whole on
every device. Stripes join in mesh order, which is lane (or submit) order,
and the global (PosDiff, qPos) sort restores the seed order, so outputs are
byte-identical for any number of entries.

A mesh entry is a torch device and, on a card, a CUDA stream of its own.
On a host with several cards the entries are the cards; on one card a mesh
of n entries is the card n times, a stream each, so that the stripes of a
round run side by side on it; on the CPU, n entries of "cpu" (the tests'
mesh, as the JAX package's 8 virtual CPU devices). Every stripe of a round
is launched before any is read back.

Beyond one device's memory the JAX package also cuts the two big tables'
rows over the mesh (shard_index_rows): t3 and sa_samples in equal row
blocks, one an entry, the other tables whole. Lanes are then not split: one
scan on the first entry reads each row from the block that holds it
(ops/rank.RowShards; the kernels' ShardedTable instances in csrc/seed.cu).
Blocks on other cards are read through peer access, which must be possible
between the cards (torch.cuda.can_device_access_peer); nothing is copied.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gsalign_tpu_torch.ops.rank import DeviceFMIndex, RowShards

FRAG_AXIS = "frag"
# the tables whose rows shard_index_rows cuts (the JAX package's): the
# order-3 rank rows and the sampled suffix array
ROW_SHARD_FIELDS = ("t3", "sa_samples")


def indexed_device(dev) -> torch.device:
    """A torch device in indexed form: cuda:<n>, never a bare cuda (the
    table cache of DeviceFMIndex.from_host is keyed by the device's name)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The ordered entries of the "frag" axis: `devices` (indexed torch
    devices, repeats allowed) and, for an entry on a card, a CUDA stream of
    its own, made here, so that threads sharing the mesh share its
    streams."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(indexed_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.streams = tuple(torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"

    @contextlib.contextmanager
    def on(self, i: int, shared: bool = False):
        """Run the block on entry i: its device current, its stream the
        current one, after the work already queued on the device's current
        stream (where the tables and the query rows were made). shared: the
        stream of the first entry on the same device instead of entry i's,
        so that the launches of every entry on one card run in turn."""
        dev = self.devices[i]
        if dev.type != "cuda":
            yield
            return
        if shared:
            i = self.devices.index(dev)
        s = self.streams[i]
        with torch.cuda.device(dev):
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                yield


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices`; every visible CUDA card for None (as the JAX
    package takes jax.devices())."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def local_mesh(device) -> Optional[Mesh]:
    """The mesh a run on `device` uses by default: every card, where the
    device is a card and more than one is visible (the JAX CLI's
    len(jax.local_devices()) > 1); else None."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def stripes(arr: np.ndarray, n: int, pad_value) -> list:
    """arr padded along axis 0 to a multiple of n (at least n rows) with
    pad_value, cut into n contiguous stripes of equal length."""
    want = pad_to_multiple(max(arr.shape[0], 1), n)
    if want != arr.shape[0]:
        pad = np.full((want - arr.shape[0],) + arr.shape[1:], pad_value,
                      dtype=arr.dtype)
        arr = np.concatenate([arr, pad], axis=0)
    return np.split(arr, n)


def shard_lanes(arr: np.ndarray, mesh: Mesh, pad_value) -> list:
    """P("frag"): arr padded to a multiple of the mesh size and cut into
    contiguous stripes, stripe i uploaded to entry i's device on its
    stream."""
    out = []
    for i, part in enumerate(stripes(arr, mesh.size, pad_value)):
        with mesh.on(i):
            out.append(torch.from_numpy(np.ascontiguousarray(part))
                       .to(mesh.devices[i]))
    return out


def shard_index(dfm: DeviceFMIndex, mesh: Mesh, fm=None) -> dict:
    """{device: the index's tables on it} for every distinct device of the
    mesh: dfm on its own device, on any other the tables of the host index
    fm (the FMIndex dfm was laid out from) through DeviceFMIndex.from_host,
    one layout per device, never one per entry."""
    tables = {dfm.device: dfm}
    for dev in mesh.devices:
        if dev not in tables:
            if fm is None:
                raise ValueError(f"the mesh has {dev} beside {dfm.device}: "
                                 f"pass the host index (fm=) to lay the "
                                 f"tables out there")
            tables[dev] = DeviceFMIndex.from_host(fm, dev)
    return tables


def shard_index_rows(dfm: DeviceFMIndex, mesh: Mesh) -> DeviceFMIndex:
    """Beyond one device's memory: the rows of t3 and sa_samples cut into
    mesh.size equal blocks (zero-padded to a multiple), block i on entry i's
    device; every other table whole on the first entry's device; host_sa
    kept. A table of one row is not cut. The result runs the seed scan and
    resolve_sa on the first entry with the lanes whole; its t3 and
    sa_samples fields hold no rows (ops/rank.RowShards)."""
    if dfm.row_shards is not None:
        raise ValueError("the index is row-sharded already")
    first = mesh.devices[0]
    if dfm.device != first:
        raise ValueError(f"the index is on {dfm.device}, not on the mesh's "
                         f"first entry {first}")
    for dev in mesh.devices[1:]:
        if dev != first and not (
                dev.type == first.type == "cuda"
                and torch.cuda.can_device_access_peer(first, dev)):
            raise ValueError(f"{first} cannot read a row block on {dev}: "
                             f"peer access between them is not possible")
    shards, updates = {}, {}
    for f in ROW_SHARD_FIELDS:
        a = getattr(dfm, f)
        if a.shape[0] <= 1:
            continue
        rows = pad_to_multiple(a.shape[0], mesh.size) // mesh.size
        blocks = []
        for i, dev in enumerate(mesh.devices):
            blk = a[i * rows:(i + 1) * rows]
            if blk.shape[0] < rows:
                blk = torch.cat([blk, blk.new_zeros(
                    (rows - blk.shape[0],) + tuple(a.shape[1:]))])
            blocks.append(blk.to(dev))
        shards[f] = RowShards(blocks=tuple(blocks), rows=rows)
        updates[f] = a[:0]
    return dataclasses.replace(dfm, row_shards=shards, **updates)
