"""Shard meshes (port of turingassembler_tpu/parallel/mesh.py).

A shard is a logical partition: of the canonical k-mer space in the
sharded count, of the read rows in the sharded map.  Each shard lives on
a torch device, and one device may hold several shards, so one card can
run four shards for real (routing, exchange and per-shard counts).  The
`size` shards of a mesh are spread evenly over the processes: process r
holds shards [r * n_local, (r + 1) * n_local).

The all-to-all exchange of a mesh is a block transpose of the shards'
(size, cap, ...) send buffers within a process and
`torch.distributed.all_to_all_single` across processes: over the Gloo
control group for shards on the CPU, over an NCCL group of its own for
shards on GPUs.  NCCL needs one GPU a rank, so a mesh whose ranks would
share a GPU raises; it never drops to Gloo or to the CPU by itself.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import dist_info, rank_device


@dataclass(frozen=True)
class Mesh:
    devices: tuple          # torch device of each of this process's shards
    size: int               # shards over all processes
    rank: int = 0
    world: int = 1
    group: object = None    # exchange group across processes (world > 1)

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.n_local

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """`t` on each local shard's device, one copy a device."""
        copies: Dict[torch.device, torch.Tensor] = {}
        return [copies.setdefault(d, t.to(d)) for d in self.devices]

    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """blocks[s]: local shard s's send buffer, (size, cap, ...), block
        d bound for global shard d.  Returns recv[s], (size, cap, ...) on
        local shard s's device: block j is what global shard j sent to
        this shard."""
        L, S = self.n_local, self.size
        if self.world == 1:
            return [torch.stack([blocks[j][s].to(self.devices[s])
                                 for j in range(S)]) for s in range(L)]
        xdev = self.devices[0] if self.devices[0].type == "cuda" \
            else torch.device("cpu")
        is_bool = blocks[0].dtype == torch.bool
        send = torch.stack([b.to(xdev) for b in blocks])
        if is_bool:
            send = send.to(torch.uint8)
        tail = send.shape[2:]
        # (L_src, world, L_dst, ...) -> (world, L_src, L_dst, ...): the
        # chunk bound for rank r is the r-th along dim 0
        send = send.reshape(L, self.world, L, *tail).transpose(0, 1) \
            .contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        if is_bool:
            recv = recv.bool()
        # recv[r, j, s]: rank r's shard j to this rank's shard s
        return [recv[:, :, s].reshape(S, *tail).to(self.devices[s])
                for s in range(L)]

    def psum(self, x: int) -> int:
        """Sum of an integer over the processes (the control group)."""
        if self.world == 1:
            return int(x)
        t = torch.tensor([int(x)], dtype=torch.int64)
        dist.all_reduce(t)
        return int(t.item())

    def gather(self, obj) -> list:
        """Every process's `obj`, in rank order."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def check_nccl_devices(keys: Sequence[tuple]) -> None:
    """keys[r]: rank r's (host, GPU indices of its shards).  Raises when
    two ranks hold shards on the same GPU of one host, which NCCL
    refuses."""
    owner: Dict[tuple, int] = {}
    for r, (host, idxs) in enumerate(keys):
        for i in sorted(set(idxs)):
            if (host, i) in owner:
                raise RuntimeError(
                    f"ranks {owner[host, i]} and {r} both hold shards on "
                    f"cuda:{i} of {host}: the NCCL exchange of a "
                    "cross-process mesh needs one GPU a rank (run one "
                    "rank a GPU, or the shards in one process)")
            owner[host, i] = r


def make_mesh(n_shards: Optional[int] = None, devices=None) -> Mesh:
    """The mesh of `n_shards` shards over all processes (default: one a
    device), this process's share of them placed round-robin on
    `devices` (a device or a list; default every visible GPU in a
    single process, this rank's GPU in a multi-process run)."""
    rank, world = dist_info()
    if devices is None:
        if world == 1:
            n_gpu = torch.cuda.device_count()
            devices = [f"cuda:{i}" for i in range(n_gpu)] or ["cuda"]
        else:
            devices = [rank_device("cuda")]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    if len({torch.device(d).type for d in devices}) > 1:
        raise ValueError("a process's shards must all be on the CPU or "
                         "all on GPUs")
    devices = [resolve_device(d) for d in devices]
    if n_shards is None:
        n_shards = len(devices) * world
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split over {world} "
                         "processes")
    n_local = n_shards // world
    placed = tuple(devices[i % len(devices)] for i in range(n_local))
    group = None
    if world > 1 and placed[0].type == "cuda":
        idxs = [d.index if d.index is not None
                else torch.cuda.current_device() for d in placed]
        keys = [None] * world
        dist.all_gather_object(keys, (socket.gethostname(), idxs))
        check_nccl_devices(keys)
        if len(set(idxs)) > 1:
            raise ValueError("a rank's GPU shards must share one GPU")
        group = dist.new_group(backend="nccl")
    return Mesh(placed, n_shards, rank, world, group)
