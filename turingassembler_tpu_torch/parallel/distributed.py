"""Multi-process runtime (port of turingassembler_tpu/parallel/distributed.py,
on torch.distributed).

Every rank runs the same command on the same shared output directory
(the CLI's --dist-coordinator / --dist-nproc / --dist-pid, or torchrun's
environment).  The control group is Gloo: its barriers need no device,
and two ranks may share one GPU under it (NCCL refuses that).  The
cross-process k-mer exchange of parallel/sharded_count.py rides a group
of its own (parallel/mesh.py).

With no launcher, nothing is initialised and everything runs as one
process of one rank.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..logging_utils import get_logger

# how long a rank waits at a barrier for the others: rank 0 runs the
# graph passes, the sort and the scaffolding alone while the others wait
BARRIER_TIMEOUT = datetime.timedelta(hours=3)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the process group of a multi-process run; a no-op for a
    single-process run or when this process has joined already.

    Resolution order, as the JAX package's: explicit arguments, then
    torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK (as the JAX
    one falls back to JAX_COORDINATOR_ADDRESS), then nothing."""
    env = os.environ
    if coordinator is None and num_processes is None and process_id is None:
        if not all(v in env for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if dist.is_initialized():
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator's host:port, the "
            "number of processes and this process's id "
            f"(got {coordinator!r}, {num_processes!r}, {process_id!r})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=BARRIER_TIMEOUT)
    get_logger().info("distributed: process %d / %d (gloo, %s)",
                      dist.get_rank(), dist.get_world_size(), coordinator)


def dist_info() -> Tuple[int, int]:
    """(rank, number of processes); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier(tag: str) -> None:
    """Wait for every rank at the barrier named `tag`; raises when the
    ranks reached barriers of different names (their stage streams
    went apart)."""
    rank, n = dist_info()
    if n == 1:
        return
    tags: List[Optional[str]] = [None] * n
    dist.all_gather_object(tags, tag)
    if any(t != tag for t in tags):
        raise RuntimeError(f"rank {rank} at barrier {tag!r}, the ranks at "
                           f"{tags}")


def shard_files_for_process(files: Sequence[str]) -> List[str]:
    """Static round-robin assignment of input files to this process."""
    pid, n = dist_info()
    return [f for i, f in enumerate(files) if i % n == pid]


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: `cuda` with no index names
    cuda:{rank % visible GPUs} in a multi-process run (two ranks share a
    card when there are fewer cards than ranks); any other device is
    kept as given."""
    dev = torch.device(device)
    rank, n = dist_info()
    if dev.type == "cuda" and dev.index is None and n > 1:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def global_read_batch(bases: np.ndarray, lengths: np.ndarray, mesh):
    """This process's rows of a global read batch (rows
    [rank * n, (rank + 1) * n) of it), split evenly over this process's
    shards of `mesh` and put on their devices: (bases, lengths), one
    tensor a local shard each (the counterpart of the JAX package's
    make_array_from_process_local_data placement)."""
    n = len(bases)
    if n % mesh.n_local:
        raise ValueError(f"{n} rows do not split over {mesh.n_local} shards")
    b = n // mesh.n_local
    bases = np.ascontiguousarray(bases, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    return ([torch.as_tensor(bases[i * b:(i + 1) * b]).to(d)
             for i, d in enumerate(mesh.devices)],
            [torch.as_tensor(lengths[i * b:(i + 1) * b]).to(d)
             for i, d in enumerate(mesh.devices)])
