"""Processes that split CanvasBin's BAM scan and share the host data.

The reference fans work out one process per chromosome on a single node
(CanvasRunner.GetIntermediateBinnedFilesByBamPath, CanvasRunner.cs:333-389,
sorting chromosomes longest-first so the long poles start first).  Here
each process of a torch.distributed group (gloo, over TCP) scans a
deterministic, size-balanced subset of the contigs, and the per-contig
host arrays are then all-gathered, so that every process holds the whole
genome: the replacement for the reference's per-chromosome
intermediate-file merge (CanvasBin.cs:965-1035).  The gathered data are
host arrays, so a group needs neither NCCL nor a card a process.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join (or, as process 0, create) a group of num_processes processes
    whose rendezvous is at coordinator_address ("HOST:PORT").

    Does nothing without a coordinator; a process count or id without
    one raises, so that a run asked for several processes never runs
    alone.  Returns (rank, world size): (0, 1) outside a group."""
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("--num-processes and --process-id need "
                             "--coordinator")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process id {process_id} outside "
                             f"[0, {num_processes})")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return rank(), world_size()


def rank() -> int:
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def contig_shards(
    contig_lengths: dict[str, int],
    n_shards: int,
    shard_id: int | None = None,
):
    """Deterministic size-balanced contig assignment.

    Longest-first greedy into the currently-lightest shard — the parallel
    analogue of the reference's longest-first job launch order
    (CanvasRunner.cs:343: OrderByDescending(chr.Length)).  Returns the
    shard_id's contig list, or all shards when shard_id is None."""
    order = sorted(contig_lengths, key=lambda c: (-contig_lengths[c], c))
    shards: list[list[str]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, dtype=np.int64)
    for contig in order:
        k = int(np.argmin(loads))
        shards[k].append(contig)
        loads[k] += contig_lengths[contig]
    if shard_id is None:
        return shards
    return shards[shard_id]


def my_contigs(contig_lengths: dict[str, int]) -> list[str]:
    """The current process's host-side contig subset."""
    return contig_shards(contig_lengths, world_size(), rank())


def all_gather_host_data(
    local: dict[str, np.ndarray],
    shapes: dict[str, tuple[int, np.dtype]] | None = None,
) -> dict[str, np.ndarray]:
    """Share per-contig host arrays across the processes of the group.

    One process: identity.  Several: every process walks the SAME sorted
    global contig list (all_gather is a collective: a process that skips
    one hangs the others), contributing zeros for contigs it did not scan;
    the owner's values survive an elementwise max (counts are non-negative
    and exactly one process owns each contig).  One gather a contig bounds
    the peak memory at n_processes x the largest contig.  A failed gather
    raises.

    shapes: contig -> (length, dtype) for ALL contigs, identical in every
    process; required with more than one process."""
    n = world_size()
    if n == 1:
        return dict(local)
    if shapes is None:
        raise ValueError(
            "all_gather_host_data needs the global contig shapes in "
            "multi-process mode")
    out: dict[str, np.ndarray] = {}
    for name in sorted(shapes):
        length, dtype = shapes[name]
        arr = local.get(name)
        buf = (np.zeros(length, dtype) if arr is None
               else np.ascontiguousarray(arr, dtype))
        if buf.shape != (length,):
            raise ValueError(f"{name}: local array of shape {buf.shape}, "
                             f"the global shape is ({length},)")
        # gloo gathers a few dtypes only: the bytes cross, the max is
        # taken in the contig's own dtype.  The gather only reads `mine`,
        # so a read-only buffer is not copied.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            mine = torch.from_numpy(buf.view(np.uint8))
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine)
        acc = parts[0].numpy().view(buf.dtype)
        for part in parts[1:]:
            np.maximum(acc, part.numpy().view(buf.dtype), out=acc)
        out[name] = acc
    return out
