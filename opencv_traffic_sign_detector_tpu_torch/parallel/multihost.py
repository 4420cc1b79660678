"""Multi-process input feeding: each rank decodes a disjoint slice of the
frames and feeds its own shards.

Counterpart of ``opencv_traffic_sign_detector_tpu/parallel/multihost.py``.
Scaling the frame stream past one process needs each process to decode a
*disjoint* slice of the dataset and feed only the shards it owns; the
process group carries nothing but collectives (:func:`.mesh.psum`).

* :func:`initialize_distributed`: ``torch.distributed.init_process_group``
  from explicit arguments or the launcher's variables (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), NCCL for
  cards and gloo for the CPU; with no coordinator a no-op, so one CLI
  serves one process and many.
* :func:`host_shard_files`: the reference's deterministic disjoint
  partition of the file list, every rank padded to the same number of
  batches (each rank runs the same sequence of collectives), pad slots
  named ``"__pad__"`` so collectors drop them as they drop the tail pad
  (``data/prefetch.py``).
* :func:`multihost_batched_frames`: per-rank decode-ahead
  (``data.prefetch.batched_frames``), each local batch split over the
  rank's shards.

The reference assembles a global array from each host's part
(``global_batch_from_local``); there is no counterpart here, because a
rank's batch *is* its part: each rank feeds its own shards, results are
collected per rank, and only reductions cross ranks.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import shard_batch


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, device="cuda") -> bool:
    """Join the process group of a multi-process run; True if joined.

    ``init_method`` defaults to ``tcp://MASTER_ADDR:MASTER_PORT`` from the
    environment, ``world_size`` and ``rank`` to ``WORLD_SIZE`` and
    ``RANK``; with no coordinator this is a no-op (one process), so callers
    can call it unconditionally.  A card-backed group (NCCL) makes card
    ``LOCAL_RANK`` this process's current card.
    """
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if not addr:
            return False
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _rank_and_world(process_index, process_count) -> tuple[int, int]:
    joined = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if joined else 0
    if process_count is None:
        process_count = dist.get_world_size() if joined else 1
    return process_index, process_count


def host_shard_files(
    files: list[str],
    batch_size: int,
    process_index: int | None = None,
    process_count: int | None = None,
) -> list[str]:
    """This rank's disjoint slice of ``files``, padded to equal batch count.

    ``batch_size`` is the *per-rank* (local) batch size.  The split is
    contiguous (rank 0 takes the first ceil(N/P) files, ...) so each rank's
    decode stream stays sequential on disk; every rank is padded (repeating
    its last file, or file 0 for an empty tail shard) to the globally
    maximal shard length rounded up to a full batch, guaranteeing all ranks
    yield the same number of batches.  Rank and count default to the
    process group's (0 and 1 without one).
    """
    process_index, process_count = _rank_and_world(process_index, process_count)
    per = -(-len(files) // process_count)  # ceil
    shard = files[process_index * per : (process_index + 1) * per]
    target = -(-per // batch_size) * batch_size
    filler = shard[-1] if shard else files[0]
    return shard + [filler] * (target - len(shard))


def multihost_batched_frames(
    directory: str,
    files: list[str],
    local_batch_size: int,
    mesh,
    prefetch: int = 2,
    process_index: int | None = None,
    process_count: int | None = None,
):
    """Yield (shards, local_names) for this rank's slice of ``files``.

    ``shards`` is the rank's decoded batch split over its shards
    (:func:`.mesh.shard_batch`); ``local_names`` names the batch's slots,
    pad slots ``"__pad__"``.  Results are collected per rank: each rank
    scores or writes the detections of its own slots, and a final
    :func:`.mesh.psum` merges counts.
    """
    from ..data.prefetch import batched_frames

    process_index, process_count = _rank_and_world(process_index, process_count)
    shard = host_shard_files(files, local_batch_size, process_index, process_count)
    per = -(-len(files) // process_count)
    n_real = max(0, min(per, len(files) - process_index * per))
    done = 0
    for frames, names in batched_frames(directory, shard, local_batch_size, prefetch=prefetch):
        # rank-level pad slots decode a repeated real file; rename them so
        # collectors drop their results like the single-process tail pad
        names = [n if done + i < n_real else "__pad__" for i, n in enumerate(names)]
        done += len(names)
        yield shard_batch(mesh, frames), names
