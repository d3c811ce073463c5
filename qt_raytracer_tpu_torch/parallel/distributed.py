"""Multi-process execution helpers (counterpart of
``qt_raytracer_tpu.parallel.distributed``).

One process (rank) per device. ``initialize`` joins this process to a
``torch.distributed`` process group and binds it to its device; the
(sp, px) mesh of ``parallel.sharding`` then covers every rank, and
``render_linear_sharded`` and the train steps' ``mesh=`` run across them.

Launch N ranks on N cards with ``torchrun --nproc-per-node=N script.py``,
the script calling ``initialize()`` with no arguments; or pass the
coordinator's address, the number of processes and this process's id. The
backend is NCCL for ranks on cards and gloo for ranks on the CPU; two ranks
on one card need ``backend="gloo"``, as NCCL refuses two ranks on one GPU.
Nothing switches backend or device unless asked.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.device import resolve_device
from .sharding import make_mesh

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join this process to the process group; returns its device.

    With the three first arguments None, the torchrun variables name the
    group (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).
    Otherwise pass all three; coordinator_address is "host:port" or a URL
    that ``init_process_group`` takes ("tcp://...", "file://..."), and the
    local rank is process_id. device None is a CUDA card, cuda:(local rank
    % #cards) (raises without CUDA); "cpu" asks for the CPU. backend None is
    "nccl" on a card and "gloo" on the CPU. A rank that does not arrive, or
    a collective that does not complete, fails after ``timeout``.
    """
    given = (coordinator_address, num_processes, process_id)
    if all(a is None for a in given):
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    elif any(a is None for a in given):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together, or none of them")
    else:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        rank, world, local_rank = process_id, num_processes, process_id
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None
                               or torch.device(device).index is None):
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    if rank == 0:
        print(f"torch.distributed: backend {backend}, {world} ranks, rank 0 "
              f"on {dev}", flush=True)
    return dev


# The JAX package's name for the mesh over every rank of every process.
# Ranks are laid out row major, so a px row is ranks with consecutive ids:
# under torchrun, those of one host while px divides the cards per host.
global_mesh = make_mesh


def gather_image(image: torch.Tensor) -> np.ndarray:
    """The image of a sharded render on this rank's host, as numpy.
    render_linear_sharded already hands every rank the whole image (its
    all-reduce assembles it), so this is a copy to the host."""
    return image.detach().cpu().numpy()


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
