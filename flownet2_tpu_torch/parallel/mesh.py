"""Data parallel over processes: the counterpart of the ``data`` axis of
flownet2_tpu/parallel/mesh.py.

Where the JAX package shards the batch over a device mesh and lets XLA
insert the gradient all-reduce, the port runs one process a rank and one
device a rank: every rank holds the whole model, reads its stripe of each
global batch (``data.loader.DataLoader`` with ``process_count`` and
``process_index``), and ``train.state.StepFactory(plan=...)`` wraps the
model in ``DistributedDataParallel``, whose backward all-reduces the
gradients (NCCL on CUDA devices, gloo on the CPU).

``init_distributed`` starts the process group (explicit arguments, else
torchrun's environment), ``DataParallelPlan.current()`` describes this
rank, ``data_ranks`` is the JAX command line's choice of the data-axis
size, and ``barrier``, ``all_reduce_sum`` and ``all_gather_batch`` are the
collectives the rest of the package needs, each a no-op in a process
without a group; ``sum_over_ranks`` is the differentiable sum that global
BatchNorm takes its statistics by.

Row bands across ranks (the ``spatial`` axis): a plan with ``spatial`` S > 1
lays the ranks out as the JAX mesh reshapes its devices, ``(world / S,
S)`` with the spatial axis innermost: rank ``r`` is data rank ``r // S``
and holds band ``r % S`` of the height, rows ``[b * H / S, (b + 1) * H /
S)`` of its data rank's stripe.  ``DataParallelPlan.current(spatial=S)``
builds one process group over the S bands of each data rank and one over
the data ranks of each band (``dist.new_group``, in one order on every
rank); the steps cut their band (``band_rows``) and run the model under
``band_context()``, whose ops exchange their halos over the band's group
(``parallel/halo.py``).  Gradients, BatchNorm's statistics and the
metrics are still summed over every rank, data and spatial: with equal
bands each rank's loss is one (D * S)-th of the global batch's.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

# torchrun's variables: this process's rank, the number of ranks, the rank
# on this host (its device) and the rendezvous address
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """Whether this process is a rank of a running process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    """This rank's index among the ranks of its host: ``LOCAL_RANK`` where
    it is set, else the rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def init_distributed(backend: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> bool:
    """Start this process's rank of the default process group.

    Explicit ``world_size`` and ``rank`` win (``init_method`` then defaults
    to ``env://``, which reads ``MASTER_ADDR`` and ``MASTER_PORT``);
    otherwise torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` are read.  Some of them set and
    others not raises, naming the missing ones; none set returns False and
    starts nothing.  ``backend`` None is ``nccl`` where CUDA is available,
    else ``gloo``.  Under ``nccl`` the rank's device, ``cuda:LOCAL_RANK``,
    is made current before anything is allocated on it and bound to the
    group.  A group that cannot start raises.  Returns True once the group
    runs."""
    if world_size is None and rank is None:
        present = [v for v in ENV_VARS if v in os.environ]
        if not present:
            return False
        missing = [v for v in ENV_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"{', '.join(present)} set but distributed start-up also "
                f"needs {', '.join(missing)}: set all of {', '.join(ENV_VARS)}"
                " (as torchrun does) or none")
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = init_method or "env://"
    elif world_size is None or rank is None:
        raise ValueError("init_distributed: give both world_size and rank, "
                         "or neither")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=timeout or datetime.timedelta(minutes=10),
        **kwargs)
    return True


def data_ranks(batch_size: int, n_devices: int, spatial: int = 1) -> int:
    """The data-axis size of the JAX command line (flownet2_tpu/cli/main.py):
    the largest divisor of ``batch_size`` that ``n_devices // spatial``
    allows."""
    return max(d for d in range(1, max(n_devices // spatial, 1) + 1)
               if batch_size % d == 0)


def _new_groups(world: int, spatial: int, timeout=None):
    """(the band group of each data rank, the data group of each band),
    created in one order on every rank, as ``dist.new_group`` requires."""
    n_data = world // spatial
    bands = [dist.new_group([d * spatial + s for s in range(spatial)],
                            timeout=timeout) for d in range(n_data)]
    datas = ([dist.new_group([d * spatial + s for d in range(n_data)],
                             timeout=timeout) for s in range(spatial)]
             if n_data > 1 else [None] * spatial)
    return bands, datas


@dataclasses.dataclass(frozen=True)
class DataParallelPlan:
    """This rank's place in the parallel run: the counterpart of
    ``MeshPlan``.  Parameters are replicated on every rank's ``device``,
    the batch is split in data-rank order and, with ``spatial`` > 1, the
    height in ``spatial`` bands; the gradients are all-reduced over every
    rank.  ``spatial_group`` joins this rank's data rank's bands and
    ``data_group`` this band's data ranks (None where they would hold one
    rank)."""
    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    spatial: int = 1
    spatial_group: Any = dataclasses.field(default=None, compare=False,
                                           repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)

    def __post_init__(self):
        if self.spatial < 1 or self.world_size % self.spatial:
            raise ValueError(f"{self.world_size} ranks do not divide into "
                             f"row bands of spatial={self.spatial}")

    @classmethod
    def current(cls, device=None, spatial: int = 1,
                timeout=None) -> "DataParallelPlan":
        """The plan of this process in the running default group; its
        device is ``device``, else ``cuda:LOCAL_RANK`` under ``nccl`` and
        the CPU under any other backend.  With ``spatial`` > 1 the ranks
        are laid out (world / spatial, spatial) and the groups of the bands
        and of the data ranks are created (every rank must call this alike;
        ``timeout`` is theirs).  Raises without a group."""
        if not is_distributed():
            raise RuntimeError("no process group: call init_distributed "
                               "first")
        if device is None:
            device = (torch.device("cuda", local_rank())
                      if dist.get_backend() == "nccl"
                      else torch.device("cpu"))
        plan = cls(world_size(), rank(), local_rank(), torch.device(device),
                   spatial)
        if spatial == 1:
            return plan
        bands, datas = _new_groups(plan.world_size, spatial, timeout)
        return dataclasses.replace(plan, spatial_group=bands[plan.data_rank],
                                   data_group=datas[plan.band])

    @property
    def data_size(self) -> int:
        """The number of data ranks: the batch's stripes."""
        return self.world_size // self.spatial

    @property
    def data_rank(self) -> int:
        """This rank's stripe of the batch."""
        return self.rank // self.spatial

    @property
    def band(self) -> int:
        """This rank's band of the height."""
        return self.rank % self.spatial

    def local_batch_size(self, global_batch: int) -> int:
        if global_batch % self.data_size:
            raise ValueError(f"a global batch of {global_batch} does not "
                             f"divide over {self.data_size} ranks")
        return global_batch // self.data_size

    def valid_in_stripe(self, n_valid: int, local_batch: int) -> int:
        """How many of this rank's ``local_batch`` samples are real, of a
        global batch whose first ``n_valid`` are (the rest pad it)."""
        return min(max(n_valid - self.data_rank * local_batch, 0),
                   local_batch)

    def band_rows(self, height: int) -> slice:
        """This rank's rows of a stripe ``height`` rows high; raises
        ``ValueError`` unless height / spatial is a multiple of 64."""
        from ..ops.sharding_hints import check_band_height

        rows = check_band_height(height, self.spatial)
        return slice(self.band * rows, (self.band + 1) * rows)

    def band_context(self):
        """The context the model's ops run in on this rank: this band over
        ``spatial_group``, or the whole map where ``spatial`` is 1."""
        from ..ops.sharding_hints import Band, scoped_band

        return scoped_band(Band(self.spatial_group, self.spatial, self.band)
                           if self.spatial > 1 else None)


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if is_distributed():
        dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (``t`` itself without a
    group)."""
    if is_distributed():
        dist.all_reduce(t)
    return t


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably: every rank's loss
    depends on every rank's ``t``, so the backward sums the gradient over
    the ranks too.  Needs a running group."""
    return _SumOverRanks.apply(t)


def all_gather_batch(t: torch.Tensor,
                     plan: Optional[DataParallelPlan] = None) -> torch.Tensor:
    """Every rank's ``t`` (one stripe of a batch) concatenated on the first
    axis in rank order: the global batch (``t`` itself without a group).
    Under a plan with row bands, ``t`` is this rank's band of its stripe,
    NHWC: the bands are gathered first along the height (axis 1), then
    the stripes."""
    if not is_distributed() or world_size() == 1:
        return t
    from .halo import all_gather_list

    if plan is not None and plan.spatial > 1:
        t = torch.cat(all_gather_list(t, plan.spatial, plan.band,
                                      plan.spatial_group), dim=1)
        if plan.data_size == 1:
            return t
        return torch.cat(all_gather_list(t, plan.data_size, plan.data_rank,
                                         plan.data_group))
    return torch.cat(all_gather_list(t, world_size(), rank(), None))
