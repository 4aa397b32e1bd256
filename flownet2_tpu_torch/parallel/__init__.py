"""Data and spatial parallel over several devices: one process a rank,
gradients all-reduced by ``DistributedDataParallel``, the height split in
row bands whose halos the ranks exchange (the counterpart of
flownet2_tpu/parallel)."""

from .halo import gather_rows, halo_rows, mean_over_bands  # noqa: F401
from .mesh import (  # noqa: F401
    ENV_VARS,
    DataParallelPlan,
    all_gather_batch,
    all_reduce_sum,
    barrier,
    data_ranks,
    init_distributed,
    is_distributed,
    local_rank,
    rank,
    sum_over_ranks,
    world_size,
)
