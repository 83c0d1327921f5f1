"""The multi-rank layer (port of gomavatar_tpu/parallel/): one process per
rank over ``torch.distributed`` (NCCL on CUDA, gloo on the CPU), whose
steps run as the rank's programs (``programs.RankProgram``)."""

from gomavatar_tpu_torch.parallel.mesh import (
    RankGroup,
    all_gather_cat,
    all_reduce_sum,
    barrier,
    close_group,
    default_backend,
    init_group,
    spawn,
)
from gomavatar_tpu_torch.parallel.step import (
    make_data_parallel_program,
    make_data_parallel_train_step,
    make_mean_gradient_step,
    make_multi_scene_render,
    rank_items,
    render_in_turn,
)
from gomavatar_tpu_torch.parallel.tile_render import make_tile_parallel_render, shard_slots
