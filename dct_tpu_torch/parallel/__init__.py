"""Data- and model-parallel training over ``torch.distributed``
(``dct_tpu/parallel/``): the mesh of ranks and its placements, the
collectives, the data-parallel share of a step, the model-parallel
co-training step (``shard_cotrain``) and overlap-tile eval (``spatial``)."""
from .mesh import (  # noqa: F401
    Mesh,
    choose_parallel_mesh,
    data_parallel_mesh,
    dp_shard_idx,
    init_distributed,
    make_mesh,
    place_batches,
    place_replicated,
    place_stacked_state,
)
from .spatial import make_spatial_eval  # noqa: F401
