"""Process groups and collectives over `torch.distributed` — the port of
deepspeed_tpu/comm/ (the data axis; comm/mesh.py, comm/dist.py)."""

from .mesh import (  # noqa: F401
    AXIS_ORDER,
    DATA_AXIS,
    DATA_INNER_AXIS,
    DATA_OUTER_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    MeshInfo,
    derive_data_outer,
    get_current_mesh,
    largest_divisible_axis,
    make_mesh,
    set_current_mesh,
)
from . import dist  # noqa: F401
from .dist import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    ppermute,
    reduce_scatter,
)
