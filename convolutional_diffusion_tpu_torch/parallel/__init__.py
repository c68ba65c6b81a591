"""Multi-device machinery over `torch.distributed`: process groups laid out
as meshes, dataset-sharded score machines. Counterpart of
`convolutional_diffusion_tpu/parallel/`."""

from .mesh import (
    Mesh,
    data_spec,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    spawn,
)
from .sharded_score import (
    ShardedIdealScoreModule,
    ShardedLocalEquivBordersScoreModule,
    ShardedLocalEquivScoreModule,
    ShardedLocalScoreModule,
    merge_collective,
    shard_dataset,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "data_spec",
    "shard_batch",
    "replicate",
    "spawn",
    "ShardedIdealScoreModule",
    "ShardedLocalScoreModule",
    "ShardedLocalEquivScoreModule",
    "ShardedLocalEquivBordersScoreModule",
    "merge_collective",
    "shard_dataset",
]
