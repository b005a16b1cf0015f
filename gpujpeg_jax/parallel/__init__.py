"""Multi-device / multi-host parallelism for the JPEG engine.

The reference is single-process, single-GPU per coder (SURVEY §2.3); this
package is the new first-class distribution layer: band/segment sharding of
one image over a mesh, frame sharding for video batches.
"""
from .multihost import (
    MultiHostDecoder,
    MultiHostEncoder,
    MultiHostSingleImageEncoder,
    global_mesh,
    init_distributed,
)
from .sharded import (
    ShardedDecoder,
    BandLayout,
    ShardedEncoder,
    choose_restart_interval,
    plan_bands,
    split_raw_bands,
)

__all__ = [
    "BandLayout",
    "MultiHostDecoder",
    "MultiHostEncoder",
    "MultiHostSingleImageEncoder",
    "global_mesh",
    "init_distributed",
    "ShardedDecoder",
    "ShardedEncoder",
    "choose_restart_interval",
    "plan_bands",
    "split_raw_bands",
]
