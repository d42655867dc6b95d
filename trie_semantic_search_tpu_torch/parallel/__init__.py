"""Device meshes and sharded search.

Port of ``trie_semantic_search_tpu/parallel``: a mesh is a grid of
``torch.device`` (:mod:`.mesh`), the corpus a list of row blocks on it, and
the sharded steps run each shard's stage on its device and merge the
shard-local top-k lists on the first one (:mod:`.collectives`). A mesh may
span processes (``make_distributed_mesh``): each process runs its own
shards and the lists meet in an ``all_gather``. ``batch_sharding`` splits
a training batch over the data axis (``models.train.make_sharded_train_step``).
"""

from .collectives import sharded_brute_topk, sharded_int8_topk
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    make_distributed_mesh,
    make_mesh,
    pad_corpus,
    pad_rows,
    replicate,
    shard_rows,
    single_device_mesh,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "batch_sharding",
    "make_distributed_mesh",
    "make_mesh",
    "pad_corpus",
    "pad_rows",
    "replicate",
    "shard_rows",
    "sharded_brute_topk",
    "sharded_int8_topk",
    "single_device_mesh",
]
