"""Multi-shard and multi-process counting for khmer_tpu_torch.

Port of khmer_tpu/parallel: a Mesh of shards with
  * a "data" axis: read chunks stream data-parallel, each shard
    consuming its own (the analogue of `-T` threads feeding one sketch,
    reference oxli/functions.py:42-66), and
  * a "shard" axis: the hash space is split into bands, each shard
    owning one band's k-mers (the analogue of consume_seqfile_banding,
    reference include/oxli/hashtable.hh:302-344), with k-mers routed to
    their owners by an all_to_all (parallel/comm.py).

The shards of a mesh may share a card, lie on several cards, or on
several processes joined by torch.distributed.  Merging the partial
tables is a plain sum (equal to the serial table: saturating increments
commute, see parallel/sharded.py), and count queries sum each table's
bins over the mesh before the min over tables, the serial Count-Min read
bit for bit.
"""

from khmer_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedDeferredConsumer,
    band_owner,
    make_mesh,
    make_sharded_query,
    merge_tables_saturating,
)
from khmer_tpu_torch.parallel.multihost import (  # noqa: F401
    distributed_count,
    initialize,
    shard_files_for_host,
)
