"""de Bruijn graph tables: Countgraph and Nodegraph.

Port of khmer_tpu/graph.py:595-619 without the tag, traversal and
partition layers, which later slices bring.
"""

from khmer_tpu_torch.hashtable import Hashtable
from khmer_tpu_torch.storage import BitStorage, ByteStorage


class Countgraph(Hashtable):
    """8-bit counting de Bruijn graph (2-bit exact hash, k <= 32)."""

    storage_class = ByteStorage


class Nodegraph(Hashtable):
    """Presence/absence (Bloom) de Bruijn graph."""

    storage_class = BitStorage
