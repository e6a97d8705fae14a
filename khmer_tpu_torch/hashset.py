"""HashSet of k-mer hashes (parity: khmer/_oxli/hashset.pyx); a copy of
khmer_tpu/hashset.py.

A thin ordered-set wrapper over python ints; used for tags, stop tags and
sweep results.  Device-side bulk membership tests live on the graph layer.
"""


class HashSet:
    def __init__(self, ksize, obj=None):
        self.ksize = ksize
        self.hashes = set()
        if obj is not None:
            self.hashes.update(int(h) for h in obj)

    def __len__(self):
        return len(self.hashes)

    def __iter__(self):
        return iter(sorted(self.hashes))

    def __contains__(self, kmer):
        # parity with hashset.pyx __contains__: ints pass through,
        # Kmer objects use their canonical hash, strings use the
        # (non-canonical) forward hash
        if isinstance(kmer, str):
            from khmer_tpu_torch.ops.hashing import forward_hash_no_rc

            return forward_hash_no_rc(kmer, self.ksize) in self.hashes
        if hasattr(kmer, "kmer_u"):
            return int(kmer.kmer_u) in self.hashes
        return int(kmer) in self.hashes

    def add(self, h):
        self.hashes.add(int(h))

    def remove(self, h):
        h = int(h)
        if h not in self.hashes:
            raise ValueError("hash not in hashset")
        self.hashes.remove(h)

    def update(self, other):
        for h in other:
            self.hashes.add(int(h))

    def __iadd__(self, other):
        if self.ksize != getattr(other, "ksize", self.ksize):
            raise ValueError("cannot concatenate HashSets with different "
                             "ksize")
        self.update(other)
        return self

    def __add__(self, other):
        if self.ksize != getattr(other, "ksize", self.ksize):
            raise ValueError("cannot add HashSets with different ksizes")
        out = HashSet(self.ksize, self.hashes)
        out.update(other)
        return out
