"""Kmer value type (parity: khmer/_oxli/hashing.pyx:10-66 and the C++
Kmer struct, include/oxli/kmer_hash.hh:146-223): forward/reverse 2-bit
hashes plus the canonical (uniqified) form.  A copy of khmer_tpu/kmer.py."""

from khmer_tpu_torch.ops.hashing import (hash_2bit_scalar, reverse_complement,
                                   reverse_hash)


class Kmer:
    def __init__(self, kmer=None):
        self.kmer = kmer
        if kmer is not None:
            _, self._f, self._r = hash_2bit_scalar(kmer, len(kmer))
        else:
            self._f = 0
            self._r = 0

    def __len__(self):
        return len(self.kmer or "")

    def __str__(self):
        return self.kmer or ""

    def __hash__(self):
        return self.kmer_u

    def __repr__(self):
        return self.kmer or ""

    def __eq__(self, other):
        if isinstance(other, Kmer):
            return self.kmer_u == other.kmer_u
        return NotImplemented

    @property
    def kmer_f(self):
        return self._f

    @property
    def kmer_r(self):
        return self._r

    @property
    def kmer_u(self):
        return min(self._f, self._r)

    def reverse_complement(self):
        self._f, self._r = self._r, self._f
        self.kmer = reverse_complement(self.kmer)

    @property
    def is_forward(self):
        return self._f == self.kmer_u

    @staticmethod
    def create(tag, K):
        kmer = Kmer()
        s = reverse_hash(int(tag), K)
        _, kmer._f, kmer._r = hash_2bit_scalar(s, K)
        # canonical representation (set_from_unique_hash semantics)
        kmer.kmer = reverse_hash(kmer.kmer_u, K)
        return kmer
