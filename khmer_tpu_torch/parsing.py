"""Parsing-layer class API (parity: khmer/_oxli/parsing.pyx):
Sequence, Alphabets, FastxParser, SanitizedFastxParser,
SplitPairedReader, BrokenPairedReader, and the pairing check helpers.
A copy of khmer_tpu/parsing.py."""

from khmer_tpu_torch.io.fastx import FastxReader, Read
from khmer_tpu_torch.ops.encode import clean_sequence
from khmer_tpu_torch.utils import (UnpairedReadsError, broken_paired_reader,
                             check_is_left, check_is_pair, check_is_right)


class Alphabets:
    """Named alphabet registry (parsing.pyx:14-40 over the reference
    src/oxli/alphabets.cc strings)."""

    _ALPHABETS = {
        'DNA_SIMPLE': 'ACGT',
        'DNAN_SIMPLE': 'ACGTN',
        'RNA_SIMPLE': 'ACGUT',
        'RNAN_SIMPLE': 'ACGUTN',
        'IUPAC_NUCL': 'ACGTURYSWKMBDHVN.-',
        'IUPAC_AA': 'ACDEFGHIKLMNPQRSTVWY',
    }

    @staticmethod
    def get(name):
        alphabet = Alphabets._ALPHABETS.get(name)
        if not alphabet:
            raise ValueError('No alphabet with name {0}'.format(name))
        return alphabet


class Sequence:
    """The Cython layer's sequence record (parsing.pyx Sequence): all
    fields default to None, and name+sequence must be given together
    or the record stays empty."""

    __slots__ = ("name", "sequence", "quality", "description",
                 "_cleaned")

    def __init__(self, name=None, sequence=None, quality=None,
                 description=None, cleaned_seq=None):
        if name is not None and sequence is not None:
            self.name = name
            self.sequence = sequence
            self.quality = quality
            self.description = description
            self._cleaned = cleaned_seq
        else:
            self.name = None
            self.sequence = None
            self.quality = None
            self.description = None
            self._cleaned = None

    @property
    def cleaned_seq(self):
        if self._cleaned is not None:
            return self._cleaned
        if self.sequence is None:
            return None
        self._cleaned = clean_sequence(self.sequence)
        return self._cleaned

    @cleaned_seq.setter
    def cleaned_seq(self, value):
        self._cleaned = value

    def __len__(self):
        return len(self.sequence or "")

    def __str__(self):
        return self.sequence or ""

    def __repr__(self):
        return 'Sequence(name="{0}", sequence="{1}")'.format(
            self.name, self.sequence)

    def __eq__(self, other):
        return (self.name == getattr(other, "name", None) and
                self.sequence == getattr(other, "sequence", None))

    def __getitem__(self, key):
        if key in ("name", "sequence", "description", "quality",
                   "cleaned_seq"):
            value = getattr(self, key)
            if value is None:
                raise KeyError(key)
            return value
        raise KeyError(key)

    @staticmethod
    def from_screed_record(record):
        return Sequence(name=record.name, sequence=record.sequence,
                        quality=getattr(record, "quality", None),
                        description=getattr(record, "description", None))


# the plain parser IS the fastx reader
FastxParser = FastxReader


def _sanitize(sequence, alphabet, convert_n):
    """Uppercase + validate + optional N->A (parsing.pyx:184-194:
    `c &= 0xdf` uppercasing quirk included).  Returns None when the
    sequence has characters outside the alphabet."""
    out = []
    for c in sequence:
        c = chr(ord(c) & 0xdf)
        if c not in alphabet:
            return None
        if convert_n and c == 'N':
            c = 'A'
        out.append(c)
    return ''.join(out)


class SanitizedFastxParser(FastxReader):
    """FastxParser that uppercases, validates against an alphabet
    (skipping+counting invalid records), and optionally converts N->A
    (parsing.pyx SanitizedFastxParser, default alphabet DNAN_SIMPLE)."""

    def __init__(self, filename, alphabet='DNAN_SIMPLE', convert_n=True):
        super().__init__(filename)
        self.convert_n = convert_n
        self.n_bad = 0
        self._alphabet = Alphabets.get(alphabet)

    def __next__(self):
        while True:
            read = super().__next__()
            clean = _sanitize(read.sequence, self._alphabet,
                              self.convert_n)
            if clean is None:
                self.n_bad += 1
                continue
            read.sequence = clean
            return read


class BrokenPairedReader:
    """Iterator of (n, is_pair, read1, read2) over a possibly
    broken-paired stream (parsing.pyx:316-417)."""

    def __init__(self, parser, min_length=None, force_single=False,
                 require_paired=False):
        self.parser = parser
        self.min_length = min_length
        self.force_single = force_single
        self.require_paired = require_paired

    def __iter__(self):
        return broken_paired_reader(
            self.parser, min_length=self.min_length,
            force_single=self.force_single,
            require_paired=self.require_paired)


class SplitPairedReader:
    """Read two mate files in lockstep, yielding
    (n, is_pair, read1, read2) (parsing.pyx SplitPairedReader)."""

    def __init__(self, left_parser, right_parser, min_length=None,
                 force_name_match=False):
        self.left = left_parser
        self.right = right_parser
        self.min_length = min_length
        self.force_name_match = force_name_match

    def __iter__(self):
        from itertools import zip_longest

        n = 0
        for read1, read2 in zip_longest(iter(self.left), iter(self.right)):
            if read1 is None or read2 is None:
                raise UnpairedReadsError(
                    "Differing lengths of left and right files!",
                    read1, read2)
            if self.force_name_match and not check_is_pair(read1, read2):
                raise UnpairedReadsError(
                    "Left and right reads are not paired!", read1, read2)
            if self.min_length is not None:
                if len(read1.sequence) < self.min_length or \
                        len(read2.sequence) < self.min_length:
                    n += 2
                    continue
            yield n, True, read1, read2
            n += 2
