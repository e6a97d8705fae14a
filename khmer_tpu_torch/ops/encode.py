"""DNA sequence -> 2-bit code conversion (host side, numpy; the part of
khmer_tpu/ops/encode.py that the port uses).

khmer's 2-bit alphabet is A=0, T=1, C=2, G=3 (reference
include/oxli/kmer_hash.hh:70-73) — note this is *not* the common
lexicographic ACGT order.  With this encoding the complement is a single
XOR with 1 (A<->T, C<->G), which the device-side hash kernels exploit.

Cleaning semantics ("cleaned_seq") follow reference
include/oxli/read_parsers.hh:122-138: uppercase the read and replace any
non-ACGT character with 'A'.
"""

import numpy as np

# Build byte LUTs once.
#
# The raw LUT reproduces twobit_repr exactly (kmer_hash.hh:70-73): 'A'->0,
# 'T'->1, 'C'->2, and *everything else* (including lowercase and N) -> 3.
_CODE_LUT = np.full(256, 3, dtype=np.uint8)
for _ch, _code in (("A", 0), ("T", 1), ("C", 2)):
    _CODE_LUT[ord(_ch)] = _code

_CLEAN_LUT = np.full(256, ord("A"), dtype=np.uint8)
for _ch in "ACGT":
    _CLEAN_LUT[ord(_ch)] = ord(_ch)
    _CLEAN_LUT[ord(_ch.lower())] = ord(_ch)

# khmer's IUPAC complement table, reproduced character-for-character from
# the `tbl` macro at reference kmer_hash.cc:51-54: 64 spaces, then the
# segment below indexed by (char - 64), repeated for lowercase input
# (lowercase complements to UPPERCASE).  Characters outside the table
# complement to ' ', as in the reference.
_TBL_SEGMENT = " TVGH FCD  M KN   YSAABW R"
COMP_LUT = np.full(256, ord(" "), dtype=np.uint8)
for _j, _c in enumerate(_TBL_SEGMENT):
    COMP_LUT[64 + _j] = ord(_c)
    COMP_LUT[96 + _j] = ord(_c)


def _as_bytes(seq):
    if isinstance(seq, str):
        return seq.encode("ascii")
    return bytes(seq)


def clean_sequence(seq):
    """Return the cleaned (uppercase, non-ACGT->A) sequence as str."""
    arr = np.frombuffer(_as_bytes(seq), dtype=np.uint8)
    return _CLEAN_LUT[arr].tobytes().decode("ascii")


def encode_sequence(seq):
    """Encode one sequence into 2-bit codes (uint8 array, one code/base).

    Raw twobit_repr semantics: 'A'->0, 'T'->1, 'C'->2, anything else -> 3.
    Clean the sequence first for cleaned-read semantics.
    """
    arr = np.frombuffer(_as_bytes(seq), dtype=np.uint8)
    return _CODE_LUT[arr]
