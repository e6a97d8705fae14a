"""OXLI binary table files -- byte-exact save/load.

Port of khmer_tpu/io/oxli_format.py:109-283 for the byte (Countgraph),
nibble (SmallCountgraph), bit (Nodegraph) and quotient-filter
(QFCounttable) kinds.  All integers little-endian:

Countgraph (SAVED_COUNTING_HT=1):
  "OXLI" | u8 version=4 | u8 type | u8 use_bigcount | u32 ksize |
  u8 n_tables | u64 occupied | per table: u64 size + size bytes |
  u64 n_bigcounts | n * (u64 hash, u16 count), sorted by hash

Nodegraph (SAVED_HASHBITS=2):
  "OXLI" | u8 version=4 | u8 type | u32 ksize | u8 n_tables |
  u64 occupied | per table: u64 size_bits + (size//8+1) bytes

SmallCountgraph (SAVED_SMALLCOUNT=7): the Nodegraph header (no bigcount
byte, no bigcount section); per table: u64 size + (size//2+1) bytes,
two 4-bit counts a byte, the even bin in the high nibble, and a
trailing pad nibble

QFCounttable (SAVED_QFCOUNT=8): "OXLI" | u8 version=4 | u8 type | u8
ksize | the reference's raw MQF dump, 192 bytes of qfmetadata and its
RSQF blocks (io/mqf_format.py; QFStorage::save, storage.cc:919-936)

Tagset / stoptags (SAVED_TAGS=3 / SAVED_STOPTAGS=4; khmer_tpu/io/
oxli_format.py:285-318):
  "OXLI" | u8 version=4 | u8 type | u32 ksize | u64 n | (tagset only:
  u32 tag_density) | n * u64 hashes, sorted

The subset partition map (SAVED_SUBSET=5) is written by
partitioning.SubsetPartition.save_partitionmap.
"""

import gzip
import struct

import numpy as np

from khmer_tpu_torch._config import DEFAULT_TAG_DENSITY
from khmer_tpu_torch.ops.sketch_ops import SketchSpec

SAVED_SIGNATURE = b"OXLI"
SAVED_FORMAT_VERSION = 4
SAVED_COUNTING_HT = 1
SAVED_HASHBITS = 2
SAVED_TAGS = 3
SAVED_STOPTAGS = 4
SAVED_SUBSET = 5
SAVED_LABELSET = 6
SAVED_SMALLCOUNT = 7
SAVED_QFCOUNT = 8

FILETYPES = {
    "COUNTING_HT": SAVED_COUNTING_HT,
    "HASHBITS": SAVED_HASHBITS,
    "TAGS": SAVED_TAGS,
    "STOPTAGS": SAVED_STOPTAGS,
    "SUBSET": SAVED_SUBSET,
    "LABELSET": SAVED_LABELSET,
    "SMALLCOUNT": SAVED_SMALLCOUNT,
    "QFCOUNT": SAVED_QFCOUNT,
}

_KINDS = {SAVED_COUNTING_HT: "byte", SAVED_HASHBITS: "bit",
          SAVED_SMALLCOUNT: "nibble"}
_TYPES = {kind: ht_type for ht_type, kind in _KINDS.items()}


class OxliFileError(OSError):
    pass


def _open_out(filename):
    if str(filename).endswith(".gz"):
        return gzip.open(filename, "wb")
    return open(filename, "wb")


def _open_in(filename):
    if str(filename).endswith(".gz"):
        return gzip.open(filename, "rb")
    f = open(filename, "rb")
    # transparently handle gzip content without .gz suffix
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        f.close()
        return gzip.open(filename, "rb")
    return f


def _read_exact(f, n, filename):
    data = f.read(n)
    if len(data) != n:
        raise OxliFileError(
            "Unexpected end of k-mer file: {}".format(filename))
    return data


def save_storage(filename, ksize, storage):
    """Save a Byte/Nibble/Bit/QF storage in OXLI format."""
    kind = storage.kind
    if kind == "qf":
        from khmer_tpu_torch.io.mqf_format import write_qf_dump

        keys, counts = storage.state_arrays()
        with _open_out(filename) as f:
            f.write(SAVED_SIGNATURE)
            f.write(struct.pack("BB", SAVED_FORMAT_VERSION, SAVED_QFCOUNT))
            write_qf_dump(f, int(ksize), keys, counts, storage.nslots,
                          storage.rem_bits)
        return
    raw = storage.raw_bytes()
    sizes = storage.spec.tablesizes
    bpt = storage.spec.bytes_per_table
    with _open_out(filename) as f:
        f.write(SAVED_SIGNATURE)
        if kind == "byte":
            f.write(struct.pack("BBB", SAVED_FORMAT_VERSION,
                                SAVED_COUNTING_HT,
                                1 if storage.get_use_bigcount() else 0))
        else:
            f.write(struct.pack("BB", SAVED_FORMAT_VERSION, _TYPES[kind]))
        f.write(struct.pack("<IBQ", int(ksize), len(sizes),
                            storage.n_occupied()))
        off = 0
        for size, nbytes in zip(sizes, bpt):
            f.write(struct.pack("<Q", size))
            f.write(raw[off: off + nbytes])  # no copy (tobytes would make one)
            off += nbytes
        if kind == "byte":
            bc = storage.resolved_bigcounts()
            f.write(struct.pack("<Q", len(bc)))
            # canonical deterministic order: sorted by hash (matches the
            # khmer-2.x std::map serialization order)
            for h in sorted(bc):
                f.write(struct.pack("<QH", h, bc[h]))


def load_storage(filename, expected_kinds=("byte", "bit", "nibble"),
                 device=None):
    """Load an OXLI table file of one of the expected kinds ('byte',
    'nibble', 'bit' or 'qf'); returns (storage, ksize)."""
    try:
        return _load_storage(filename, expected_kinds, device)
    except EOFError as err:
        # a truncated gzip stream must fail like any truncated file
        raise OSError("truncated compressed file {!r}: {}".format(
            filename, err))


def _load_qf(f, filename, device):
    """The QF section of a SAVED_QFCOUNT file after its type byte
    (khmer_tpu/io/oxli_format.py:187-240): the reference's raw MQF dump,
    or khmer_tpu's round-1 payload (u64 nslots, u64 n, n keys, n counts);
    a payload after the dump's blocks (a layered MQF, which the fork
    cannot serialise) is refused."""
    from khmer_tpu_torch.io.mqf_format import (MQFFormatError,
                                               decode_blocks, parse_metadata)
    from khmer_tpu_torch.storage import QFStorage

    (ksize,) = struct.unpack("B", _read_exact(f, 1, filename))
    blob = f.read(192)
    if len(blob) < 16:
        raise OxliFileError("Truncated QF section in {}".format(filename))
    try:
        meta = parse_metadata(blob)
    except MQFFormatError:
        nslots, n_entries = struct.unpack("<QQ", blob[:16])
        rest = blob[16:] + f.read()
        keys = np.frombuffer(rest[: 8 * n_entries], np.uint64)
        counts = np.frombuffer(rest[8 * n_entries: 16 * n_entries],
                               np.uint64)
        store = QFStorage(nslots, device=device)
        store.set_state_arrays(keys.copy(), counts.copy())
        return store, ksize
    region = _read_exact(f, meta["size"], filename)
    keys, counts = decode_blocks(meta, region)
    if f.read(1):
        raise OxliFileError(
            "unexpected trailing payload after the QF block region in {} "
            "-- layered/multi-level MQF dumps are not supported (see "
            "docs/PARITY.md, LayeredMQF decision record)".format(filename))
    slot = meta["key_remainder_bits"]
    store = QFStorage(meta["nslots"], None if slot == 8 else slot,
                      device=device)
    store.set_state_arrays(keys, counts)
    return store, ksize


def _load_storage(filename, expected_kinds, device):
    from khmer_tpu_torch.storage import BY_KIND

    with _open_in(filename) as f:
        sig = _read_exact(f, 4, filename)
        if sig != SAVED_SIGNATURE:
            raise OxliFileError(
                "Does not start with signature for a oxli file: {!r} "
                "Should be: OXLI".format(sig))
        (version,) = struct.unpack("B", _read_exact(f, 1, filename))
        (ht_type,) = struct.unpack("B", _read_exact(f, 1, filename))
        if version != SAVED_FORMAT_VERSION:
            raise OxliFileError(
                "Incorrect file format version {} while reading k-mer file "
                "from {}; should be {}".format(version, filename,
                                               SAVED_FORMAT_VERSION))
        kind = "qf" if ht_type == SAVED_QFCOUNT else _KINDS.get(ht_type)
        if kind not in expected_kinds:
            raise OxliFileError(
                "Incorrect file format type {} while reading k-mer file "
                "from {}".format(ht_type, filename))
        if kind == "qf":
            return _load_qf(f, filename, device)
        use_bigcount = 0
        if kind == "byte":
            (use_bigcount,) = struct.unpack(
                "B", _read_exact(f, 1, filename))
        ksize, n_tables, occupied = struct.unpack(
            "<IBQ", _read_exact(f, 13, filename))
        sizes = []
        chunks = []
        for _ in range(n_tables):
            (size,) = struct.unpack("<Q", _read_exact(f, 8, filename))
            sizes.append(size)
            nbytes = SketchSpec(kind, (size,)).bytes_per_table[0]
            chunks.append(np.frombuffer(
                _read_exact(f, nbytes, filename), dtype=np.uint8))
        store = BY_KIND[kind](sizes, device=device)
        store.set_raw_bytes(np.concatenate(chunks), occupied)
        if kind == "byte":
            store.set_use_bigcount(bool(use_bigcount))
            (n_counts,) = struct.unpack("<Q", _read_exact(f, 8, filename))
            if n_counts:
                data = _read_exact(f, 10 * n_counts, filename)
                for i in range(n_counts):
                    h, c = struct.unpack_from("<QH", data, 10 * i)
                    store.bigcounts[h] = c
    return store, ksize


def _check_header(f, filename, expected_type, kind):
    sig = _read_exact(f, 4, filename)
    if sig != SAVED_SIGNATURE:
        raise OxliFileError(
            "Does not start with signature for a oxli file: {!r} "
            "Should be: OXLI".format(sig))
    (version,) = struct.unpack("B", _read_exact(f, 1, filename))
    (ht_type,) = struct.unpack("B", _read_exact(f, 1, filename))
    if version != SAVED_FORMAT_VERSION:
        raise OxliFileError(
            "Incorrect file format version {} while reading {} file from "
            "{}; should be {}".format(version, kind, filename,
                                      SAVED_FORMAT_VERSION))
    if ht_type != expected_type:
        raise OxliFileError(
            "Incorrect file format type {} while reading {} file from "
            "{}".format(ht_type, kind, filename))


def save_hashset(filename, ksize, hashes, ht_type=SAVED_TAGS,
                 tag_density=None):
    """Save a tagset (with its tag density) or stoptags file; the hashes
    sorted, as the reference's ordered SeenSet writes them
    (hashgraph.cc:257-290, 1371-1396)."""
    hashes = np.sort(np.fromiter((int(h) for h in hashes), np.uint64,
                                 len(hashes)))
    with _open_out(filename) as f:
        f.write(SAVED_SIGNATURE)
        f.write(struct.pack("BB", SAVED_FORMAT_VERSION, ht_type))
        f.write(struct.pack("<IQ", int(ksize), hashes.size))
        if ht_type == SAVED_TAGS:
            f.write(struct.pack("<I", int(DEFAULT_TAG_DENSITY
                                          if tag_density is None
                                          else tag_density)))
        f.write(hashes.astype("<u8").tobytes())


def load_hashset(filename, ht_type=SAVED_TAGS):
    """Load a tagset or stoptags file: (ksize, uint64 hashes, the tag
    density, None for stoptags)."""
    with _open_in(filename) as f:
        _check_header(f, filename, ht_type, "tagset")
        ksize, n = struct.unpack("<IQ", _read_exact(f, 12, filename))
        density = None
        if ht_type == SAVED_TAGS:
            (density,) = struct.unpack("<I", _read_exact(f, 4, filename))
        hashes = np.frombuffer(_read_exact(f, 8 * n, filename), "<u8")
    return ksize, hashes.astype(np.uint64), density
