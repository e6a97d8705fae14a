"""OXLI binary table files -- byte-exact save/load.

Port of khmer_tpu/io/oxli_format.py:109-283 for the byte (Countgraph)
and bit (Nodegraph) kinds.  All integers little-endian:

Countgraph (SAVED_COUNTING_HT=1):
  "OXLI" | u8 version=4 | u8 type | u8 use_bigcount | u32 ksize |
  u8 n_tables | u64 occupied | per table: u64 size + size bytes |
  u64 n_bigcounts | n * (u64 hash, u16 count), sorted by hash

Nodegraph (SAVED_HASHBITS=2):
  "OXLI" | u8 version=4 | u8 type | u32 ksize | u8 n_tables |
  u64 occupied | per table: u64 size_bits + (size//8+1) bytes
"""

import gzip
import struct

import numpy as np

SAVED_SIGNATURE = b"OXLI"
SAVED_FORMAT_VERSION = 4
SAVED_COUNTING_HT = 1
SAVED_HASHBITS = 2

FILETYPES = {
    "COUNTING_HT": SAVED_COUNTING_HT,
    "HASHBITS": SAVED_HASHBITS,
    "TAGS": 3,
    "STOPTAGS": 4,
    "SUBSET": 5,
    "LABELSET": 6,
    "SMALLCOUNT": 7,
    "QFCOUNT": 8,
}

_KINDS = {SAVED_COUNTING_HT: "byte", SAVED_HASHBITS: "bit"}


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
    """Save a Byte/Bit storage in OXLI format."""
    kind = storage.kind
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
            f.write(struct.pack("BB", SAVED_FORMAT_VERSION, SAVED_HASHBITS))
        f.write(struct.pack("<IBQ", int(ksize), len(sizes),
                            storage.n_occupied()))
        off = 0
        for size, nbytes in zip(sizes, bpt):
            f.write(struct.pack("<Q", size))
            f.write(raw[off: off + nbytes].tobytes())
            off += nbytes
        if kind == "byte":
            bc = storage.resolved_bigcounts()
            f.write(struct.pack("<Q", len(bc)))
            # canonical deterministic order: sorted by hash (matches the
            # khmer-2.x std::map serialization order)
            for h in sorted(bc):
                f.write(struct.pack("<QH", h, bc[h]))


def load_storage(filename, expected_kind, device=None):
    """Load an OXLI table file of the expected kind ('byte' or 'bit');
    returns (storage, ksize)."""
    try:
        return _load_storage(filename, expected_kind, device)
    except EOFError as err:
        # a truncated gzip stream must fail like any truncated file
        raise OSError("truncated compressed file {!r}: {}".format(
            filename, err))


def _load_storage(filename, expected_kind, device):
    from khmer_tpu_torch.storage import BitStorage, ByteStorage

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
        kind = _KINDS.get(ht_type)
        if kind != expected_kind:
            raise OxliFileError(
                "Incorrect file format type {} while reading k-mer file "
                "from {}".format(ht_type, filename))
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
            nbytes = size if kind == "byte" else size // 8 + 1
            chunks.append(np.frombuffer(
                _read_exact(f, nbytes, filename), dtype=np.uint8))
        cls = ByteStorage if kind == "byte" else BitStorage
        store = cls(sizes, device=device)
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
