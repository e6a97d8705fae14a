"""Raw MQF (mixed quotient filter) block-dump codec: a copy of
khmer_tpu/io/mqf_format.py (numpy only).

The reference's QF saves write the OXLI header (sig, version, type 8,
1-byte ksize) followed by the IN-MEMORY dump of the MQF: the 192-byte
`qfmetadata` struct and `metadata->size` bytes of RSQF blocks
(QFStorage::save, src/oxli/storage.cc:919-936, over
third-party/MQF/gqf.c).  This module encodes and decodes that exact
byte layout, so QF files round-trip between this port, khmer_tpu and
the reference (khmer_tpu's tests hold its copy to the reference's own
MQF library).

Layout facts (gqf.c, NH build; confirmed by offsetof probe):
  * metadata: packed at the offsets in _META fields below (192 bytes,
    16-byte aligned tail; `range` is a __uint128_t at offset 96; the
    trailing `tags_map` host pointer is garbage on disk and ignored).
  * blocks: nblocks x blockSize bytes; blockSize = 17 + 8*bits_per_slot
    (offset u8, occupieds u64, runends u64, then 64 slots of
    bits_per_slot bits each, bit-packed little-endian).
  * slot value = [tag_bits | key_remainder_bits | fixed_counter_size]
    with the fixed counter in the LOW bits (super_get, gqf.c:639-644).
  * counts are encoded as: first slot holds the remainder and
    fc_first = min(count-1, fixed_max); iff fc_first == fixed_max,
    extension slots follow holding base-2^r digits of the remaining
    count (MSB first), each with fixed field == fixed_max except the
    last, whose fixed field holds the final leftover digit
    (encode_counter/decode_counter, gqf.c:1299-1370).

The decoder walks runs per the RSQF invariants (occupied quotients in
ascending order; each run ends at its runend bit; a run starts at
max(quotient, previous run end + 1)).  The encoder lays the same
structure out canonically from a sorted (key, count) multiset and
computes per-block offsets as run_end(64b-1) - (64b-1) (gqf.c:667-678).
"""

import math
import struct

import numpy as np

U64 = np.uint64

# field name -> byte offset inside qfmetadata (offsetof-probed)
_META = {
    "size": 0, "seed": 8, "nslots": 16, "xnslots": 24, "key_bits": 32,
    "tag_bits": 40, "BlockTag_bits": 48, "fixed_counter_size": 56,
    "key_remainder_bits": 64, "bits_per_slot": 72, "blockSize": 80,
    "range_lo": 96, "range_hi": 104, "nblocks": 112, "nelts": 120,
    "ndistinct_elts": 128, "noccupied_slots": 136,
    "maximum_occupied_slots": 144, "num_locks": 152,
    "maximum_count": 160, "mem": 168,
}
META_BYTES = 192
# khmer's MQF graphs use a 2-bit fixed counter and no tags
# (create_MQFGraph, khmer/khmer_args.py:548-598: bitsPerSlot=slotSize+2)
FIXED_COUNTER_SIZE = 2
_SEED = 2038074761  # qf_init's seed is unused ("useless value")


class MQFFormatError(ValueError):
    pass


def _meta_get(buf, name, width=8):
    off = _META[name]
    return int.from_bytes(buf[off: off + width], "little")


def parse_metadata(buf):
    """Parse a 192-byte qfmetadata blob -> dict; raises MQFFormatError
    if the invariants do not hold (used to distinguish raw dumps from
    this port's legacy sorted payload)."""
    if len(buf) < META_BYTES:
        raise MQFFormatError("short metadata")
    m = {k: _meta_get(buf, k, 4 if k == "seed" else 8)
         for k in _META if k != "mem"}
    m["mem"] = buf[_META["mem"]]
    bps = m["key_remainder_bits"] + m["fixed_counter_size"] + m["tag_bits"]
    if not (0 < m["key_remainder_bits"] <= 56
            and m["bits_per_slot"] == bps
            and m["blockSize"] == 17 + 8 * bps
            and m["nslots"] > 0
            and m["nblocks"] == (m["xnslots"] + 63) // 64
            and m["size"] == m["nblocks"] * m["blockSize"]
            and m["mem"] in (0, 1)):
        raise MQFFormatError("not a raw MQF metadata blob")
    return m


def _slot_values(block_bytes, bps):
    """All 64 slot values of one block's slot region."""
    out = np.empty(64, U64)
    mask = (1 << bps) - 1
    for i in range(64):
        bit = i * bps
        word = int.from_bytes(
            block_bytes[bit // 8: bit // 8 + 16], "little")
        out[i] = (word >> (bit % 8)) & mask
    return out


def decode_blocks(meta, blob):
    """Decode the RSQF block region -> (keys, counts) ascending."""
    bps = meta["bits_per_slot"]
    fixed = meta["fixed_counter_size"]
    r = meta["key_remainder_bits"]
    fixed_max = (1 << fixed) - 1
    rem_mask = (1 << r) - 1
    bs = meta["blockSize"]
    nblocks = meta["nblocks"]

    occ = np.empty(nblocks, U64)
    rend = np.empty(nblocks, U64)
    slots = np.empty(nblocks * 64, U64)
    for b in range(nblocks):
        blk = blob[b * bs: (b + 1) * bs]
        occ[b] = int.from_bytes(blk[1:9], "little")
        rend[b] = int.from_bytes(blk[9:17], "little")
        slots[b * 64: (b + 1) * 64] = _slot_values(blk[17:], bps)

    occ_bits = np.unpackbits(
        occ.view(np.uint8).reshape(nblocks, 8), axis=1,
        bitorder="little").reshape(-1)
    rend_bits = np.unpackbits(
        rend.view(np.uint8).reshape(nblocks, 8), axis=1,
        bitorder="little").reshape(-1)
    quotients = np.nonzero(occ_bits)[0]

    keys, counts = [], []
    pos = 0
    for q in quotients:
        idx = max(int(q), pos)
        while True:
            v = int(slots[idx])
            fc = v & fixed_max
            rem = (v >> fixed) & rem_mask
            count = fc + 1
            if fc == fixed_max:
                ext = 0
                no_digits = 0
                while True:
                    idx += 1
                    no_digits += 1
                    v = int(slots[idx])
                    ext = (ext << r) | ((v >> fixed) & rem_mask)
                    fc = v & fixed_max
                    if fc != fixed_max:
                        break
                count += ext + (fc << (no_digits * r))
            keys.append((int(q) << r) | rem)
            counts.append(count)
            if rend_bits[idx]:
                break
            idx += 1
        pos = idx + 1
    return (np.array(keys, U64), np.array(counts, U64))


def encode_blocks(keys, counts, nslots, rem_bits,
                  fixed=FIXED_COUNTER_SIZE):
    """Encode a sorted (key, count) multiset into (metadata dict,
    block bytes) in the reference's canonical RSQF layout."""
    keys = np.asarray(keys, U64)
    counts = np.asarray(counts, U64)
    xnslots = nslots + int(10 * math.sqrt(nslots))
    nblocks = (xnslots + 63) // 64
    bps = rem_bits + fixed
    block_size = 17 + 8 * bps
    fixed_max = (1 << fixed) - 1
    base = 1 << rem_bits

    slots = np.zeros(nblocks * 64, U64)
    occ = np.zeros(nblocks * 64, bool)
    rend = np.zeros(nblocks * 64, bool)
    run_ends = []  # (quotient, end_slot) per run, ascending

    pos = 0
    noccupied = 0
    i = 0
    n = keys.shape[0]
    while i < n:
        q = int(keys[i]) >> rem_bits
        occ[q] = True
        idx = max(q, pos)
        while i < n and (int(keys[i]) >> rem_bits) == q:
            rem = int(keys[i]) & (base - 1)
            c = int(counts[i]) - 1
            fc_first = min(c, fixed_max)
            c -= fc_first
            vals = [(rem << fixed) | fc_first]
            if fc_first == fixed_max:
                digits = []
                while True:
                    digits.append(c % base)
                    c >>= rem_bits
                    if c <= fixed_max - 1:
                        break
                leftover = c
                ext = [(d << fixed) | fixed_max
                       for d in reversed(digits)]
                ext[-1] = (digits[0] << fixed) | leftover
                vals += ext
            for v in vals:
                if idx >= nblocks * 64:
                    raise MQFFormatError("QF overflow while encoding")
                slots[idx] = v
                idx += 1
            i += 1
        rend[idx - 1] = True
        noccupied += idx - max(q, pos)
        run_ends.append((q, idx - 1))
        pos = idx

    # per-block offsets: run_end(64b - 1) - (64b - 1), clamped to 255
    offsets = np.zeros(nblocks, np.uint16)
    ri = 0
    last_end = -1
    for b in range(1, nblocks):
        x = 64 * b - 1
        while ri < len(run_ends) and run_ends[ri][0] <= x:
            last_end = run_ends[ri][1]
            ri += 1
        offsets[b] = min(max(0, last_end - x), 255)

    blob = bytearray(nblocks * block_size)
    occ_words = np.packbits(
        occ.reshape(nblocks, 64), axis=1, bitorder="little")
    rend_words = np.packbits(
        rend.reshape(nblocks, 64), axis=1, bitorder="little")
    for b in range(nblocks):
        off = b * block_size
        blob[off] = int(offsets[b])
        blob[off + 1: off + 9] = occ_words[b].tobytes()
        blob[off + 9: off + 17] = rend_words[b].tobytes()
        region = int(0)
        for s in range(64):
            region |= int(slots[b * 64 + s]) << (s * bps)
        blob[off + 17: off + block_size] = region.to_bytes(
            8 * bps, "little")

    meta = {
        "size": nblocks * block_size, "seed": _SEED, "nslots": nslots,
        "xnslots": xnslots,
        "key_bits": int(math.log2(nslots)) + rem_bits,
        "tag_bits": 0, "BlockTag_bits": 0,
        "fixed_counter_size": fixed, "key_remainder_bits": rem_bits,
        "bits_per_slot": bps, "blockSize": block_size,
        "range_lo": (nslots << rem_bits) & ((1 << 64) - 1),
        "range_hi": (nslots << rem_bits) >> 64,
        "nblocks": nblocks, "nelts": int(counts.sum()),
        "ndistinct_elts": int(keys.shape[0]),
        "noccupied_slots": noccupied,
        # qf_init: 0.95 * xnslots
        "maximum_occupied_slots": int(0.95 * xnslots),
        "num_locks": (xnslots // 4096) + 2,
        "maximum_count": 0, "mem": 1,
    }
    return meta, bytes(blob)


def pack_metadata(meta):
    buf = bytearray(META_BYTES)
    for name, off in _META.items():
        if name == "mem":
            buf[off] = int(meta["mem"])
        elif name == "seed":
            buf[off: off + 4] = int(meta["seed"]).to_bytes(4, "little")
        else:
            buf[off: off + 8] = int(meta[name]).to_bytes(8, "little")
    return bytes(buf)


def write_qf_dump(fileobj, ksize, keys, counts, nslots, rem_bits,
                  fixed=FIXED_COUNTER_SIZE):
    """Write the reference QFStorage::save byte stream (minus the OXLI
    sig/version/type header, which the caller frames)."""
    fileobj.write(struct.pack("B", int(ksize)))
    meta, blob = encode_blocks(keys, counts, nslots, rem_bits, fixed)
    fileobj.write(pack_metadata(meta))
    fileobj.write(blob)


def read_qf_dump(fileobj):
    """Read (ksize, meta, keys, counts) from after the OXLI header."""
    (ksize,) = struct.unpack("B", fileobj.read(1))
    meta = parse_metadata(fileobj.read(META_BYTES))
    blob = fileobj.read(meta["size"])
    if len(blob) != meta["size"]:
        raise MQFFormatError("truncated MQF block region")
    keys, counts = decode_blocks(meta, blob)
    return ksize, meta, keys, counts
