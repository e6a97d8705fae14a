"""Host-side FASTA/FASTQ reading and writing (a copy of
khmer_tpu/io/fastx.py without the pair iteration).

Parity notes: the reference parses reads with SeqAn behind a spin-locked
ReadParser (src/oxli/read_parsers.cc:336-361).  Here the parser's job is
to feed flat device chunks, so this is a plain streaming parser with
gzip/bzip2 transparently handled.  Read cleaning follows
include/oxli/read_parsers.hh:122-138: uppercase, then non-ACGT -> 'A'.
"""

import bz2
import gzip
import io
import os
import sys

from khmer_tpu_torch.ops.encode import clean_sequence


class Read:
    """A sequencing read (reference include/oxli/read_parsers.hh:102-138).

    Mirrors the Cython Sequence/screed Record surface: attributes plus
    dict-style access, and `quality` raising AttributeError when the
    record has none (tests/test_read_parsers.py:60-66 relies on
    `hasattr(read, 'quality')` being False for FASTA input)."""

    __slots__ = ("name", "sequence", "_quality", "_description", "_cleaned")

    def __init__(self, name, sequence, quality=None, description=None):
        self.name = name
        self.sequence = sequence
        self._quality = quality
        self._description = description or None
        self._cleaned = None

    @property
    def quality(self):
        if self._quality is None:
            raise AttributeError("this read has no quality string")
        return self._quality

    @quality.setter
    def quality(self, value):
        self._quality = value

    @property
    def description(self):
        if self._description is None:
            raise AttributeError("this read has no description")
        return self._description

    @description.setter
    def description(self, value):
        self._description = value

    def __getitem__(self, key):
        # screed.Record compatibility (sandbox scripts use record['name'])
        if key in ("name", "sequence", "description", "quality",
                   "cleaned_seq"):
            try:
                return getattr(self, key)
            except AttributeError:
                raise KeyError(key)
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    @property
    def cleaned_seq(self):
        if self._cleaned is None:
            self._cleaned = clean_sequence(self.sequence)
        return self._cleaned

    @cleaned_seq.setter
    def cleaned_seq(self, value):
        self._cleaned = value

    def set_clean_seq(self):
        self._cleaned = clean_sequence(self.sequence)

    def __len__(self):
        return len(self.sequence)

    def __repr__(self):
        return 'Read(name="{0}")'.format(self.name)


def _sniff_decompress(f, filename):
    """Wrap a binary stream in a gzip/bzip2 decompressor when its
    magic bytes say so — via peek(), never seek(), so pipes, FIFOs,
    and stdin stream transparently (the reference decompresses any
    stream through SeqAn the same way, read_parsers.cc:336-361)."""
    if not hasattr(f, "peek"):
        f = io.BufferedReader(f)
    magic = f.peek(3)[:3]
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(f, "rb")
    if magic == b"BZh":
        return bz2.open(f, "rb")
    if isinstance(filename, str) and \
            filename.endswith((".gz", ".bz2")) and len(magic) < 3:
        # an empty/truncated file with a compressed extension is an
        # error (the reference's SeqAn decompressor fails on these)
        raise OSError(
            "empty or corrupt compressed file {!r}".format(filename))
    return f


def _open_stream(filename):
    """Open a (possibly compressed) sequence file for text reading."""
    if filename in ("-", "/dev/stdin"):
        return _sniff_decompress(sys.stdin.buffer, None)
    if hasattr(filename, "read"):
        return _sniff_decompress(filename, None)
    if not os.path.exists(filename):
        # str(err) must read "[Errno 2] No such file or directory:
        # '<path>'" — script error goldens quote it (reference screed
        # raises the same)
        import errno

        raise OSError(errno.ENOENT, os.strerror(errno.ENOENT), filename)
    return _sniff_decompress(open(filename, "rb"), filename)


class FastxReader:
    """Streaming FASTA/FASTQ reader yielding Read objects.

    A shared iterator like the reference ReadParser
    (read_parsers.hh:142-182): iter(p) is p, multiple threads may pull
    reads from one instance (a lock replaces the reference's
    spin-lock)."""

    def __init__(self, filename, num_threads=1, raise_on_empty=True,
                 strict_fastq=False):
        import threading

        # the reference ReadParser's second argument is a thread count
        # (_cpy_khmer.cc ReadParser init); the python reader is already
        # thread-shared so only the type check matters
        if not isinstance(num_threads, int):
            raise TypeError("number of threads must be an integer")
        self.filename = filename
        # screed validates quality length == sequence length; the C++
        # ReadParser (SeqAn) does not (valid-read-testing.fq carries a
        # benign off-by-one that ReadParser-path tests rely on)
        self.strict_fastq = bool(strict_fastq)
        # the reference's C++ ReadParser raises on sequence-free input
        # (read_parsers.cc:258); its screed-based script paths do not.
        self.raise_on_empty = bool(raise_on_empty)
        self._stream = _open_stream(filename)
        self.num_reads = 0
        self._lock = threading.Lock()
        self._format = None      # resolved on first read
        self._pending = None     # lookahead header line
        self._done = False
        # the reference raises on a malformed file at construction
        # (read_parsers.cc:252 InvalidStream in FastxReader::_init);
        # probe the first byte when the source is seek-free peekable
        if isinstance(filename, str) and os.path.isfile(filename) and \
                hasattr(self._stream, "peek"):
            first = self._stream.peek(1)[:1]
            if first and first not in (b">", b"@"):
                raise OSError(
                    "File {} contains badly formatted sequence or does "
                    "not exist.".format(filename))

    # -- iteration --------------------------------------------------------

    def __iter__(self):
        return self

    def iter_reads(self):
        return self

    def __next__(self):
        with self._lock:
            read = self._next_locked()
        if read is None:
            raise StopIteration
        return read

    def is_complete(self):
        return self._done

    def _readline(self):
        try:
            return self._stream.readline()
        except EOFError as err:
            raise OSError("truncated compressed stream in {!r}: {}".format(
                self.filename, err))

    def _next_locked(self):
        if self._done:
            return None
        if self._format is None:
            first = self._readline()
            while first in (b"\n", b"\r\n"):
                first = self._readline()
            if not first:
                self._done = True
                if not self.raise_on_empty:
                    return None
                # reference ReadParser raises on sequence-free input
                # (read_parsers.cc:258)
                raise OSError("{} does not contain any "
                              "sequences!".format(self.filename))
            if first.startswith(b">"):
                self._format = "fasta"
            elif first.startswith(b"@"):
                self._format = "fastq"
            else:
                # reference read_parsers.cc:252 InvalidStream text,
                # surfaced as OSError by the binding
                raise OSError(
                    "File {} contains badly formatted sequence or does "
                    "not exist.".format(self.filename))
            self._pending = first
        if self._format == "fasta":
            return self._next_fasta()
        return self._next_fastq()

    def _next_fasta(self):
        header = self._pending
        self._pending = None
        if header is None:
            header = self._readline()
        while header in (b"\n", b"\r\n"):
            header = self._readline()
        if not header:
            self._done = True
            return None
        name = header[1:].strip().decode()
        chunks = []
        line = self._readline()
        while line and not line.startswith(b">"):
            chunks.append(line.strip())
            line = self._readline()
        self._pending = line or None
        if self._pending is None:
            self._done = True
        self.num_reads += 1
        return Read(name=name, sequence=b"".join(chunks).decode())

    def _next_fastq(self):
        header = self._pending
        self._pending = None
        if header is None:
            header = self._readline()
        while header in (b"\n", b"\r\n"):
            header = self._readline()
        if not header:
            self._done = True
            return None
        if not header.startswith(b"@"):
            raise ValueError(
                "invalid FASTQ record in {!r}".format(self.filename))
        name = header[1:].strip().decode()
        seq = self._readline().strip()
        if not seq or seq.startswith(b"+"):
            # a header with no sequence line (truncated file)
            raise ValueError("Sequence is empty")
        plus = self._readline()
        if not plus.startswith(b"+"):
            raise ValueError(
                "invalid FASTQ record (missing '+') in {!r}".format(
                    self.filename))
        qual = self._readline().strip()
        # NOTE: a quality string whose length differs from the
        # sequence is passed through unchanged by default — the
        # reference's SeqAn readRecord does not enforce equality and
        # its own test data (valid-read-testing.fq) relies on that.
        if self.strict_fastq and len(qual) != len(seq):
            raise ValueError(
                "quality scores length does not match sequence length "
                "in {!r} record {!r}".format(self.filename, name))
        self.num_reads += 1
        return Read(name=name, sequence=seq.decode(),
                    quality=qual.decode())

    def close(self):
        if self._stream not in (sys.stdin.buffer,):
            self._stream.close()
        self._done = True


def write_record(record, fileobj):
    """Write one record in FASTA/FASTQ (follows khmer/utils.py:172-187)."""
    quality = getattr(record, "quality", None)
    if quality is not None:
        recstr = "@{0}\n{1}\n+\n{2}\n".format(
            record.name, record.sequence, quality)
    else:
        recstr = ">{0}\n{1}\n".format(record.name, record.sequence)
    try:
        fileobj.write(bytes(recstr, "ascii"))
    except TypeError:
        fileobj.write(recstr)


def write_record_pair(read1, read2, fileobj):
    """Write both records of a pair (khmer/utils.py write_record_pair)."""
    write_record(read1, fileobj)
    write_record(read2, fileobj)


def screed_open(filename):
    """screed.open stand-in for the script layer: same record stream
    as FastxReader but yields NOTHING on empty input instead of
    raising (reference scripts using screed tolerate empty files;
    those using ReadParser do not)."""
    return FastxReader(filename, raise_on_empty=False,
                       strict_fastq=True)
