"""Script-level helpers: pairing-aware streaming, record writing,
coverage bundles (the parts of khmer_tpu/utils.py that the port's
scripts call; parity: reference khmer/utils.py and
khmer/_oxli/parsing.pyx pairing checks)."""

import sys

from khmer_tpu_torch.io.fastx import (  # noqa: F401
    write_record,
    write_record_pair,
)


def print_error(msg):
    print(msg, file=sys.stderr)


class UnpairedReadsError(ValueError):
    """ValueError carrying the offending read pair
    (parsing.pyx:159-173)."""

    def __init__(self, msg, r1, r2):
        r1_name = r1.name if r1 else "<no read>"
        r2_name = r2.name if r2 else "<no read>"
        super().__init__(msg + '\n"{0}"\n"{1}"'.format(r1_name, r2_name))
        self.read1 = r1
        self.read2 = r2


def _split_left_right(name):
    """Split a record name at the first whitespace (parsing.pyx:420-444)."""
    for i, ch in enumerate(name):
        if ch in (" ", "\t"):
            return name[:i], name[i + 1:]
    return name, ""


def check_is_pair(record1, record2):
    """Check whether two records form a read pair (parsing.pyx:447-494).

    Handles 'name/1'+'name/2', Casava 1.8 'name 1:...'+'name 2:...', and
    'name seq/1'+'name seq/2' conventions."""
    q1 = getattr(record1, "quality", None)
    q2 = getattr(record2, "quality", None)
    if (q1 is not None) != (q2 is not None):
        raise ValueError("both records must be same type (FASTA or FASTQ)")

    lhs1, rhs1 = _split_left_right(record1.name)
    lhs2, rhs2 = _split_left_right(record2.name)

    if lhs1.endswith("/1") and lhs2.endswith("/2"):
        subpart1 = lhs1.split("/", 1)[0]
        subpart2 = lhs2.split("/", 1)[0]
        if subpart1 and subpart1 == subpart2:
            return True
    elif lhs1 == lhs2 and rhs1.startswith("1:") and rhs2.startswith("2:"):
        return True
    elif lhs1 == lhs2 and rhs1.endswith("/1") and rhs2.endswith("/2"):
        subpart1 = rhs1.split("/", 1)[0]
        subpart2 = rhs2.split("/", 1)[0]
        if subpart1 and subpart1 == subpart2:
            return True
    return False


def check_is_left(name):
    """True when the name looks like the left mate of a pair."""
    lhs, rhs = _split_left_right(name)
    if lhs.endswith("/1") or rhs.startswith("1:") or rhs.endswith("/1"):
        return True
    return False


def check_is_right(name):
    """True when the name looks like the right mate of a pair."""
    lhs, rhs = _split_left_right(name)
    if lhs.endswith("/2") or rhs.startswith("2:") or rhs.endswith("/2"):
        return True
    return False


def broken_paired_reader(screed_iter, min_length=None, force_single=False,
                         require_paired=False):
    """Yield (n, is_pair, read1, read2) over a possibly broken-paired
    stream (parity: the Cython BrokenPairedReader, parsing.pyx:316-417;
    the reference's py-level khmer/utils.py copy was superseded by it).

    `n` counts records consumed from the stream (a pair advances it by
    2).  Reads shorter than `min_length` are dropped individually —
    a pair with one short mate yields with that slot set to None and
    `is_pair` False."""
    if force_single and require_paired:
        raise ValueError("force_single and require_paired cannot both be set!")

    it = iter(screed_iter)
    lookahead = None
    read_num = 0

    while True:
        # fetch the next 1-2 records (parsing.pyx _next, :370-417)
        if lookahead is None:
            first = next(it, None)
            if first is None:
                return
        else:
            first = lookahead
            lookahead = None

        second = next(it, None)
        if second is not None:
            is_pair = check_is_pair(first, second)
            if is_pair and not force_single:
                found = 2
            else:  # orphan
                if require_paired:
                    raise UnpairedReadsError(
                        "Unpaired reads when require_paired is set!",
                        first, second)
                lookahead = second
                second = None
                found = 1
        else:
            if require_paired:
                raise UnpairedReadsError(
                    "Unpaired reads when require_paired is set!",
                    first, None)
            found = 1

        if min_length and min_length > 0:
            if first is not None and len(first.sequence) < min_length:
                first = None
                found -= 1
            if second is not None and len(second.sequence) < min_length:
                second = None
                found -= 1

        if force_single:
            if first is not None:
                yield read_num, found == 2, first, None
                read_num += found
            if second is not None:
                yield read_num, found == 2, second, None
                read_num += found
        elif require_paired:
            if first is not None and second is not None:
                yield read_num, found == 2, first, second
                read_num += found
        else:
            if first is not None or second is not None:
                yield read_num, found == 2, first, second
                read_num += found


def clean_input_reads(records):
    """Attach screed-style cleaned_seq (upper + N->A) to a record stream
    (reference khmer/utils.py:215-225)."""
    for record in records:
        record.cleaned_seq = record.sequence.upper().replace("N", "A")
        yield record


class ReadBundle:
    """A read or read pair, with coverage queries
    (reference khmer/utils.py:228-246)."""

    def __init__(self, *raw_records):
        self.reads = [i for i in raw_records if i]

    def coverages(self, graph):
        return [graph.get_median_count(r.cleaned_seq)[0] for r in self.reads]

    def coverages_at_least(self, graph, coverage):
        return all(graph.median_at_least(r.cleaned_seq, coverage)
                   for r in self.reads)

    @property
    def num_reads(self):
        return len(self.reads)

    @property
    def total_length(self):
        return sum(len(r.sequence) for r in self.reads)
