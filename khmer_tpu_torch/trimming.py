"""Read trimming on k-mer abundance (a copy of khmer_tpu/trimming.py;
parity: reference khmer/trimming.py:65-95)."""

import numpy as np

from khmer_tpu_torch.io.fastx import Read


def trim_record_from_first_bad(ksize, record, w, first_bad):
    """trim_record decision from the device-computed first-bad-window
    index (w = the row's window count, first_bad = first window whose
    adjusted count was < cutoff, or >= w when none) — identical
    decision logic to trim_record_from_counts without fetching the
    count matrix (trim_on_abundance/_trim_where, hashtable.cc:503-570).
    Returns (record_or_None, did_trim)."""
    seq = record.sequence
    if w == 1:
        trim_at = 0
    elif first_bad >= w:
        trim_at = len(seq)
    elif first_bad == 0:
        trim_at = 0
    else:
        trim_at = int(first_bad) + ksize - 1

    if trim_at < ksize:
        return None, True
    if trim_at == len(seq):
        return record, False
    quality = getattr(record, "quality", None)
    if quality is not None:
        trim_rec = Read(name=record.name, sequence=seq[:trim_at],
                        quality=quality[:trim_at])
    else:
        trim_rec = Read(name=record.name, sequence=seq[:trim_at])
    return trim_rec, True


def trim_record_from_counts(ksize, record, counts, cutoff,
                            variable_coverage=False, normalize_to=None):
    """trim_record computed from pre-fetched k-mer counts (one device
    batch serves many records); identical decision logic."""
    counts = np.asarray(counts)
    n = counts.size
    if variable_coverage:
        min_req = int(0.5 + n / 2.0)
        if (counts >= normalize_to).sum() < min_req:
            return record, False

    # trim_on_abundance/_trim_where logic (hashtable.cc:503-570)
    seq = record.sequence
    if n == 1:
        trim_at = 0
    else:
        bad = np.nonzero(counts < cutoff)[0]
        if bad.size == 0:
            trim_at = len(seq)
        elif bad[0] == 0:
            trim_at = 0
        else:
            trim_at = int(bad[0]) + ksize - 1

    if trim_at < ksize:
        return None, True
    if trim_at == len(seq):
        return record, False
    quality = getattr(record, "quality", None)
    if quality is not None:
        trim_rec = Read(name=record.name, sequence=seq[:trim_at],
                        quality=quality[:trim_at])
    else:
        trim_rec = Read(name=record.name, sequence=seq[:trim_at])
    return trim_rec, True


def trim_record(countgraph, record, cutoff, variable_coverage=False,
                normalize_to=None):
    """Trim one record at its first low-abundance k-mer.

    Returns (record_or_None, did_trim): None when the trimmed read would
    be shorter than k; unmodified record when nothing was trimmed (or the
    read is below the coverage threshold in variable-coverage mode)."""
    name = record.name
    seq = record.sequence
    seq_clean = record.cleaned_seq

    if variable_coverage:  # only trim when sequence has high enough C
        if not countgraph.median_at_least(seq_clean, normalize_to):
            return record, False

    _, trim_at = countgraph.trim_on_abundance(seq_clean, cutoff)

    if trim_at < countgraph.ksize():
        return None, True

    if trim_at == len(seq):
        return record, False

    trim_seq = seq[:trim_at]
    quality = getattr(record, "quality", None)
    if quality is not None:
        trim_rec = Read(name=name, sequence=trim_seq,
                        quality=quality[:trim_at])
    else:
        trim_rec = Read(name=name, sequence=trim_seq)
    return trim_rec, True
