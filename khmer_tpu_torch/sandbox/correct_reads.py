#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Semi-streaming read correction: saturate a countgraph, then align
reads against it with the pair-HMM ReadAligner and emit the corrected
graph sequence.

% python -m khmer_tpu_torch.sandbox.correct_reads [-C cutoff]
    [-Z coverage] <data1> ...

Output is <input>.corr per input (or -o).  PyTorch/CUDA port of
sandbox/correct-reads.py: the same flags, output bytes and stderr lines.
Each batch of 8192 read bundles takes one K5 call for its hashes and
counts; the keep-aside rule replays on the host and the kept reads' k-mers
go in through one add_batch (K2), which also updates the host count
snapshot that the ReadAligner searches (Storage.host_counts), so the
table is copied to the host once.  The table lives on `device` (CUDA
unless told otherwise).
"""

import argparse
import os
import shutil
import sys
import tempfile
import textwrap

import numpy as np

import khmer_tpu_torch as khmer
from khmer_tpu_torch import Countgraph, khmer_args
from khmer_tpu_torch.io.fastx import FastxReader
from khmer_tpu_torch.khmer_args import (add_loadgraph_args,
                                        build_counting_args,
                                        calculate_graphsize, info,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.kfile import (check_space, check_space_for_graph,
                                   check_valid_file_exists)
from khmer_tpu_torch.utils import (broken_paired_reader, write_record,
                                   write_record_pair)

DEFAULT_NORMALIZE_LIMIT = 20
DEFAULT_CUTOFF = 2


def correct_sequence(aligner, sequence, hashes=None):
    if hashes is not None:
        score, graph_alignment, read_alignment, truncated = \
            aligner._align_hashed(sequence, hashes)
    else:
        score, graph_alignment, read_alignment, truncated = \
            aligner.align(sequence)
    if not truncated:
        return True, graph_alignment.replace("-", "")
    return False, sequence


def fix_quality(record):
    if len(record.sequence) < len(record.quality):
        record.quality = record.quality[:len(record.sequence)]
    while len(record.sequence) > len(record.quality):
        record.quality += 'I'  # @CTB hack


def get_parser():
    epilog = """
    The output is one file for each input file, <input file>.corr,
    placed in the current directory.  This output contains the input
    sequences, corrected at low-abundance k-mers.

    Example::

        correct-reads.py -x 5e7 -k 20 -C 2 data/100k-filtered.fa
    """
    parser = build_counting_args(
        descr='Correct reads using a semi-streaming algorithm.',
        epilog=textwrap.dedent(epilog))
    parser.add_argument('input_filenames', nargs='+')
    parser.add_argument('--cutoff', '-C', type=int,
                        help='k-mers below this abundance are not trusted',
                        default=DEFAULT_CUTOFF)
    parser.add_argument('--normalize-to', '-Z', type=int,
                        help='base cutoff on this median k-mer abundance',
                        default=DEFAULT_NORMALIZE_LIMIT)
    parser.add_argument('-o', '--out', metavar="filename",
                        type=argparse.FileType('w'),
                        default=None, help='only output a single file '
                        'with the specified filename')
    parser.add_argument('--variable-coverage', '-V', action='store_true',
                        default=False,
                        help='Only correct sequences that have high '
                        'coverage.')
    add_loadgraph_args(parser)
    parser.add_argument('-s', '--savegraph', metavar="filename",
                        default='',
                        help='save the k-mer countgraph to disk after all'
                        'reads are loaded.')
    parser.add_argument('--force', default=False, action='store_true')
    parser.add_argument('--ignore-pairs', default=False,
                        action='store_true')
    parser.add_argument('--tempdir', '-T', type=str, default='./')
    parser.add_argument("--theta", dest="bits_theta", type=float,
                        default=1.0)
    return parser


def main(argv=None, device=None):
    info('correct-reads.py', ['streaming'])
    args = sanitize_help(get_parser()).parse_args(argv)

    if len(set(args.input_filenames)) != len(args.input_filenames):
        print("Error: Cannot input the same filename multiple times.",
              file=sys.stderr)
        sys.exit(1)

    NORMALIZE_LIMIT = args.normalize_to

    check_valid_file_exists(args.input_filenames)
    check_space(args.input_filenames, args.force)
    if args.savegraph:
        check_space_for_graph(
            args.savegraph, calculate_graphsize(args, 'countgraph'),
            args.force)

    report_on_config(args)

    if args.loadgraph:
        print('loading k-mer countgraph from', args.loadgraph,
              file=sys.stderr)
        ct = Countgraph.load(args.loadgraph, device=device)
    else:
        print('making k-mer countgraph', file=sys.stderr)
        ct = khmer_args.create_countgraph(args, device=device)

    K = ct.ksize()

    tempdir = tempfile.mkdtemp('khmer', 'tmp', args.tempdir)
    print('created temporary directory %s; use -T to change location'
          % tempdir, file=sys.stderr)

    aligner = khmer.ReadAligner(ct, args.cutoff, args.bits_theta)

    # ### FIRST PASS ###

    save_pass2_total = 0
    n_bp = 0
    n_reads = 0
    written_reads = 0
    written_bp = 0
    corrected_reads = 0

    def correct_and_write(read, corrfp, hashes=None):
        nonlocal corrected_reads, written_reads, written_bp
        seq = read.sequence.replace('N', 'A')
        is_aligned, new_seq = correct_sequence(aligner, seq, hashes)
        if is_aligned:
            if new_seq != read.sequence:
                corrected_reads += 1
            read.sequence = new_seq
            if getattr(read, 'quality', None) is not None:
                fix_quality(read)
        write_record(read, corrfp)
        written_reads += 1
        written_bp += len(read.sequence)

    pass2list = []
    for filename in args.input_filenames:
        pass2filename = os.path.join(
            tempdir, os.path.basename(filename) + '.pass2')
        if args.out is None:
            corrfp = open(os.path.basename(filename) + '.corr', 'w')
        else:
            corrfp = args.out

        pass2list.append((filename, pass2filename, corrfp))

        pass2fp = open(pass2filename, 'w')
        save_pass2 = 0
        n = 0

        paired_iter = broken_paired_reader(
            FastxReader(filename), min_length=K,
            force_single=args.ignore_pairs)

        # batched pass 1: one K5 call hashes and pre-counts every read
        # of a batch; the sequential keep-aside decision replays on the
        # host with an additive tally of the batch's kept k-mers (exact,
        # as in normalize-by-median); corrections run through the native
        # aligner against the host count snapshot, which add_batch keeps
        # coherent without copying the table again.
        def process_batch(bundles):
            nonlocal save_pass2, n_reads, n_bp
            seqs = []
            spans = []
            for is_pair, r1, r2 in bundles:
                reads = [r1, r2] if is_pair else [r1]
                spans.append((len(seqs), len(seqs) + len(reads)))
                seqs.extend(r.sequence.replace('N', 'A')
                            for r in reads)
                n_reads += len(reads)
                n_bp += sum(len(r.sequence) for r in reads)
            pairs = ct._hash_count_rows(seqs)
            all_h = np.concatenate([r for r, _ in pairs]) if pairs \
                else np.zeros(0, np.uint64)
            uniq, inv = np.unique(all_h, return_inverse=True)
            tally = np.zeros(uniq.shape[0], np.int64)
            offs = np.cumsum([0] + [r.size for r, _ in pairs])
            pending = []
            for (is_pair, r1, r2), (lo, hi) in zip(bundles, spans):
                reads = [r1, r2] if is_pair else [r1]
                meds = []
                for j in range(lo, hi):
                    cur = pairs[j][1].astype(np.int64) + \
                        tally[inv[offs[j]: offs[j + 1]]]
                    meds.append(int(np.sort(cur)[cur.size // 2]))
                if min(meds) < NORMALIZE_LIMIT:
                    for j in range(lo, hi):
                        pending.append(pairs[j][0])
                        np.add.at(tally, inv[offs[j]: offs[j + 1]], 1)
                    if is_pair:
                        write_record_pair(r1, r2, pass2fp)
                    else:
                        write_record(r1, pass2fp)
                    nonlocal_save = hi - lo
                    save_pass2 += nonlocal_save
                else:
                    for r, j in zip(reads, range(lo, hi)):
                        correct_and_write(r, corrfp,
                                          hashes=pairs[j][0])
            if pending:
                ct.storage.add_batch(np.concatenate(pending))

        batch = []
        n = 0
        for n, is_pair, read1, read2 in paired_iter:
            if n % 10000 == 0:
                print('...', n, filename, save_pass2, n_reads, n_bp,
                      written_reads, written_bp, file=sys.stderr)
            batch.append((is_pair, read1, read2))
            if len(batch) >= 8192:
                process_batch(batch)
                batch = []
        if batch:
            process_batch(batch)

        pass2fp.close()
        print('%s: kept aside %d of %d from first pass'
              % (filename, save_pass2, n), file=sys.stderr)
        save_pass2_total += save_pass2

    # ### SECOND PASS ###

    skipped_n = 0
    skipped_bp = 0
    for _, pass2filename, corrfp in pass2list:
        print('second pass: looking at sequences kept aside in %s'
              % pass2filename, file=sys.stderr)
        # batched pass 2 (no adds: one K5 call per batch is exact)
        def process_batch2(reads):
            nonlocal skipped_n, skipped_bp
            seqs = [r.sequence.replace('N', 'A') for r in reads]
            pairs = ct._hash_count_rows(seqs)
            for read, (hashes, counts) in zip(reads, pairs):
                med = int(np.sort(counts)[counts.size // 2])
                if med < NORMALIZE_LIMIT and args.variable_coverage:
                    write_record(read, corrfp)
                    skipped_n += 1
                    skipped_bp += len(read.sequence)
                else:
                    correct_and_write(read, corrfp, hashes=hashes)

        batch2 = []
        for n, read in enumerate(FastxReader(pass2filename)):
            if n % 10000 == 0:
                print('... x 2', n, pass2filename, written_reads,
                      written_bp, file=sys.stderr)
            if len(read.sequence) < K:
                write_record(read, corrfp)
                written_reads += 1
                written_bp += len(read.sequence)
                continue
            batch2.append(read)
            if len(batch2) >= 8192:
                process_batch2(batch2)
                batch2 = []
        if batch2:
            process_batch2(batch2)

        print('removing %s' % pass2filename, file=sys.stderr)
        os.unlink(pass2filename)

    print('removing temp directory & contents (%s)' % tempdir,
          file=sys.stderr)
    shutil.rmtree(tempdir)

    print('read %d reads, %d bp' % (n_reads, n_bp), file=sys.stderr)
    print('wrote %d reads, %d bp' % (written_reads, written_bp),
          file=sys.stderr)
    print('looked at %d reads twice' % save_pass2_total, file=sys.stderr)
    print('corrected %d reads' % corrected_reads, file=sys.stderr)
    if args.variable_coverage:
        print('skipped %d reads/%d bases because of low coverage'
              % (skipped_n, skipped_bp), file=sys.stderr)

    fp_rate = \
        khmer.calc_expected_collisions(ct, args.force, max_false_pos=.8)
    # for max_false_pos see Zhang et al., http://arxiv.org/abs/1309.2975
    print('fp rate estimated to be {fpr:1.3f}'.format(fpr=fp_rate),
          file=sys.stderr)

    print('output in *.corr', file=sys.stderr)

    if args.savegraph:
        print('saving k-mer countgraph to', args.savegraph,
              file=sys.stderr)
        ct.save(args.savegraph)


if __name__ == '__main__':
    main()
