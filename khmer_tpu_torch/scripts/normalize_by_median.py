#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Eliminate surplus reads by median k-mer abundance (digital
normalization).

% python scripts/normalize-by-median.py [ -C <cutoff> ] <data1> <data2> ...

Kept sequences will be placed in <fileN>.keep.

PyTorch/CUDA port of scripts/normalize-by-median.py: the same flags and
output bytes.  Each batch of `batch` read bundles is one
Countgraph.diginorm_batch call on `device` (kernels K1, K3, K6 and K2);
the keep flags of a batch are read back while the next batch is parsed.
A table that counts past 255 (a loaded .ct with bigcount) takes the
host replay, _drain_host, as khmer_tpu does.  --mqf and --bmqf count in
khmer_tpu's host-exact quotient filter (create_MQFGraph, sized from -U);
its batch step hashes with K8 and decides with K6 over the filter's
keys, which gives the reference's read-by-read result.  Run as
``python -m khmer_tpu_torch.scripts.normalize_by_median``.
"""

import argparse
import os
import sys
import textwrap
from contextlib import contextmanager

import numpy as np

import khmer_tpu_torch as khmer
from khmer_tpu_torch import khmer_args
from khmer_tpu_torch.graph import Countgraph
from khmer_tpu_torch.io.fastx import screed_open
from khmer_tpu_torch.khmer_args import (FileType as khFileType,
                                        add_loadgraph_args,
                                        build_counting_args,
                                        calculate_graphsize,
                                        check_argument_range,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.kfile import (add_output_compression_type, check_space,
                                   check_space_for_graph,
                                   check_valid_file_exists,
                                   describe_file_handle, get_file_writer)
from khmer_tpu_torch.khmer_logger import (configure_logging, log_error,
                                          log_info)
from khmer_tpu_torch.utils import (ReadBundle, broken_paired_reader,
                                   clean_input_reads, write_record)

DEFAULT_DESIRED_COVERAGE = 20
# read bundles per device batch (khmer_tpu's KHMER_TPU_DN_BATCH default).
# The result depends on where batches are cut: a bundle's counts are its
# k-mers' counts before the batch plus the batch's own tally, which is
# what a live read gives except where k-mers of the batch share a bin.
BATCH = 16384


class Normalizer(object):
    """Digital normalization, batched (khmer_tpu's Normalizer): a
    bundle's count for k-mer h is its count before the batch plus the
    tally of h over the bundles kept earlier in the batch, exact because
    sketch counts add up (and saturated reads compare alike against C,
    which never exceeds the cap).  On the device one diginorm_batch call
    decides a batch and consumes its kept reads; _drain_host replays the
    decisions on the host for tables that count past 255."""

    def __init__(self, desired_coverage, countgraph, batch=BATCH,
                 report_fp=None, report_frequency=100000):
        self.countgraph = countgraph
        self.desired_coverage = desired_coverage
        self.batch = batch
        self.total = 0
        self.kept = 0
        # periodic reporting fires inside the sequential host replay,
        # so the report lines carry the exact mid-stream counters
        # (reference WithDiagnostics, normalize-by-median.py:72-152)
        self.report_fp = report_fp
        self.report_frequency = report_frequency
        self.next_report_at = report_frequency
        self.last_report_at = report_frequency
        self.current_file = None

    def _maybe_report(self):
        if self.total < self.next_report_at:
            return
        while self.next_report_at <= self.total:
            self.next_report_at += self.report_frequency
        self.last_report_at = self.total
        perc_kept = self.kept / float(self.total)
        log_info('... kept {kept} of {tot} or {perc_kept:.1%} so'
                 'far', kept=self.kept, tot=self.total,
                 perc_kept=perc_kept)
        log_info('... in file {name}', name=self.current_file)
        if self.report_fp:
            print("{total},{kept},{f_kept:.4}".format(
                total=self.total, f_kept=perc_kept, kept=self.kept),
                file=self.report_fp)
            self.report_fp.flush()

    def _drain(self, pending):
        graph = self.countgraph
        C = self.desired_coverage
        # the whole batch on the device: keep decisions in bundle order
        # (K6), kept k-mers consumed with the exact n_unique claim rule
        # (K2), only the [B] keep flags read back
        seq_pairs = []
        for bundle in pending:
            r0 = bundle.reads[0].cleaned_seq
            r1 = bundle.reads[1].cleaned_seq if len(bundle.reads) > 1 \
                else None
            seq_pairs.append((r0, r1))
        # dispatch now, resolve LAZILY: the caller parses the next
        # batch while this one computes on device
        keeps_dev = graph.diginorm_batch(seq_pairs, C)
        return pending, keeps_dev

    def _emit(self, pending, keeps_dev):
        keeps = keeps_dev.cpu().numpy()
        for i, bundle in enumerate(pending):
            self.total += bundle.num_reads
            if keeps[i]:
                for record in bundle.reads:
                    self.kept += 1
                    yield record
            self._maybe_report()

    def _drain_host(self, pending):
        """Host replay for tables that count past 255 (the device flush
        tracks no bigcount candidates), as khmer_tpu replays it: one K5
        call reads the batch's hashes and counts before the batch."""
        graph = self.countgraph
        C = self.desired_coverage
        seqs = []
        spans = []
        for bundle in pending:
            spans.append((len(seqs), len(seqs) + len(bundle.reads)))
            seqs.extend(r.cleaned_seq for r in bundle.reads)

        pairs = graph._hash_count_rows(seqs)
        # additive tally over COMPACT in-batch ids: the sequential
        # replay's per-read work is then a couple of small numpy ops
        all_h = np.concatenate([r for r, _ in pairs]) if pairs else \
            np.zeros(0, np.uint64)
        uniq, inv = np.unique(all_h, return_inverse=True)
        tally = np.zeros(uniq.shape[0], np.int64)
        offs = np.cumsum([0] + [r.size for r, _ in pairs])
        kept_rows = []
        for i, bundle in enumerate(pending):
            self.total += bundle.num_reads
            lo, hi = spans[i]
            keep = False
            for j in range(lo, hi):
                row, pre = pairs[j]
                n = row.size
                if n == 0:
                    # no k-mers: never "at coverage" (matches the
                    # device median_at_least's `& (n > 0)`)
                    keep = True
                    break
                ids = inv[offs[j]: offs[j + 1]]
                hits = int(((pre.astype(np.int64) + tally[ids]) >= C)
                           .sum())
                if hits < (n + 1) // 2:  # median_at_least inverse
                    keep = True
                    break
            if not keep:
                self._maybe_report()
                continue
            for record, j in zip(bundle.reads, range(lo, hi)):
                np.add.at(tally, inv[offs[j]: offs[j + 1]], 1)
                kept_rows.append(pairs[j][0])
                self.kept += 1
                yield record
            self._maybe_report()
        if kept_rows:
            graph.storage.add_batch(np.concatenate(kept_rows))

    def __call__(self, reader):
        host = getattr(self.countgraph, "get_use_bigcount",
                       lambda: False)()
        pending = []
        inflight = None  # (bundles, device keep flags) one batch behind
        for _, is_paired, read0, read1 in reader:
            pending.append(ReadBundle(read0, read1))
            if len(pending) >= self.batch:
                if host:
                    yield from self._drain_host(pending)
                else:
                    nxt = self._drain(pending)
                    if inflight is not None:
                        yield from self._emit(*inflight)
                    inflight = nxt
                pending = []
        if pending:
            if host:
                yield from self._drain_host(pending)
            else:
                nxt = self._drain(pending)
                if inflight is not None:
                    yield from self._emit(*inflight)
                inflight = nxt
        if inflight is not None:
            yield from self._emit(*inflight)


@contextmanager
def catch_io_errors(ifile, out, single_out, force, corrupt_files):
    """Boilerplate handling of IOErrors (reference :202-218)."""
    try:
        yield
    except (IOError, OSError, ValueError) as error:
        log_error('** ERROR: {error}', error=str(error))
        log_error('** Failed on {name}: ', name=ifile)
        if not single_out:
            os.remove(out.name)
        if not force:
            log_error('** Exiting!')
            sys.exit(1)
        else:
            log_error('*** Skipping error file, moving on...')
            corrupt_files.append(ifile)


def get_parser():
    epilog = """\
    Discard sequences based on whether or not their median k-mer abundance
    lies above a specified cutoff. Kept sequences will be placed in
    <fileN>.keep.

    Example::

        normalize-by-median.py -k 17 tests/test-data/test-abund-read-2.fa
    """
    parser = build_counting_args(
        descr="Do digital normalization (remove mostly redundant sequences)",
        epilog=textwrap.dedent(epilog),
        citations=['diginorm'])
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('-C', '--cutoff', help="when the median "
                        "k-mer coverage level is above this number the "
                        "read is not kept.",
                        type=check_argument_range(0, 256, "cutoff"),
                        default=DEFAULT_DESIRED_COVERAGE)
    parser.add_argument('-p', '--paired', action='store_true',
                        help='require that all sequences be properly paired')
    parser.add_argument('--force_single', dest='force_single',
                        action='store_true',
                        help='treat all sequences as single-ended/unpaired')
    parser.add_argument('-u', '--unpaired-reads',
                        metavar="unpaired_reads_filename",
                        help='include a file of unpaired reads to which '
                        '-p/--paired does not apply.')
    parser.add_argument('-s', '--savegraph', metavar="filename", default=None,
                        help='save the k-mer countgraph to disk after all '
                        'reads are loaded.')
    parser.add_argument('-R', '--report',
                        help='write progress report to report_filename',
                        metavar='report_filename',
                        type=argparse.FileType('w'))
    parser.add_argument('--report-frequency',
                        metavar='report_frequency', type=int, default=100000,
                        help='report progress every report_frequency reads')
    parser.add_argument('-f', '--force', dest='force',
                        help='continue past file reading errors',
                        action='store_true')
    parser.add_argument('-o', '--output', metavar="filename",
                        type=khFileType('wb'),
                        default=None, dest='single_output_file',
                        help='only output a single file with '
                        'the specified filename; use a single dash "-" to '
                        'specify that output should go to STDOUT (the '
                        'terminal)')
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        help='Input FAST[AQ] sequence filename.', nargs='+')
    add_loadgraph_args(parser)
    add_output_compression_type(parser)
    parser.add_argument('--mqf', dest='mqf', default=False,
                        action='store_true')
    parser.add_argument('--bmqf', dest='bmqf', default=False,
                        action='store_true')
    return parser


def main(argv=None, device=None, batch=BATCH):
    # pylint: disable=too-many-branches,too-many-statements
    parser = sanitize_help(get_parser())
    args = parser.parse_args(argv)

    configure_logging(args.quiet)
    report_on_config(args)

    report_fp = args.report
    force_single = args.force_single

    # check for duplicate output basenames
    filenames = []
    basenames = []
    for pathfilename in args.input_filenames:
        filenames.append(pathfilename)
        if args.single_output_file:
            continue
        basename = os.path.basename(pathfilename)
        if basename in basenames:
            log_error('ERROR: Duplicate filename--Cannot handle this!')
            log_error('** Exiting!')
            sys.exit(1)
        basenames.append(basename)

    check_valid_file_exists(args.input_filenames)
    check_space(args.input_filenames, args.force)

    if args.savegraph is not None:
        if getattr(args, 'hash_function', 'twobit-exact') != 'twobit-exact':
            log_error('ERROR: cannot save different hash functions yet.')
            sys.exit(1)
        graphsize = calculate_graphsize(args, 'countgraph')
        check_space_for_graph(args.savegraph, graphsize, args.force)

    if args.loadgraph:
        log_info('loading k-mer countgraph from {graph}',
                 graph=args.loadgraph)
        countgraph = Countgraph.load(args.loadgraph, device=device)
    elif args.mqf or args.bmqf:
        countgraph = khmer_args.create_MQFGraph(args, device=device)
    else:
        log_info('making countgraph')
        countgraph = khmer_args.create_counttable(args, device=device)

    norm = Normalizer(args.cutoff, countgraph, batch=batch,
                      report_fp=report_fp,
                      report_frequency=args.report_frequency)
    if report_fp:
        report_fp.write('total,kept,f_kept\n')

    files = [[f, args.paired] for f in filenames]
    if args.unpaired_reads:
        files.append([args.unpaired_reads, False])

    corrupt_files = []
    outfp = None
    output_name = None

    if args.single_output_file:
        outfp = get_file_writer(args.single_output_file, args.gzip,
                                args.bzip)
    else:
        if '-' in filenames or '/dev/stdin' in filenames:
            print("Accepting input from stdin; output filename must "
                  "be provided with '-o'.", file=sys.stderr)
            sys.exit(1)

    for filename, require_paired in files:
        if not args.single_output_file:
            output_name = os.path.basename(filename) + '.keep'
            outfp = open(output_name, 'wb')
            outfp = get_file_writer(outfp, args.gzip, args.bzip)

        total_start = norm.total
        norm.current_file = filename
        with catch_io_errors(filename, outfp, args.single_output_file,
                             args.force, corrupt_files):
            screed_iter = clean_input_reads(screed_open(filename))
            reader = broken_paired_reader(screed_iter,
                                          min_length=args.ksize,
                                          force_single=force_single,
                                          require_paired=require_paired)
            for record in norm(reader):
                if record is not None:
                    write_record(record, outfp)

            if norm.total == total_start:
                log_info('SKIPPED empty file {name}', name=filename)
            else:
                perc_kept = norm.kept / float(norm.total)
                log_info('DONE with {inp}; kept {kept} of {total} or '
                         '{perc_kept:.1%}', inp=filename, kept=norm.kept,
                         total=norm.total, perc_kept=perc_kept)
            # at least one report per file, at the end of each file
            # (reference normalize-by-median.py:146-152)
            if report_fp and norm.total and \
                    norm.total != norm.last_report_at:
                print("{total},{kept},{f_kept:.4}".format(
                    total=norm.total, kept=norm.kept,
                    f_kept=norm.kept / float(norm.total)), file=report_fp)
                report_fp.flush()

            log_info('output in {name}', name=describe_file_handle(outfp))
            if not args.single_output_file:
                outfp.close()

    log_info('Total number of unique k-mers: {umers}',
             umers=countgraph.n_unique_kmers())

    if args.savegraph is not None:
        log_info('...saving to {name}', name=args.savegraph)
        countgraph.save(args.savegraph)

    fp_rate = \
        khmer.calc_expected_collisions(countgraph, False, max_false_pos=.8)
    # for max_false_pos see Zhang et al., http://arxiv.org/abs/1309.2975

    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)

    if args.force and len(corrupt_files) > 0:
        log_error("** WARNING: Finished with errors!")
        log_error("** I/O Errors occurred in the following files:")
        log_error("\t" + " ".join(corrupt_files))


if __name__ == '__main__':
    main()
