#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Trim sequences at k-mers of the given abundance, using a streaming
algorithm.

Output sequences will be placed in 'infile.abundtrim'.

% python scripts/trim-low-abund.py [ <data1> [ <data2> [ ... ] ] ]

PyTorch/CUDA port of scripts/trim-low-abund.py: the same flags, two-pass
streaming semantics and output bytes.  Pass 1 is one
Countgraph.trim_pass1_batch call per batch of `batch` read bundles on
`device` (kernels K1, K3, K7 and K2); pass 2 reads counts with K5.  With
--mqf the counts live in khmer_tpu's host-exact quotient filter
(create_MQFGraph, sized from -U): K8 hashes, K7 decides over the
filter's keys, and pass 2 reads the filter.  Run as
``python -m khmer_tpu_torch.scripts.trim_low_abund``.
"""

import csv
import json
import os
import shutil
import sys
import tempfile
import textwrap

import numpy as np

import khmer_tpu_torch as khmer
from khmer_tpu_torch import khmer_args
from khmer_tpu_torch.graph import Countgraph, SmallCountgraph
from khmer_tpu_torch.io.fastx import FastxReader as ReadParser
from khmer_tpu_torch.khmer_args import (FileType as khFileType,
                                        add_loadgraph_args,
                                        build_counting_args,
                                        calculate_graphsize,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.kfile import (add_output_compression_type, check_space,
                                   check_space_for_graph,
                                   check_valid_file_exists, get_file_writer)
from khmer_tpu_torch.khmer_logger import (configure_logging, log_error,
                                          log_info)
from khmer_tpu_torch.trimming import (trim_record_from_counts,
                                      trim_record_from_first_bad)
from khmer_tpu_torch.utils import (ReadBundle, broken_paired_reader,
                                   write_record)

DEFAULT_TRIM_AT_COVERAGE = 20
DEFAULT_CUTOFF = 2
DEFAULT_DIGINORM_COVERAGE = 20

REPORT_EVERY_N_READS = 10000
# read bundles per device batch (khmer_tpu's KHMER_TPU_TRIM_BATCH
# default); as in normalize-by-median, the result depends on where
# batches are cut
BATCH = 16384


def get_parser():
    epilog = """\
    The output is one file for each input file, ``<input file>.abundtrim``,
    placed in the current directory.  This output contains the input
    sequences trimmed at low-abundance k-mers.

    The :option:`-V`/:option:`--variable-coverage` parameter will, if
    specified, prevent elimination of low-abundance reads by only trimming
    low-abundance k-mers from high-abundance reads; use this for
    non-genomic data sets that may have variable coverage.

    Example::

        trim-low-abund.py -x 5e7 -k 20 -C 2 data/100k-filtered.fa
    """
    parser = build_counting_args(
        descr='Trim low-abundance k-mers using a streaming algorithm.',
        epilog=textwrap.dedent(epilog),
        citations=['streaming'])
    parser.add_argument('input_filenames', nargs='+')
    parser.add_argument('-C', '--cutoff', type=int,
                        help='remove k-mers below this abundance',
                        default=DEFAULT_CUTOFF)
    parser.add_argument('-Z', '--trim-at-coverage', '--normalize-to',
                        type=int,
                        help='trim reads when entire read above this '
                        'coverage', default=DEFAULT_TRIM_AT_COVERAGE)
    parser.add_argument('-o', '--output', metavar="output_filename",
                        type=khFileType('wb'),
                        help='only output a single file with '
                        'the specified filename; use a single dash "-" to '
                        'specify that output should go to STDOUT (the '
                        'terminal)')
    parser.add_argument('-V', '--variable-coverage', action='store_true',
                        default=False,
                        help='Only trim low-abundance k-mers from sequences '
                        'that have high coverage.')
    add_loadgraph_args(parser)
    parser.add_argument('-s', '--savegraph', metavar="filename", default='',
                        help='save the k-mer countgraph to disk after all'
                        'reads are loaded.')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('--summary-info', type=str, default=None,
                        metavar="FORMAT", choices=['json', 'tsv'],
                        help="What format should the machine readable run "
                        "summary be in? (`json` or `tsv`, disabled by"
                        " default)")
    parser.add_argument('--force', default=False, action='store_true')
    parser.add_argument('--ignore-pairs', default=False, action='store_true',
                        help='treat all reads as if they were singletons')
    parser.add_argument('-T', '--tempdir', type=str, default='./',
                        help="Set location of temporary directory for "
                        "second pass")
    add_output_compression_type(parser)
    parser.add_argument('--diginorm', default=False, action='store_true',
                        help="Eliminate high-coverage reads altogether "
                        "(digital normalization).")
    parser.add_argument('--diginorm-coverage', type=int,
                        default=DEFAULT_DIGINORM_COVERAGE,
                        help="Coverage threshold for --diginorm")
    parser.add_argument('--single-pass', default=False, action='store_true',
                        help="Do not do a second pass across the low "
                        "coverage data")
    parser.add_argument('--mqf', dest='mqf', default=False,
                        action='store_true')
    return parser


class Trimmer(object):
    """Core two-pass streaming trimmer (reference trim-low-abund.py:
    170-283), batched as khmer_tpu batches it: a bundle's count for a
    k-mer is its count before the batch plus its tally over the bundles
    saved earlier in the batch, exact because sketch counts add up
    (saturated reads compare alike against the small thresholds)."""

    def __init__(self, graph, do_trim_low_abund, cutoff, trim_at_coverage,
                 batch=BATCH):
        self.batch = batch
        self.graph = graph
        self.do_trim_low_abund = do_trim_low_abund
        self.cutoff = cutoff
        self.trim_at_coverage = trim_at_coverage

        self.n_reads = 0
        self.n_bp = 0
        self.trimmed_reads = 0
        self.n_saved = 0
        self.n_skipped = 0
        self.bp_skipped = 0

        self.do_normalize = False
        self.diginorm_coverage = None

    def set_diginorm(self, coverage):
        self.do_normalize = True
        self.diginorm_coverage = coverage

    @staticmethod
    def _median(counts):
        if counts.size == 0:
            raise ValueError("no k-mer counts; read too short?")
        return int(np.sort(counts)[counts.size // 2])

    def _pass1_batch(self, bundles, saver):
        """The whole batch on the device (hashtable.trim_pass1_batch):
        branches in bundle order (K7), saved bundles consumed with the
        exact n_unique claim rule (K2); only the [B] branches and the
        [2B] first bad windows are read back."""
        graph = self.graph
        cutoff = self.cutoff
        k = graph.ksize()

        seq_pairs = []
        for bundle in bundles:
            r0 = bundle.reads[0].cleaned_seq
            r1 = bundle.reads[1].cleaned_seq if len(bundle.reads) > 1 \
                else None
            seq_pairs.append((r0, r1))
        branch, first_bad = graph.trim_pass1_batch(
            seq_pairs, self.trim_at_coverage,
            self.diginorm_coverage if self.do_normalize else None,
            cutoff=cutoff)
        branch = branch.cpu().numpy()
        first_bad = first_bad.cpu().numpy()
        for i, bundle in enumerate(bundles):
            self.n_reads += bundle.num_reads
            self.n_bp += bundle.total_length
            if branch[i] == 0:           # diginorm skip
                continue
            if branch[i] == 1:           # at coverage: trim now
                for j, read in enumerate(bundle.reads):
                    w = len(read.cleaned_seq) - k + 1
                    record, did_trim = trim_record_from_first_bad(
                        k, read, w, first_bad[2 * i + j])
                    if did_trim:
                        self.trimmed_reads += 1
                    if record:
                        yield record
            else:                        # saved (consumed on device)
                for read in bundle.reads:
                    write_record(read, saver)
                    self.n_saved += 1

    def pass1(self, reader, saver):
        batch = []
        for _, is_pair, read1, read2 in reader:
            bundle = ReadBundle(read1, read2)
            batch.append(bundle)
            if len(batch) >= self.batch:
                yield from self._pass1_batch(batch, saver)
                batch = []
        if batch:
            yield from self._pass1_batch(batch, saver)

    def _pass2_batch(self, bundles):
        # pass2 never consumes, so one batched fetch is exact
        graph = self.graph
        k = graph.ksize()
        seqs = []
        spans = []
        for bundle in bundles:
            spans.append((len(seqs), len(seqs) + len(bundle.reads)))
            seqs.extend(r.cleaned_seq for r in bundle.reads)
        hc = graph.count_rows(seqs)

        for bundle, (lo, hi) in zip(bundles, spans):
            self.n_reads += bundle.num_reads
            self.n_bp += bundle.total_length
            rows = hc[lo:hi]
            at_cov = all(
                self._median(c) >= self.trim_at_coverage for c in rows)
            if self.do_trim_low_abund or at_cov:
                for read, counts in zip(bundle.reads, rows):
                    trimmed_record, did_trim = trim_record_from_counts(
                        k, read, counts, self.cutoff)
                    if did_trim:
                        self.trimmed_reads += 1
                    if trimmed_record:
                        yield trimmed_record
            else:
                for read in bundle.reads:
                    self.n_skipped += 1
                    self.bp_skipped += len(read)
                    yield read

    def pass2(self, reader):
        batch = []
        for _, is_pair, read1, read2 in reader:
            bundle = ReadBundle(read1, read2)
            batch.append(bundle)
            if len(batch) >= self.batch:
                yield from self._pass2_batch(batch)
                batch = []
        if batch:
            yield from self._pass2_batch(batch)


def store_provenance_info(info, fname, format='json'):
    format = format.lower() if format is not None else 'json'
    fname = '{}.info.{}'.format(fname, format)
    if format == 'json':
        with open(fname, 'w') as f:
            json.dump(info, f)
            f.write('\n')
    elif format == 'tsv':
        with open(fname, 'w') as f:
            tsv = csv.DictWriter(f, fieldnames=info.keys(),
                                 dialect='excel-tab')
            tsv.writeheader()
            tsv.writerow(info)
    else:
        raise RuntimeError("File format has to be one of json or tsv"
                           " not {}.".format(format))


def main(argv=None, device=None, batch=BATCH):
    parser = sanitize_help(get_parser())
    args = parser.parse_args(argv)

    configure_logging(args.quiet)

    if len(set(args.input_filenames)) != len(args.input_filenames):
        log_error("Error: Cannot input the same filename multiple times.")
        sys.exit(1)

    if args.trim_at_coverage != DEFAULT_TRIM_AT_COVERAGE and \
       not args.variable_coverage:
        log_error("Error: --trim-at-coverage/-Z given, but "
                  "--variable-coverage/-V not specified.")
        sys.exit(1)

    if args.diginorm_coverage != DEFAULT_DIGINORM_COVERAGE and \
       not args.diginorm:
        log_error("Error: --diginorm-coverage given, but "
                  "--diginorm not specified.")
        sys.exit(1)

    if args.diginorm and args.single_pass:
        log_error("Error: --diginorm and --single-pass are incompatible!\n"
                  "You probably want to use normalize-by-median.py instead.")
        sys.exit(1)

    graphtype = 'countgraph' if not args.small_count else 'smallcountgraph'
    report_on_config(args, graphtype=graphtype)
    check_valid_file_exists(args.input_filenames)
    check_space(args.input_filenames, args.force)
    if args.savegraph:
        if getattr(args, 'hash_function', 'twobit-exact') != 'twobit-exact':
            log_error('ERROR: cannot save different hash functions yet.')
            sys.exit(1)

        graphsize = calculate_graphsize(args, graphtype)
        check_space_for_graph(args.savegraph, graphsize, args.force)

    if ('-' in args.input_filenames or
            '/dev/stdin' in args.input_filenames) and not args.output:
        log_error("Accepting input from stdin; output filename must "
                  "be provided with -o.")
        sys.exit(1)

    if args.loadgraph:
        log_info('loading countgraph from {graph}', graph=args.loadgraph)
        table_class = SmallCountgraph if args.small_count else Countgraph
        ct = table_class.load(args.loadgraph, device=device)
    elif args.mqf:
        log_info('making MQF')
        ct = khmer_args.create_MQFGraph(args, device=device)
    else:
        log_info('making countgraph')
        ct = khmer_args.create_counttable(args, device=device)

    K = ct.ksize()
    tempdir = tempfile.mkdtemp('khmer', 'tmp', args.tempdir)
    log_info('created temporary directory {temp};\n'
             'use -T to change location', temp=tempdir)

    trimmer = Trimmer(ct, not args.variable_coverage, args.cutoff,
                      args.trim_at_coverage, batch=batch)
    if args.diginorm:
        trimmer.set_diginorm(args.diginorm_coverage)

    # ### FIRST PASS ###

    written_bp = 0
    written_reads = 0

    if args.output:
        trimfp = get_file_writer(args.output, args.gzip, args.bzip)

    pass2list = []
    for filename in args.input_filenames:
        pass2filename = filename.replace(os.path.sep, '-') + '.pass2'
        pass2filename = os.path.join(tempdir, pass2filename)
        pass2fp = open(pass2filename, 'w')

        if args.output is None:
            outfp = open(os.path.basename(filename) + '.abundtrim', 'wb')
            trimfp = get_file_writer(outfp, args.gzip, args.bzip)

        pass2list.append((filename, pass2filename, trimfp))

        paired_iter = broken_paired_reader(ReadParser(filename),
                                           min_length=K,
                                           force_single=args.ignore_pairs)

        n_start = trimmer.n_reads
        save_start = trimmer.n_saved

        watermark = REPORT_EVERY_N_READS
        for read in trimmer.pass1(paired_iter, pass2fp):
            if (trimmer.n_reads - n_start) > watermark:
                log_info("... {filename} {n_saved} {n_reads} {n_bp} "
                         "{w_reads} {w_bp}", filename=filename,
                         n_saved=trimmer.n_saved, n_reads=trimmer.n_reads,
                         n_bp=trimmer.n_bp, w_reads=written_reads,
                         w_bp=written_bp)
                watermark += REPORT_EVERY_N_READS
            write_record(read, trimfp)
            written_bp += len(read)
            written_reads += 1
        pass2fp.close()

        log_info("{filename}: kept aside {kept} of {total} from first pass",
                 filename=filename, kept=trimmer.n_saved - save_start,
                 total=trimmer.n_reads - n_start)

    n_reads = trimmer.n_reads
    n_bp = trimmer.n_bp
    save_pass2_total = trimmer.n_saved

    # ### SECOND PASS ###

    assert trimmer.n_skipped == 0
    assert trimmer.bp_skipped == 0

    if args.single_pass:
        pass2list = []

    for _, pass2filename, trimfp in pass2list:
        log_info('second pass: looking at sequences kept aside in {pass2}',
                 pass2=pass2filename)
        paired_iter = broken_paired_reader(ReadParser(pass2filename),
                                           min_length=K,
                                           force_single=True)
        for read in trimmer.pass2(paired_iter):
            write_record(read, trimfp)
            written_reads += 1
            written_bp += len(read)

        log_info('removing {pass2}', pass2=pass2filename)
        os.unlink(pass2filename)

        if not args.output:
            trimfp.close()

    try:
        log_info('removing temp directory & contents ({temp})',
                 temp=tempdir)
        shutil.rmtree(tempdir)
    except OSError:
        log_info('WARNING: unable to remove {temp}; please remove manually',
                 temp=tempdir)

    trimmed_reads = trimmer.trimmed_reads

    n_passes = 1.0 + (float(save_pass2_total) / n_reads) if n_reads else 1.0
    percent_reads_trimmed = (
        float(trimmed_reads + (n_reads - written_reads)) /
        n_reads * 100.0) if n_reads else 0.0

    log_info('read {read} reads, {bp} bp', read=n_reads, bp=n_bp)
    log_info('wrote {wr} reads, {wbp} bp', wr=written_reads, wbp=written_bp)
    log_info('looked at {st} reads twice ({np:.2f} passes)',
             st=save_pass2_total, np=n_passes)
    log_info('removed {r} reads and trimmed {t} reads ({p:.2f}%)',
             r=n_reads - written_reads, t=trimmed_reads,
             p=percent_reads_trimmed)
    if n_bp:
        log_info('trimmed or removed {p:.2f}%% of bases ({bp} total)',
                 p=(1 - (written_bp / float(n_bp))) * 100.0,
                 bp=n_bp - written_bp)

    if args.variable_coverage:
        percent_reads_hicov = 100.0 * float(n_reads - trimmer.n_skipped) / \
            n_reads if n_reads else 0.0
        log_info('{percent:.2f}%% reads were high coverage ({n} of {total})',
                 percent=percent_reads_hicov,
                 n=n_reads - trimmer.n_skipped, total=n_reads)
        log_info('skipped {n} reads/{bp} bases because of low coverage',
                 n=trimmer.n_skipped, bp=trimmer.bp_skipped)

    fp_rate = khmer.calc_expected_collisions(ct, args.force,
                                             max_false_pos=.8)
    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)

    if args.output is None:
        log_info('output in *.abundtrim')
    elif getattr(args.output, 'name', None) in (1, '/dev/stdout'):
        log_info('output streamed to stdout')
    elif getattr(args.output, 'name', None):
        log_info('output in {}'.format(args.output.name))

    if args.savegraph:
        log_info("Saving k-mer countgraph to {graph}", graph=args.savegraph)
        ct.save(args.savegraph)

    if args.summary_info is not None:
        # when -o names a real file, the summary is <that name>.info.*;
        # stdout streams / no -o get a timestamped default name
        # (reference trim-low-abund.py:563-571)
        import time as _time

        outname = getattr(args.output, 'name', None) if args.output \
            else None
        if outname not in (None, 1, '/dev/stdout'):
            base = outname
        else:
            base = 'trim-low-abund-{}'.format(
                _time.strftime("%Y-%m-%dT%H:%M:%S"))
        info = {
            'fpr': fp_rate,
            'reads': n_reads,
            'basepairs': n_bp,
            'reads_written': written_reads,
            'basepairs_written': written_bp,
            'reads_skipped': trimmer.n_skipped,
            'basepairs_skipped': trimmer.bp_skipped,
            'reads_removed': n_reads - written_reads,
            'reads_trimmed': trimmed_reads,
            'basepairs_removed_or_trimmed': n_bp - written_bp,
        }
        store_provenance_info(info, fname=base,
                              format=args.summary_info)


if __name__ == '__main__':
    main()
