#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Use a partitioned or labeled reference to sort reads by label:
sweep reads into per-label output files.

% python -m khmer_tpu_torch.sandbox.sweep_reads -r <range> \\
       <reference fastp> <reads1> <reads2> ... <readsN>

PyTorch/CUDA port of sandbox/sweep-reads.py (buffered multi-file output,
label-by-pid/seq/group modes): the same flags, output bytes and stderr
lines.  The reference is consumed in batches of reads (one K1 pass and
one K2 call each), and the reads are swept SWEEP_BATCH at a time with
one count probe a level (GraphLabels.sweep_label_neighborhood_batch,
read for read what one sweep a read gives); the graph lives on `device`
(CUDA unless told otherwise).
"""

import os
import sys
from collections import defaultdict

from khmer_tpu_torch import GraphLabels
from khmer_tpu_torch.io.fastx import FastxReader
from khmer_tpu_torch.kfile import (check_input_files, check_space,
                                   check_valid_file_exists)
from khmer_tpu_torch.khmer_args import (build_nodegraph_args, info,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.utils import write_record

DEFAULT_NUM_BUFFERS = 50000
DEFAULT_MAX_READS = 1000000
DEFAULT_BUFFER_SIZE = 10
DEFAULT_OUT_PREF = 'reads'
DEFAULT_RANGE = None

MAX_HSIZE = 4e7
MIN_KSIZE = 21
SWEEP_BATCH = 8192  # reads swept together; any batch labels the same


def fmt_fasta(name, seq, labels=()):
    return '>{name}\t{labels}\n{seq}\n'.format(
        name=name, labels='\t'.join(str(l) for l in labels), seq=seq)


def fmt_fastq(name, seq, quality, labels=()):
    return '@{name}\t{labels}\n{seq}\n+\n{acc}\n'.format(
        name=name, labels='\t'.join(str(l) for l in labels), seq=seq,
        acc=quality)


class ReadBuffer(object):

    def __init__(self):
        self.buf = []

    def push(self, seq_str):
        self.buf.append(seq_str)

    def flush(self):
        return ''.join(self.buf)

    def __len__(self):
        return len(self.buf)


class ReadBufferManager(object):
    """Buffered many-file writer (reference sweep-reads.py:100-180)."""

    def __init__(self, max_buffers, max_reads, max_size, output_pref,
                 outdir, extension):
        self.buffers = {}
        self.max_buffers = max_buffers
        self.max_reads = max_reads
        self.extension = extension
        self.output_pref = output_pref
        self.outdir = outdir
        self.buffer_flush = max_size
        self.cur_reads = 0
        self.num_write_errors = 0
        self.num_file_errors = 0

    def flush_buffer(self, buf_id):
        fn = '{prefix}_{buffer_id}.{ext}'.format(
            prefix=self.output_pref, buffer_id=buf_id, ext=self.extension)
        fpath = os.path.join(self.outdir, fn)
        buf = self.buffers[buf_id]
        try:
            outfp = open(fpath, 'a')
        except (IOError, OSError) as err:
            print('!! ERROR: {} !!'.format(err), file=sys.stderr)
            self.num_file_errors += 1
        else:
            outfp.write(buf.flush())
            outfp.close()
        finally:
            self.cur_reads -= len(buf)
            del self.buffers[buf_id]

    def queue(self, seq_str, buf_id):
        if buf_id in self.buffers:
            self.buffers[buf_id].push(seq_str)
            if len(self.buffers[buf_id]) > self.buffer_flush:
                self.flush_buffer(buf_id)
        else:
            new_buf = ReadBuffer()
            new_buf.push(seq_str)
            self.buffers[buf_id] = new_buf

        self.cur_reads += 1
        if self.cur_reads > self.max_reads:
            self.flush_all()
        if len(self.buffers) > self.max_buffers:
            self.flush_all()

    def flush_all(self):
        for buf_id in list(self.buffers.keys()):
            self.flush_buffer(buf_id)
        assert self.cur_reads == 0


def get_parser():
    parser = build_nodegraph_args('Takes a partitioned reference file \
                                  and a list of reads, and sorts reads \
                                  by which partition they connect to')
    parser.epilog = parser.epilog.replace(
        ":doc:`partitioning-big-data`",
        "http://khmer.readthedocs.io/en/stable/user/"
        "partitioning-big-data.html") if parser.epilog else None
    parser.add_argument('-r', '--traversal_range', type=int,
                        dest='traversal_range',
                        default=DEFAULT_RANGE,
                        help='depth of breadth-first search to perform '
                        'from each read')
    parser.add_argument('-b', '--buffer_size', dest='max_reads', type=int,
                        default=DEFAULT_MAX_READS,
                        help='Max total reads to buffer before flushing')
    parser.add_argument('-l', '--buffer_length', dest='buffer_size',
                        type=int, default=DEFAULT_BUFFER_SIZE,
                        help='Max length of an individual label buffer '
                        'before flushing')
    parser.add_argument('--prefix', dest='output_prefix',
                        default=DEFAULT_OUT_PREF,
                        help='Prefix for sorted read files')
    parser.add_argument('--outdir', dest='outdir',
                        help='output directory; default is location of '
                        'fastp file')
    parser.add_argument('-m', '--max_buffers', dest='max_buffers',
                        type=int, default=DEFAULT_NUM_BUFFERS,
                        help='Max individual label buffers before '
                        'flushing')
    labeling = parser.add_mutually_exclusive_group(required=True)
    labeling.add_argument('--label-by-pid', dest='label_by_pid',
                          action='store_true',
                          help='separate reads by reference partition id')
    labeling.add_argument('--label-by-seq', dest='label_by_seq',
                          action='store_true',
                          help='separate reads by reference sequence')
    labeling.add_argument('--label-by-group', dest='group_size', type=int,
                          help='separate reads by arbitrary sized groups '
                          'of reference sequences')
    parser.add_argument(dest='input_fastp',
                        help='Reference fasta or fastp')
    parser.add_argument('input_files', nargs='+',
                        help='Reads to be swept and sorted')
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def main(argv=None, device=None):
    info('sweep-reads-buffered.py', ['sweep'])
    args = sanitize_help(get_parser()).parse_args(argv)

    if args.max_tablesize < MAX_HSIZE:
        args.max_tablesize = MAX_HSIZE
    if args.ksize < MIN_KSIZE:
        args.ksize = MIN_KSIZE

    report_on_config(args, graphtype='nodegraph')

    K = args.ksize
    traversal_range = args.traversal_range
    input_fastp = args.input_fastp

    outdir = args.outdir if args.outdir else os.path.dirname(input_fastp)

    check_input_files(args.input_fastp, args.force)
    check_valid_file_exists(args.input_files)
    check_space([input_fastp] + args.input_files, args.force)

    # figure out input file type (FA/FQ) -- based on first file
    record = next(iter(FastxReader(args.input_files[0])))
    extension = 'fq' if getattr(record, 'quality', None) is not None \
        else 'fa'

    output_buffer = ReadBufferManager(
        args.max_buffers, args.max_reads, args.buffer_size,
        args.output_prefix, outdir, extension)

    # consume the reference, labeling the graph
    ht = GraphLabels.NodeGraphLabels(K, args.max_tablesize, args.n_tables,
                                     device=device)
    print('consuming input sequences...', file=sys.stderr)
    if args.label_by_pid:
        print('...labeling by partition id (pid)', file=sys.stderr)
        ht.consume_partitioned_fasta_and_tag_with_labels(input_fastp)
    elif args.label_by_seq:
        print('...labeling by sequence', file=sys.stderr)
        for n, record in enumerate(FastxReader(input_fastp)):
            if n % 50000 == 0:
                print('...consumed {n} sequences...'.format(n=n),
                      file=sys.stderr)
            ht.consume_sequence_and_tag_with_labels(record.sequence, n)
    else:
        print('...labeling to create groups of size {s}'.format(
            s=args.group_size), file=sys.stderr)
        label = -1
        g = 0
        outfp = open('{pref}_base_{g}.{ext}'.format(
            pref=args.output_prefix, g=g, ext=extension), 'wb')
        for n, record in enumerate(FastxReader(input_fastp)):
            if n % args.group_size == 0:
                label += 1
                if label > g:
                    g = label
                    outfp = open('{pref}_base_{g}.{ext}'.format(
                        pref=args.output_prefix, g=g, ext=extension), 'wb')
            if n % 50000 == 0:
                print('...consumed {n} sequences...'.format(n=n),
                      file=sys.stderr)
            ht.consume_sequence_and_tag_with_labels(record.sequence, label)
            write_record(record, outfp)

    print('done consuming input sequence. added {t} tags and {l} '
          'labels...'.format(t=ht.graph.n_tags, l=ht.n_labels),
          file=sys.stderr)

    label_dict = defaultdict(int)
    label_number_dist = []

    n_orphaned = 0
    n_labeled = 0
    n_mlabeled = 0

    for read_file in args.input_files:
        print('** sweeping {read_file} for labels...'.format(
            read_file=read_file), file=sys.stderr)
        try:
            read_fp = FastxReader(read_file)
        except (IOError, OSError) as error:
            print('!! ERROR: !!', error, file=sys.stderr)
            print('*** Could not open {fn}, skipping...'.format(
                fn=read_file), file=sys.stderr)
            continue
        batch = []

        def sweep(records):
            nonlocal n_labeled, n_mlabeled, n_orphaned
            found = ht.sweep_label_neighborhood_batch(
                [r.sequence for r in records], radius=traversal_range)
            for record, labels in zip(records, found):
                seq = record.sequence
                name = record.name
                label_number_dist.append(len(labels))
                if getattr(record, 'quality', None) is not None:
                    seq_str = fmt_fastq(name, seq, record.quality, labels)
                else:
                    seq_str = fmt_fasta(name, seq, labels)
                if labels:
                    n_labeled += 1
                    if len(labels) > 1:
                        # multi-labeled reads go to ONE 'multi' bucket
                        # (reference sweep-reads.py:384-387)
                        output_buffer.queue(seq_str, 'multi')
                        n_mlabeled += 1
                        label_dict['multi'] += 1
                    else:
                        output_buffer.queue(seq_str, labels[0])
                        label_dict[labels[0]] += 1
                else:
                    n_orphaned += 1
                    output_buffer.queue(seq_str, 'orphaned')
                    label_dict['orphaned'] += 1
            records.clear()

        for record in read_fp:
            if len(record.sequence) < K:
                continue
            batch.append(record)
            if len(batch) >= SWEEP_BATCH:
                sweep(batch)
        if batch:
            sweep(batch)

    output_buffer.flush_all()

    if output_buffer.num_write_errors or output_buffer.num_file_errors:
        print('! WARNING: Sweep finished with errors !', file=sys.stderr)

    print('swept {n_reads} for labels...'.format(
        n_reads=n_labeled + n_orphaned), file=sys.stderr)
    print('...with {nc} labeled and {no} orphaned'.format(
        nc=n_labeled, no=n_orphaned), file=sys.stderr)
    print('...and {nmc} multilabeled'.format(nmc=n_mlabeled),
          file=sys.stderr)

    # machine-readable outputs (reference sweep-reads.py:417-427)
    print('** outputting label number distribution...', file=sys.stderr)
    fn = os.path.join(outdir, '{pref}.dist.txt'.format(pref=args.output_prefix))
    with open(fn, 'w', encoding='utf-8') as outfp:
        for nc in label_number_dist:
            outfp.write('{nc}\n'.format(nc=nc))

    fn = os.path.join(outdir, '{pref}.counts.csv'.format(pref=args.output_prefix))
    print('** outputting label read counts...', file=sys.stderr)
    with open(fn, 'w', encoding='utf-8') as outfp:
        for k in label_dict:
            outfp.write('{l},{c}\n'.format(l=k, c=label_dict[k]))


if __name__ == '__main__':
    main()
