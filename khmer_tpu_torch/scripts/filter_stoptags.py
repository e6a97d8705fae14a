# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Trim sequences at k-mers in the given stoptags file.

Output sequences will be placed in 'infile.stopfilt'.

% filter-stoptags.py <stoptags> <data1> [ <data2> <...> ]

PyTorch/CUDA port of scripts/filter-stoptags.py: the same flags, stderr
lines and output records.  The reads pass through the ported
ThreadedSequenceProcessor with one worker, so the output keeps the
input's order (khmer_tpu's eight workers may write groups of 100 reads in
another order); where each read is cut is found FILTER_BATCH reads at a
time on `device` (CUDA unless told otherwise): their k-mers in one K1
pass and their stop tags in one search of the sorted stop tags.  Run as
``python -m khmer_tpu_torch.scripts.filter_stoptags``.
"""

import collections
import os
import sys
import textwrap

import torch

from khmer_tpu_torch import Nodegraph, traversal
from khmer_tpu_torch.kfile import check_input_files, check_space
from khmer_tpu_torch.khmer_args import KhmerArgumentParser, sanitize_help
from khmer_tpu_torch.thread_utils import (ThreadedSequenceProcessor,
                                          verbose_loader)

DEFAULT_K = 32
FILTER_BATCH = 16384  # reads whose cuts are found together


def get_parser():
    epilog = """\
    Load stoptags in from the given `.stoptags` file and use them to trim
    or remove the sequences in `<file1-N>`.  Trimmed sequences will be
    placed in `<fileN>.stopfilt`.
    """
    parser = KhmerArgumentParser(
        description="Trim sequences at stoptags.",
        epilog=textwrap.dedent(epilog), citations=['graph'])
    parser.add_argument('-k', '--ksize', default=DEFAULT_K, type=int,
                        help='k-mer size')
    parser.add_argument('stoptags_file', metavar='input_stoptags_filename')
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        nargs='+')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def trims(nodegraph, records, results):
    """Pass the records on, having put (name, trimmed sequence) or (None,
    None) for each of them on `results`, FILTER_BATCH records ahead:
    khmer_tpu's process_fn, which drops a read with an N, cuts it before
    its first stop tag (trim_on_stoptags) and keeps it if at least k
    bases remain."""
    k = nodegraph.ksize()
    stops = traversal.stop_keys(nodegraph)
    batch = []

    def decide():
        todo = [r for r in batch if 'N' not in r.sequence and
                len(r.sequence) >= k]
        cut = {}
        if todo and stops is not None:
            h, valid = nodegraph._row_hashes([r.sequence for r in todo])
            hit = traversal._member(stops, h.reshape(-1)).reshape(
                h.shape) & valid
            col = hit.to(torch.int8).argmax(1)[:len(todo)].tolist()
            found = hit.any(1)[:len(todo)].tolist()
            cut = {id(r): k - 2 + c for r, c, f in zip(todo, col, found)
                   if f}
        for r in batch:
            seq = r.sequence
            if 'N' in seq:
                results.append((None, None))
                continue
            trim_at = 0 if len(seq) < k else cut.get(id(r), len(seq))
            if trim_at >= k:
                results.append((r.name, seq[:trim_at]))
            else:
                results.append((None, None))

    for record in records:
        batch.append(record)
        if len(batch) >= FILTER_BATCH:
            decide()
            yield from batch
            batch = []
    decide()
    yield from batch


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    stoptags = args.stoptags_file
    infiles = args.input_filenames

    for fname in infiles:
        check_input_files(fname, args.force)

    check_space(infiles, args.force)

    print('loading stop tags, with K', args.ksize, file=sys.stderr)
    nodegraph = Nodegraph(args.ksize, 1, 1, device=device)
    nodegraph.load_stop_tags(stoptags)

    # the filtering loop
    for infile in infiles:
        print('filtering', infile, file=sys.stderr)
        outfile = os.path.basename(infile) + '.stopfilt'

        results = collections.deque()
        with open(outfile, 'w') as outfp:
            tsp = ThreadedSequenceProcessor(
                lambda record: results.popleft(), n_workers=1)
            tsp.start(trims(nodegraph, verbose_loader(infile), results),
                      outfp)

        print('output in', outfile, file=sys.stderr)


if __name__ == '__main__':
    main()
