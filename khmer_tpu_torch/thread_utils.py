# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Pipelined host-side read processing (API parity:
khmer.thread_utils); a copy of khmer_tpu/thread_utils.py.

`ThreadedSequenceProcessor` drives a reader -> N workers ->
order-agnostic writer pipeline over bounded queues.  In this
framework the heavy lifting happens in batched device kernels, so the
pipeline's job is just to keep per-record host transforms (the
process_fn) off the critical path while preserving khmer's public
surface: the queue attributes, `SequenceGroup`, the overridable
`do_process`, and the `verbose_loader` helpers that scripts import.
"""

import queue
import sys
import threading

from khmer_tpu_torch.io.fastx import FastxReader, Read
from khmer_tpu_torch.khmer_logger import log_info
from khmer_tpu_torch.utils import check_is_pair, write_record

DEFAULT_WORKER_THREADS = 8
DEFAULT_GROUPSIZE = 100


def verbose_loader(filename):
    """Stream reads from a file, logging progress every 100k."""
    for num, record in enumerate(FastxReader(filename)):
        if num % 100000 == 0:
            log_info('... filtering {num}', num=num)
        yield record


verbose_fasta_iter = verbose_loader  # pylint: disable=invalid-name


class SequenceGroup(object):
    """A batch of records moving through the pipeline."""

    def __init__(self, order, seqlist):
        self.order = order
        self.seqlist = seqlist


def _grouper(records, group_size):
    """Split a record stream into SequenceGroups, never splitting a
    properly-paired couple across two groups."""
    batch = []
    previous = None
    for record in records:
        if len(batch) >= group_size:
            if check_is_pair(previous, record):
                batch.append(record)
                yield SequenceGroup(0, batch)
                batch = []
            else:
                yield SequenceGroup(0, batch)
                batch = [record]
        else:
            batch.append(record)
        previous = record
    if batch:
        yield SequenceGroup(0, batch)


class ThreadedSequenceProcessor(object):
    # pylint: disable=too-many-instance-attributes
    QUEUESIZE = 50

    def __init__(self, process_fn, n_workers=DEFAULT_WORKER_THREADS,
                 group_size=DEFAULT_GROUPSIZE, verbose=True):
        self.process_fn = process_fn
        self.n_workers = n_workers
        self.group_size = group_size
        self.verbose = verbose

        self.inqueue = queue.Queue(self.QUEUESIZE)
        self.outqueue = queue.Queue(self.QUEUESIZE)

        self.worker_count = 0
        self.worker_count_lock = threading.Lock()
        self.done = False

        self.n_processed = 0
        self.n_written = 0
        self.bp_processed = 0
        self.bp_written = 0
        self.tallies_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self, inputiter, outfp):
        if self.verbose:
            print('starting threads', file=sys.stderr)

        try:
            for _ in range(self.n_workers):
                worker = threading.Thread(target=self.do_process)
                self.worker_count += 1
                worker.start()

            if self.verbose:
                print('starting writer', file=sys.stderr)
            writer = threading.Thread(target=self.do_write, args=(outfp,))
            writer.start()

            if self.verbose:
                print('loading...', file=sys.stderr)
            self.push_sequences(inputiter)
            if self.verbose:
                print('done loading in sequences', file=sys.stderr)

            self.done = True
            writer.join()
        except Exception:
            self.done = True
            raise

    def push_sequences(self, inputiter):
        for group in _grouper(inputiter, self.group_size):
            self.inqueue.put(group)

    # -- worker side ---------------------------------------------------------

    def _transform_group(self, grouping):
        """Apply process_fn to one group; returns (kept-triples,
        bp in, bp out)."""
        keep = []
        bp_in = 0
        bp_out = 0
        for record in grouping.seqlist:
            name, sequence = self.process_fn(record)
            bp_in += len(record.sequence)
            if not name:
                continue
            quality = getattr(record, 'quality', None)
            if quality is not None:
                quality = quality[:len(sequence)]
            bp_out += len(sequence)
            keep.append((name, sequence, quality))
        return keep, bp_in, bp_out

    def _tally(self, n_in, n_out, bp_in, bp_out):
        with self.tallies_lock:
            self.n_processed += n_in
            self.n_written += n_out
            self.bp_processed += bp_in
            self.bp_written += bp_out
            if self.verbose and self.n_processed % 500000 == 0:
                print("processed %d / wrote %d / removed %d" %
                      (self.n_processed, self.n_written,
                       self.n_processed - self.n_written),
                      file=sys.stderr)

    def do_process(self):
        try:
            self._do_process()
        finally:
            # always decrement, even if process_fn raised — otherwise
            # the writer never observes worker_count hitting zero
            with self.worker_count_lock:
                self.worker_count -= 1

    def _do_process(self):
        inq = self.inqueue
        while not self.done or not inq.empty():
            try:
                grouping = inq.get(True, 1)
            except queue.Empty:
                continue
            keep, bp_in, bp_out = self._transform_group(grouping)
            self.outqueue.put(SequenceGroup(0, keep))
            self._tally(len(grouping.seqlist), len(keep), bp_in, bp_out)

    # -- writer side ---------------------------------------------------------

    def do_write(self, outfp):
        outq = self.outqueue
        while self.worker_count > 0 or not outq.empty():
            try:
                grouping = outq.get(True, 1)
            except queue.Empty:
                continue
            for name, seq, qual in grouping.seqlist:
                write_record(
                    Read(name=name, sequence=seq,
                         quality=qual if qual else None), outfp)

        if self.verbose:
            self._final_report()

    def _final_report(self):
        print("DONE writing.\nprocessed %d / wrote %d / removed %d" %
              (self.n_processed, self.n_written,
               self.n_processed - self.n_written), file=sys.stderr)
        print("processed %d bp / wrote %d bp / removed %d bp" %
              (self.bp_processed, self.bp_written,
               self.bp_processed - self.bp_written), file=sys.stderr)
        if self.bp_processed:
            discarded = self.bp_processed - self.bp_written
            percent = float(discarded) / float(self.bp_processed) * 100
            print("discarded %.1f%%" % percent, file=sys.stderr)
