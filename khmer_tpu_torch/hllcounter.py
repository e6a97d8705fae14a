"""HyperLogLog++ cardinality counter on the card.

Port of khmer_tpu/hllcounter.py (reference src/oxli/hllcounter.cc +
include/oxli/hllcounter.hh).  The register update of a chunk of bases is
kernel K9 (kernels/csrc/hll.cu): murmur hash, register index, rho and an
atomic byte max in one pass; merge is an elementwise max
(hllcounter.cc:412-420), and the estimate runs on the host over the
registers.

Bias-correction constants are the published HyperLogLog-in-Practice
appendix data (Heule, Nunkesser & Hall, dx.doi.org/10.1145/2452376.
2452456), in khmer_tpu_torch/data/hllpp_constants.json.
"""

import json
import math
import os
import sys
from functools import lru_cache

import numpy as np
import torch

from khmer_tpu_torch import kernels
from khmer_tpu_torch._config import resolve_device
from khmer_tpu_torch.hashtable import CHUNK, _FlatBatcher, _CODE_ASCII
from khmer_tpu_torch.ops.hashing import hash_murmur3_scalar

_CONSTANTS_PATH = os.path.join(
    os.path.dirname(__file__), "data", "hllpp_constants.json")


@lru_cache(maxsize=1)
def _constants():
    with open(_CONSTANTS_PATH) as f:
        return json.load(f)


def _calc_alpha(m):
    p = int(math.floor(math.log2(m)))
    if p < 4:
        raise ValueError(
            "Please set error rate to a value smaller than 0.367696")
    if p > 16:
        raise ValueError(
            "Please set error rate to a value greater than 0.0040624")
    if p == 4:
        return 0.673
    if p == 5:
        return 0.697
    if p == 6:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / (1 << p))


class HLLCounter:
    """HyperLogLog++ k-mer cardinality estimator; its registers live on
    `device` (None: the CUDA device, which must exist)."""

    def __init__(self, error_rate=0.01, ksize=20, device=None):
        self._device = resolve_device(device)
        if isinstance(error_rate, int) and error_rate > 1:
            # reference alternate constructor: explicit register count
            self._init(int(error_rate), int(ksize))
            return
        if error_rate < 0:
            raise ValueError(
                "Please set error rate to a value greater than zero")
        p = int(math.ceil(math.log2((1.04 / error_rate) ** 2)))
        self._init(1 << p, int(ksize))

    def _init(self, nc, ksize):
        self.alpha = _calc_alpha(nc)
        self._p = int(math.floor(math.log2(nc)))
        self._m = nc
        self._ksize = ksize
        # K9 raises bytes through the u32 words that hold them
        self._counters = torch.zeros(nc + (-nc % 4), dtype=torch.uint8,
                                     device=self._device)

    @property
    def device(self):
        return self._device

    # -- properties -------------------------------------------------------

    @property
    def error_rate(self):
        return 1.04 / math.sqrt(self._m)

    @error_rate.setter
    def error_rate(self, erate):
        if bool(self._counters.any()):
            raise AttributeError(
                "You can only change error rate prior to first counting")
        if erate < 0:
            raise ValueError(
                "Please set error rate to a value greater than zero")
        p = int(math.ceil(math.log2((1.04 / erate) ** 2)))
        self._init(1 << p, self._ksize)

    @property
    def ksize(self):
        return self._ksize

    @ksize.setter
    def ksize(self, new_k):
        if int(new_k) <= 0:
            raise ValueError("Please set k-mer size to a value greater "
                             "than zero")
        if bool(self._counters.any()):
            raise AttributeError(
                "You can only change k-mer size prior to first counting")
        self._ksize = int(new_k)

    def _registers(self):
        return self._counters[:self._m].cpu().numpy()

    @property
    def counters(self):
        return [int(c) for c in self._registers()]

    @counters.setter
    def counters(self, values):
        if len(values) != self._m:
            raise ValueError(
                "New counters must match the size of old counters")
        self._counters[:self._m] = torch.from_numpy(
            np.array(values, np.uint8)).to(self._device)

    def __len__(self):
        return self.estimate_cardinality()

    # -- counting ---------------------------------------------------------

    def add(self, kmer):
        """Add one value: the murmur hash of the whole string
        (hllcounter.cc:264-300; this does NOT split it into k-mers)."""
        h = hash_murmur3_scalar(kmer)
        idx = h & (self._m - 1)
        to_count = h >> self._p
        rho = (64 - to_count.bit_length() if to_count > 0 else 64) \
            - self._p + 1
        self._counters[idx:idx + 1].clamp_(min=max(rho, 0))

    def _update(self, byts, weights):
        """K9 over one flat chunk (host uint8 bytes and window weights)."""
        dev = self._device
        kernels.hll_update(torch.from_numpy(byts).to(dev),
                           torch.from_numpy(weights).to(dev), self._ksize,
                           self._p, self._m, self._counters)

    def consume_string(self, seq):
        """Count every k-mer in the string; returns how many."""
        n = len(seq)
        k = self._ksize
        if n < k:
            return 0
        byts = np.frombuffer(seq.encode("ascii"), np.uint8).copy()
        self._update(byts, np.ones(n, np.uint8))
        return n - k + 1

    def consume_seqfile(self, filename, stream_records=False):
        """Count all reads of a file; returns (total_reads, n_consumed).
        With stream_records every record is also written to stdout, so
        the reads go through the Python parser; otherwise the native
        loader's chunks of cleaned bases are turned back into ASCII on
        the device (the same bytes as each read's cleaned_seq)."""
        if stream_records:
            return self._consume_records(filename)
        from khmer_tpu_torch.native import NativeChunkReader

        dev = self._device
        ascii = _CODE_ASCII.to(dev)
        with NativeChunkReader(filename, self._ksize, CHUNK) as reader:
            for codes, mask in reader:
                codes = torch.from_numpy(codes).to(dev)
                kernels.hll_update(ascii[codes.to(torch.int64)],
                                   torch.from_numpy(mask).to(dev),
                                   self._ksize, self._p, self._m,
                                   self._counters)
            n_reads, n_consumed, _ = reader.stats()
        if not n_reads:
            # khmer_tpu reads through its parser, which refuses a file
            # without a record (hllcounter.py:201)
            raise OSError("{} does not contain any sequences!".format(
                filename))
        return int(n_reads), int(n_consumed)

    def _consume_records(self, filename):
        from khmer_tpu_torch.io.fastx import FastxReader, write_record

        k = self._ksize
        batcher = _FlatBatcher(k, CHUNK)
        total_reads = 0
        n_consumed = 0
        for read in FastxReader(filename):
            total_reads += 1
            write_record(read, sys.stdout)
            seq = read.cleaned_seq
            if len(seq) >= k:
                n_consumed += len(seq) - k + 1
            for data, weights in batcher.add(
                    np.frombuffer(seq.encode("ascii"), np.uint8).copy()):
                self._update(data, weights)
        tail = batcher.drain()
        if tail is not None:
            self._update(*tail)
        return total_reads, n_consumed

    # -- estimation -------------------------------------------------------

    def estimate_cardinality(self):
        """HLL++ estimate (hllcounter.cc:239-262)."""
        regs = self._registers().astype(np.float64)
        m = self._m
        V = int((regs == 0).sum())
        consts = _constants()
        if V > 0:
            H = m * math.log(m / V)
            if H <= consts["threshold"][str(self._p)]:
                return int(H)
        E = self.alpha * m * m / float(np.sum(np.power(2.0, -regs)))
        if E <= 5 * m:
            return int(E - self._estimate_bias(E))
        return int(E)

    def _estimate_bias(self, E):
        consts = _constants()
        raw = np.asarray(consts["raw_estimate"][str(self._p)])
        bias = np.asarray(consts["bias"][str(self._p)])
        # 6 nearest neighbors by squared distance (hllcounter.cc:147-166)
        d = (E - raw) ** 2
        nearest = np.argsort(d, kind="stable")[:6]
        return float(bias[nearest].mean())

    def merge(self, other):
        """Elementwise register max (hllcounter.cc:412-420)."""
        if self._m != other._m or self._ksize != other._ksize:
            raise ValueError(
                "HLLCounters to be merged must be created with same "
                "parameters")
        torch.maximum(self._counters, other._counters.to(self._device),
                      out=self._counters)

    def __getstate__(self):
        return (self._m, self._ksize, self.counters, str(self._device))

    def __setstate__(self, state):
        m, k, counters, device = state
        self._device = resolve_device(device)
        self._init(m, k)
        self.counters = counters
