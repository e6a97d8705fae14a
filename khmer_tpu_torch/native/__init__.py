"""Native (C++) host code: the FASTA/FASTQ chunk loader and the read
aligner's search.

Copies of khmer_tpu's sources: the loader (fastx_loader.cc) parses,
cleans, 2-bit-encodes and chunk-batches reads with the exact semantics
of the Python _FlatBatcher (hashtable.py); read_aligner.cc runs the
ReadAligner's A* Subalign against a host snapshot of the table
(readaligner.py).  Both are compiled with g++ into one library at first
use, in khmer_tpu_torch/_build/ under a name that hashes both sources,
and bound with ctypes; a failed build raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from khmer_tpu_torch._version import __version__

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = tuple(os.path.join(_HERE, f)
              for f in ("fastx_loader.cc", "read_aligner.cc"))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_P = ctypes.c_void_p
# ra_subalign(table, sizes, offs, n_tables, read_cap, tsc, trusted_match,
# trusted_mismatch, bits_theta, trusted_cutoff, k, seq, seq_len,
# start_base, start_seq_idx, start_score, start_fwd, start_rc, forward,
# out_cap, out_state, out_base, out_seq_idx, out_trusted, out_cov,
# out_score, out_truncated, out_end_seq_idx)
_RA_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_uint32, _P,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_uint32, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_long, _P, _P, _P, _P, _P, _P, _P, _P]

_lib = None
_lib_lock = threading.Lock()


def _build(so):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp.%d" % (so, os.getpid())
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *_SRCS,
           '-DKHMER_TPU_VERSION="%s"' % __version__,
           "-lz", "-l:libbz2.so.1", "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("building the native library failed:\n"
                               + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            digest = hashlib.sha256(__version__.encode())
            for src in _SRCS:
                with open(src, "rb") as f:
                    digest.update(f.read())
            so = os.path.join(_BUILD_DIR, "libkhmer_io-%s.so"
                              % digest.hexdigest()[:16])
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.kio_open.restype = ctypes.c_void_p
            lib.kio_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_long]
            lib.kio_next_chunk.restype = ctypes.c_long
            lib.kio_next_chunk.argtypes = [ctypes.c_void_p,
                                           ctypes.c_void_p,
                                           ctypes.c_void_p]
            lib.kio_stats.restype = None
            lib.kio_stats.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_uint64)] * 3
            lib.kio_close.restype = None
            lib.kio_close.argtypes = [ctypes.c_void_p]
            lib.ra_subalign.restype = ctypes.c_long
            lib.ra_subalign.argtypes = _RA_ARGTYPES
            _lib = lib
    return _lib


def native_available():
    """True once the native library is built and loaded (a failed build
    raises)."""
    return get_lib() is not None


def native_version():
    """The version string compiled into the native loader."""
    fn = get_lib().kio_version
    fn.restype = ctypes.c_char_p
    fn.argtypes = []
    return fn().decode()


class NativeChunkReader:
    """Stream (codes, mask) uint8 chunks of a sequence file.

    Produces exactly the chunks the Python _FlatBatcher would for the
    cleaned 2-bit code stream of the file (FASTA/FASTQ, plain, gzip or
    bzip2); the final chunk is cut to its filled length."""

    def __init__(self, filename, k, chunk):
        self._lib = get_lib()
        self.chunk = chunk
        self._h = self._lib.kio_open(os.fsencode(filename), int(k),
                                     int(chunk))
        if not self._h:
            raise OSError("file '{}' could not be opened".format(filename))

    def __iter__(self):
        lib = self._lib
        chunk = self.chunk
        while True:
            data = np.empty(chunk, np.uint8)
            mask = np.empty(chunk, np.uint8)
            n = lib.kio_next_chunk(
                self._h,
                data.ctypes.data_as(ctypes.c_void_p),
                mask.ctypes.data_as(ctypes.c_void_p))
            if n == -2:
                raise ValueError("invalid FASTA/FASTQ input")
            if n == -1:
                return
            yield data[:n], mask[:n]
            if n < chunk:
                return

    def stats(self):
        """(n_reads, n_consumed_kmers, n_bases) so far."""
        a = ctypes.c_uint64()
        b = ctypes.c_uint64()
        c = ctypes.c_uint64()
        self._lib.kio_stats(self._h, ctypes.byref(a), ctypes.byref(b),
                            ctypes.byref(c))
        return a.value, b.value, c.value

    def close(self):
        if self._h:
            self._lib.kio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
