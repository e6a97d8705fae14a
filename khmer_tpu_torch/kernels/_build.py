"""Build the CUDA kernels in csrc/ at first use and bind them with ctypes.

Each csrc/*.cu file compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds); all
of them are started together.  Libraries go into khmer_tpu_torch/_build/
(listed in .gitignore) under a name that carries a digest of the
sources and flags, so an edited source is rebuilt and a stale library
is never loaded.  Nothing is built when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("hash2bit", "sketch", "abund", "rows", "chain", "murmur", "hll",
           "cc", "cyclic", "filter", "save", "route", "combine", "claims",
           "binshard")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _U, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint, ctypes.c_ulonglong)
# C entry point -> argument types; every entry returns a cudaError_t
SIGNATURES = {
    "khmer_hash2bit_canonical": (_P, _P, _LL, _I, _P, _P, _P),
    "khmer_sketch_update": (_P, _LL, _P, _P, _LL, _I, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _P, _P),
    "khmer_sketch_get": (_P, _P, _LL, _I, _P, _P, _P, _U, _P, _P),
    "khmer_bin_scatter_add": (_P, _LL, _P, _P, _LL, _P, _P),
    "khmer_abund_hist": (_P, _LL, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                         _U, _P, _P, _P),
    "khmer_row_counts": (_P, _P, _LL, _I, _I, _P, _I, _P, _P, _P, _U, _P, _P,
                         _P),
    "khmer_row_counts_murmur": (_P, _P, _LL, _I, _I, _P, _I, _P, _P, _P, _U,
                                _P, _P, _P),
    "khmer_row_counts_cyclic": (_P, _P, _LL, _I, _I, _P, _I, _P, _P, _P, _U,
                                _P, _P, _P),
    "khmer_murmur_hashes": (_P, _LL, _I, _I, _I, _P, _P),
    "khmer_cyclic_hashes": (_P, _LL, _I, _I, _P, _P),
    "khmer_hll_update": (_P, _P, _LL, _I, _I, _U, _P, _P),
    "khmer_cc_rounds": (_P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P),
    "khmer_band_mask_weights": (_P, _P, _LL, _I, _ULL, _ULL, _P, _I, _P, _P,
                                _P, _U, _U, _I, _P, _P, _P),
    "khmer_count_nonzero": (_P, _LL, _LL, _P, _P),
    "khmer_pack_oxli_bytes": (_P, _I, _I, _P, _P, _P, _LL, _P, _P),
    "khmer_sketch_get_tables": (_P, _P, _LL, _I, _P, _P, _P, _P, _P),
    "khmer_cc_relax": (_P, _P, _P, _LL, _LL, _P, _P, _P),
    "khmer_cc_jump": (_P, _LL, _P, _P, _P, _P, _P),
    "khmer_band_route": (_P, _P, _P, _LL, _I, _LL, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P),
    "khmer_combine_lanes": (_P, _P, _P, _LL, _P, _P, _P, _P, _P, _LL, _P),
    "khmer_claim_scatter": (_P, _P, _P, _LL, _I, _P, _P, _P, _P, _P),
    "khmer_claim_count": (_P, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _P, _P),
    "khmer_owned_claims": (_P, _P, _P, _LL, _I, _P, _P, _P, _P, _LL, _LL, _P,
                           _P, _I, _P, _LL, _P, _P),
    "khmer_owned_add": (_P, _P, _LL, _I, _P, _P, _P, _P, _LL, _LL, _P),
    "khmer_owned_get": (_P, _LL, _I, _P, _P, _P, _P, _LL, _LL, _P, _P),
    "khmer_diginorm_chain": (_P, _P, _P, _P, _I, _I, _U, _P, _P, _P, _LL,
                             _P),
    "khmer_trim_chain": (_P, _P, _P, _P, _I, _I, _U, _U, _I, _U, _P, _P, _P,
                         _P, _LL, _P),
}
# C helpers that launch nothing: name -> (argument types, result type)
HELPERS = {
    "khmer_partition_scratch_bytes": ((_LL, _LL), _LL),
    "khmer_chain_scratch_bytes": ((_LL, _LL), _LL),
    "khmer_route_scratch_words": ((_LL, _I), _LL),
}

_lock = threading.Lock()
_funcs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build():
    """Compile every source that has no current library; returns the
    library paths.  Raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _digest()
    paths = {s: os.path.join(BUILD_DIR, "%s-%s.so" % (s, digest))
             for s in SOURCES}
    procs = {}
    for s, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = "%s.tmp.%d" % (path, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, s + ".cu")]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    failures = []
    for s, (proc, tmp) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode == 0:
            os.replace(tmp, paths[s])
        else:
            failures.append("%s.cu:\n%s" % (s, out))
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def function(name):
    """The bound C entry point `name`, building the libraries once."""
    if name not in _funcs:
        with _lock:
            if not _funcs:
                for path in build().values():
                    lib = ctypes.CDLL(path)
                    entries = {**{k: (v, ctypes.c_int)
                                  for k, v in SIGNATURES.items()},
                               **HELPERS}
                    for fn_name, (argtypes, restype) in entries.items():
                        fn = getattr(lib, fn_name, None)
                        if fn is not None:
                            fn.argtypes = argtypes
                            fn.restype = restype
                            _funcs[fn_name] = fn
    return _funcs[name]
