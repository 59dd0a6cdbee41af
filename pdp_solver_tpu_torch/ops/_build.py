"""Builds the port's CUDA kernels with one nvcc call and loads them.

All sources under `pdp_solver_tpu_torch/csrc/*.cu` compile, on first use,
into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/libpdp_kernels-<hash>.so csrc/*.cu

loaded with ctypes (every pointer and the stream are c_void_p). The file
name carries a hash of the sources, so an edited source is rebuilt and an
unchanged one is reused; the library is written under a temporary name and
renamed into place, so a cut build leaves no file that a later process
would wait on or load. No source includes PyTorch's headers (compiling
those takes minutes).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
_FN_IDS = {}

P = ctypes.c_void_p
I = ctypes.c_int
_SIGNATURES = {
    "pdp_fn_lookup": (I, [ctypes.c_char_p, P]),
    "pdp_fused_edge_pass": (I, [I, P, I, P, I, P, P, P, P, I, I, I, P,
                                ctypes.c_float, P]),
    "pdp_chained_edge_pass": (I, [I, P, I, P, I, P, P, P, P, P, P, I, I, I,
                                  I, I, P, P, P, P, P, ctypes.c_float, P]),
    "pdp_walksat_block": (I, [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                              I, ctypes.c_float, P]),
    "pdp_segment_sum_2d": (I, [P, I, P, P, I, P, P]),
    "pdp_gather_2d": (I, [P, I, P, P, ctypes.c_long, P, P]),
    "pdp_segment_sum_cols": (I, [P, I, ctypes.c_long, P, P, I, P, P]),
    "pdp_sp_sweep": (I, [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P,
                         ctypes.c_float, I, P]),
    "pdp_verify_and_masks": (I, [P] * 16 + [I, I, I, P]),
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc():
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path():
    h = hashlib.sha256()
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpdp_kernels-{h.hexdigest()[:16]}.so")


def build(force=False):
    """Compile every source with one nvcc call (skipped when the library
    for these sources exists, unless force). Returns (path, seconds
    spent compiling, compiler output)."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + sources()
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                path, _, _ = build()
                lib = ctypes.CDLL(path)
                for name, (res, args) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = res
                    fn.argtypes = args
                _LIB = lib
    return _LIB


def fn_id(name, meta):
    """Id of the functor `name` in the library; raises unless its column
    counts equal `meta` (kind, side, n_in, n_red, n_eout, n_cred, n_cout,
    n_bcast, n_vred, n_ired) as the Python side declares them."""
    got = _FN_IDS.get(name)
    if got is None:
        buf = (ctypes.c_int * 10)()
        fid = library().pdp_fn_lookup(name.encode(), ctypes.cast(buf, P))
        if fid < 0:
            raise RuntimeError(f"kernel library has no functor {name!r}")
        got = (fid, tuple(buf))
        _FN_IDS[name] = got
    if got[1] != tuple(meta):
        raise RuntimeError(f"functor {name!r}: library declares {got[1]}, "
                           f"python side {tuple(meta)}")
    return got[0]


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def ptr_array(tensors):
    """A C array of the tensors' device pointers (kept alive by the
    caller for the duration of the call)."""
    arr = (P * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])
    return ctypes.cast(arr, P), arr
