"""Builds the port's CUDA kernels with one nvcc call and loads them.

All sources under `pdp_solver_tpu_torch/csrc/*.cu` compile, on first use,
into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/libpdp_kernels-<hash>.so csrc/*.cu

loaded with ctypes (every pointer and the stream are c_void_p). The file
name carries a hash of the sources, so an edited source is rebuilt and an
unchanged one is reused; the library is written under a temporary name and
renamed into place, so a cut build leaves no file that a later process
would wait on or load; processes that build at once (the ranks of a
torchrun launch) take turns on a lock file beside it, so one compiles and
the others load its result. No source includes PyTorch's headers (compiling
those takes minutes). `fg/native.py` builds and loads the host DIMACS
parser through the same helpers (`hashed_path`, `build_shared`,
`load_shared`).
"""

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref

import torch

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
    "pdp_fused_edge_pass": (I, [P]),
    "pdp_chained_edge_pass": (I, [P]),
    "pdp_walksat_setup": (I, [P]),
    "pdp_walksat_walk": (I, [P]),
    "pdp_segment_sum_2d": (I, [P]),
    "pdp_gather_2d": (I, [P]),
    "pdp_segment_sum_cols": (I, [P]),
    "pdp_sp_sweep": (I, [P]),
    "pdp_verify_and_masks": (I, [P]),
}


MAX_IN = 12       # PDP_MAX_IN, common.cuh
MAX_EOUT = 4      # PDP_MAX_EOUT
MAX_COLS = 8      # PDP_RED_MAXC, reduce.cu
GROUP_MIN, GROUP_MAX = 4, 32
HEAVY_ITERS = 128  # PDP_HEAVY_ITERS, common.cuh
WALK_MAXR = 10     # PDP_WALK_MAXR
THREADS = 256      # PDP_THREADS
CLUSTER_MAX = 16   # PDP_CLUSTER_MAX
R2D_HEAVY = 256    # PDP_R2D_HEAVY, reduce2d.cu
R2D_WARPS = THREADS // 32  # PDP_R2D_WARPS


class FusedArgs(ctypes.Structure):
    """csrc/edge_pass.cu FusedArgs, field for field."""
    _fields_ = [("fn", I), ("n_in", I), ("n_eout", I), ("n_seg", I),
                ("ins", P * MAX_IN), ("eouts", P * MAX_EOUT),
                ("ev", P), ("ec", P), ("ptr", P), ("perm", P),
                ("e_real", I), ("e_total", I), ("group", I),
                ("scalar", ctypes.c_float), ("red", P), ("heavy", I),
                ("partials", P), ("counters", P), ("stream", P)]


class ChainedArgs(ctypes.Structure):
    """csrc/edge_pass.cu ChainedArgs, field for field."""
    _fields_ = [("fn", I), ("n_in", I), ("n_eout", I), ("n_vars", I),
                ("n_clauses", I), ("n_inst", I), ("e_real", I),
                ("e_total", I), ("inner_pad", I), ("ins", P * MAX_IN),
                ("eouts", P * MAX_EOUT),
                ("ev", P), ("ec", P), ("var_ptr", P), ("var_perm", P),
                ("clause_ptr", P), ("inst_clause_ptr", P), ("group", I),
                ("heavy", I), ("partials", P), ("counters", P), ("cout", P),
                ("bc", P), ("irc", P), ("vred", P), ("ired", P),
                ("stream", P)]


class GatherArgs(ctypes.Structure):
    """csrc/reduce2d.cu GatherArgs, field for field."""
    _fields_ = [("nodes", P), ("d", I), ("ids64", I), ("ids", P),
                ("minus", P), ("n_rows", ctypes.c_long), ("out", P),
                ("minus_bf16", I), ("stream", P)]


class SegSum2dArgs(ctypes.Structure):
    """csrc/reduce2d.cu SegSum2dArgs, field for field."""
    _fields_ = [("x", P), ("x_bf16", I), ("d", I), ("ptr", P), ("perm", P),
                ("ids", P), ("ids64", I), ("n_seg", I), ("n_slots", I),
                ("heavy", I), ("partials", P), ("counters", P), ("out", P),
                ("stream", P)]


class SegSumArgs(ctypes.Structure):
    """csrc/reduce.cu SegSumArgs, field for field."""
    _fields_ = [("cols", P * MAX_COLS), ("n_cols", I), ("sorted", I),
                ("stride", ctypes.c_long), ("ptr", P), ("perm", P),
                ("ids", P), ("ids64", I), ("n_seg", I), ("n_slots", I),
                ("group", I), ("heavy", I), ("out", P), ("partials", P),
                ("counters", P), ("stream", P)]


class SweepArgs(ctypes.Structure):
    """csrc/sp_sweep.cu SweepArgs, field for field."""
    _fields_ = [("ins", P * MAX_IN), ("outs", P * MAX_EOUT), ("ev", P),
                ("ec", P), ("clause_ptr", P), ("var_ptr", P),
                ("var_perm", P), ("inst_clause_ptr", P),
                ("inst_var_ptr", P), ("sums", P), ("pieces", P),
                ("n_inst", I), ("n_vars", I), ("max_inst_vars", I),
                ("e_real", I), ("e_total", I), ("inner_pad", I),
                ("group", I), ("heavy", I),
                ("cluster", I), ("login", I), ("pi", ctypes.c_float),
                ("stream", P)]


class VerifyArgs(ctypes.Structure):
    """csrc/verify.cu VerifyArgs, field for field."""
    _fields_ = [("pred", P), ("sign", P), ("edge_mask", P), ("av", P),
                ("ac", P), ("cm", P), ("active", P), ("ev", P), ("ec", P),
                ("clause_ptr", P), ("inst_clause_ptr", P),
                ("var_batch", P), ("solved", P), ("unsat", P), ("em", P),
                ("ae", P), ("n_inst", I), ("n_rows", I), ("e_real", I),
                ("e_total", I), ("cluster", I), ("stream", P)]


class WalkArgs(ctypes.Structure):
    """csrc/walksat.cu WalkArgs, field for field."""
    _fields_ = [("ev", P), ("w", P), ("dm", P), ("em", P), ("ac", P),
                ("var_ptr", P), ("vref", P), ("lv", P), ("inst_clause_ptr", P),
                ("inst_var_ptr", P), ("assign", P),
                ("av", P), ("seeds", P), ("out", P), ("energy", P),
                ("sums", P), ("var_end", P), ("clause_end", P),
                ("inst_mask", P), ("flags", P),
                ("n_inst", I), ("n_rows", I), ("n_vars", I),
                ("width", I), ("max_vars", I), ("max_clauses", I),
                ("n_blocks", I), ("K", I), ("eps", ctypes.c_float),
                ("threads", I), ("stage_vars", I), ("stage_edges", I),
                ("replicas", I), ("check_done", I), ("stream", P)]


def cluster_size(batch, sms, min_share=THREADS):
    """CTAs a cluster for the kernels that run one thread-block cluster an
    instance (kernels 9 and 10, csrc/common.cuh): the least power of two
    that gives the batch's n real instances at least two CTAs an SM (n *
    cs >= 2 * sms), at most CLUSTER_MAX, then halved while a CTA's share
    of an instance's mean edge count would be under min_share edges.
    Kernel 9 (~40 operations and 14 columns an edge) takes one edge a
    thread, kernel 10 (a few operations and columns an edge) two: on an
    H100's 132 SMs the shared set (128 instances of 3,600 edges) takes 4
    for both, a compacted batch of 8 such instances 8 and 4, one instance
    of 190,000 edges 16."""
    b = max(batch.num_instances, 1)
    cs = 1
    while cs < CLUSTER_MAX and b * cs < 2 * sms:
        cs *= 2
    mean_edges = batch.num_real_edges / b
    while cs > 1 and mean_edges / cs < min_share:
        cs //= 2
    return cs


def device_sms(device):
    """The card's SM count (cluster_size's sms)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def group_width(n_slots, n_seg):
    """Lanes a segment of the group walk (common.cuh): the power of two
    from 4 to 32 that gives each lane about 4 of the mean segment's
    slots."""
    mean = n_slots / max(n_seg, 1)
    g = GROUP_MIN
    while g < GROUP_MAX and 4 * g < mean:
        g *= 2
    return g


def walk_scratch(args, n_slots, group, max_degree, device):
    """Sets the group walk's heavy flag and scratch in args (FusedArgs or
    SegSumArgs) for a CSR of n_slots slots whose largest segment holds
    max_degree (None: not known): no scratch when no segment can reach
    the heavy stride, else one f32[WALK_MAXR] partial and one i32 counter
    (zeros; the kernel leaves them 0) per anchored block (csrc/common.cuh
    make_walk_plan). Returns the scratch tensors, for the caller to keep
    alive."""
    stride = HEAVY_ITERS * group
    args.heavy = int(max_degree is None or max_degree >= stride)
    if not args.heavy:
        args.partials = args.counters = None
        return ()
    n = max(-(-n_slots // stride), 1)
    partials = torch.empty(n * WALK_MAXR, dtype=torch.float32, device=device)
    counters = torch.zeros(n, dtype=torch.int32, device=device)
    args.partials, args.counters = partials.data_ptr(), counters.data_ptr()
    return partials, counters


def sum2d_scratch(args, n_slots, d, max_degree, device):
    """Sets kernel 6's heavy flag and scratch in args (SegSum2dArgs) for a
    CSR of n_slots slots whose largest segment holds max_degree (None: not
    known) and rows of d columns: none when no segment can reach
    R2D_HEAVY, else one f32[d] partial row and one i32 counter (zeros; the
    kernel leaves them 0) per anchored block. Returns the scratch tensors,
    for the caller to keep alive."""
    args.heavy = int(max_degree is None or max_degree >= R2D_HEAVY)
    if not args.heavy:
        args.partials = args.counters = None
        return ()
    n = max(-(-n_slots // R2D_HEAVY), 1)
    partials = torch.empty(n * d, dtype=torch.float32, device=device)
    counters = torch.zeros(n, dtype=torch.int32, device=device)
    args.partials, args.counters = partials.data_ptr(), counters.data_ptr()
    return partials, counters


def stream_fn(device):
    """A function returning the current CUDA stream of `device` as an int:
    torch's raw getter where the build has it (one C call), else
    torch.cuda.current_stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return functools.partial(raw, device.index)
    return lambda: torch.cuda.current_stream(device).cuda_stream


def _no_ref():
    return None


class PlanCache:
    """Launch plans keyed by the identity of the objects they serve (a
    batch, index tensors). It holds weak references only: a plan never
    keeps its objects alive, and an id that a new object reuses misses.
    Plans assume those objects are not resized in place."""

    def __init__(self, limit=256):
        self._plans = {}
        self._limit = limit

    def get(self, objs, extra, make, *args):
        """The plan for objs (a tuple) and extra, made by make(*args) on a
        miss."""
        key = (*map(id, objs), extra)
        hit = self._plans.get(key)
        if hit is not None:
            for r, o in zip(hit[0], objs):
                if r() is not o:
                    break
            else:
                return hit[1]
        if len(self._plans) >= self._limit:
            self._plans.clear()
        plan = make(*args)
        self._plans[key] = (tuple(_no_ref if o is None else weakref.ref(o)
                                  for o in objs), plan)
        return plan


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc():
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def hashed_path(stem, paths, flags):
    """`BUILD_DIR/<stem>-<hash>.so`, the hash taken over the files' names
    and contents and the flags, so an edited source gets a new library."""
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_shared(compiler, flags, srcs, out, force=False):
    """Compile `srcs` into the shared library `out` with one compiler call
    (skipped when `out` exists, unless force), written under a temporary
    name and renamed into place. Returns (out, seconds spent compiling,
    compiler output); raises RuntimeError when the compiler fails."""
    if os.path.exists(out) and not force:
        return out, 0.0, ""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out) and not force:
            return out, 0.0, ""     # built by another process meanwhile
        return _compile(compiler, flags, srcs, out)


def _compile(compiler, flags, srcs, out):
    started = time.time()
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler] + flags + ["-o", tmp] + srcs,
                          capture_output=True, text=True)
    seconds = time.time() - started
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def load_shared(path, signatures):
    """ctypes.CDLL(path) with each function's (restype, argtypes) set
    from `signatures`, a dict by name."""
    lib = ctypes.CDLL(path)
    for name, (res, args) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def library_path():
    return hashed_path(
        "libpdp_kernels",
        sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))),
        NVCC_FLAGS)


def build(force=False):
    """Compile every source with one nvcc call (skipped when the library
    for these sources exists, unless force). Returns (path, seconds
    spent compiling, compiler output)."""
    return build_shared(_nvcc(), NVCC_FLAGS, sources(), library_path(),
                        force)


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = load_shared(build()[0], _SIGNATURES)
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


def refuse_grad(name, tensors):
    """Raise where a launch would cut the autograd graph: the kernel
    reads raw pointers, so its output carries no grad_fn. Called by the
    wrappers of kernels that have no backward rule (the JAX package
    differentiates none of them either), on the route that launches."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but this kernel has no "
            "backward rule and its output would be cut from the graph; "
            "detach the input or call it under torch.no_grad()")


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
