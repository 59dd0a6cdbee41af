"""eps-greedy WalkSAT: n blocks of K iterations in one launch.

Counterpart of `pdp_solver_tpu/ops/pallas_walksat.py` (`walksat_block`
:285, `walksat_edge_constants` :274, `use_walksat_mega` :265). Each
iteration: clause energies, break-count flip deltas, eps-greedy selection
per instance (first-index argmax; the random lanes come from `hash01`, the
JAX kernel's `_hash01` reproduced bit for bit), and one flip per instance
that still has an unsat clause.

walksat_walk(assign, *, batch, ..., K, seeds, eps) runs len(seeds) blocks
of K iterations, block j salting its iteration kk with seeds[j] + kk *
1000003: the JAX kernel called once per seed, chained. walksat_block(...,
seed=) is its one-block form. Given the same seeds the result equals the
JAX kernel's bit for bit, greedy (eps < 0) or not. With replicas=R > 1
(a replicated batch, `fg.batch.replicate_batch`) the blocks stop after
the first one at whose end every instance has a solved replica
(`replicas_done`, the JAX package's block_done, solvers/base.py
:658-668), which freezes the unsolved replicas as the JAX loop does.

The wrappers run the plain version (`walksat_walk_plain`, a loop of
`walksat_block_plain`) when the batch lies on the CPU, and launch the CUDA
kernel (`csrc/walksat.cu`, one CTA an instance for the whole walk) when it
lies on the card, or raise. active_vars, active_clauses and em are 0/1
flags, as `ProblemState` and `compute_edge_mask` give them: every energy
and per-variable count is then an integer, which the kernel keeps in
int32, so its results equal the plain version's f32 sums bit for bit. A
plan per batch holds the kernel's argument block, its clause tables
(`clause_tables`), its shape (`launch_shape`: threads, what is staged in
shared memory) and, for an instance too large to stage, its global
scratch. The kernel takes the batches of `use_walksat_block` (a uniform
clause width of 2 to 8); on the card another width raises. A whole walk
is one launch; with replicas > 1 it is one launch a block, in place, each
CTA returning at once when a flag on the device says the walk is done
(the last CTA of each launch sets it), so the host never waits. Launches
are counted in `walksat_walk.launches`.
"""

import ctypes

import torch

from pdp_solver_tpu_torch.ops import _build
from pdp_solver_tpu_torch.ops.segment import (
    segment_argmax_first, segment_sum)

BIG = 3e38
# the JAX kernel's caps; the eligibility rule keeps them so both packages
# take the block path on the same batches
B_MAX = 512
V_MAX = 63488
_UNIFORM_K = (2, 3, 4, 5, 6, 7, 8)
# the kernel: clause widths up to WS_MAX_WIDTH, up to WS_MAX_THREADS
# threads a CTA (csrc/walksat.cu), and the dynamic shared memory a CTA
# may take on an H100 (232,448 bytes less the kernel's static slots)
MAX_WIDTH = 8
MAX_THREADS = 1024
SMEM_BYTES = 232448 - 1024


def wrap32(x):
    """Python int -> the int32 with the same low 32 bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _wrap32_t(x):
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def hash01(x, salt):
    """U[0,1) from int64 lanes `x` and an int32 `salt` (splitmix-style
    mixer with int32 wrap-around and arithmetic shifts, computed in
    int64)."""
    h = _wrap32_t(x * 2654435769 + salt)          # 0x9E3779B9
    h = h ^ (h >> 15)
    h = _wrap32_t(h * -2048144777)                 # 0x85EBCA77
    h = h ^ (h >> 13)
    return (h & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))


def use_walksat_block(batch) -> bool:
    """The JAX package's use_walksat_mega rule (uniform clause width, the
    pack-time windowed invariants, B <= 512, V <= 63488)."""
    return bool(batch.fast_var and batch.fast_clause
                and batch.clause_width in _UNIFORM_K
                and batch.batch_size <= B_MAX
                and batch.num_vars <= V_MAX)


def launch_shape(batch):
    """(threads, stage_vars, stage_edges) of the kernel on a batch: a
    thread for each variable and for every 4 clauses of the largest
    instance (a multiple of 32 from 64 to MAX_THREADS; after its first
    iteration the kernel recomputes only the flipped variable's clauses,
    and more warps than that cost the barriers more than they give); its
    variables in shared memory (16 B each) where they fit, and then its
    clauses (14 B a slot of 4 or 8 a clause, 8 B a clause) and var-major
    CSR (4 B an edge and a variable) where they fit too. Raises for a
    clause width the kernel does not take. The instances are the walk's:
    each row's real variables and clauses (`batch.real`)."""
    k = batch.clause_width
    if not 1 <= k <= MAX_WIDTH:
        raise ValueError(f"walksat: the kernel takes a uniform clause width "
                         f"of 1 to {MAX_WIDTH}, the batch has {k or 'mixed'}")
    mv, mc = batch.real.max_vars, batch.real.max_clauses
    slots = 4 if k <= 4 else 8
    threads = min(MAX_THREADS, max(64, -(-max(mv, -(-mc // 4)) // 32) * 32))
    var_bytes = 16 * mv
    edge_bytes = 14 * mc * slots + 8 * mc + 4 * mc * k + 4 * (mv + 1)
    stage_vars = var_bytes <= SMEM_BYTES
    stage_edges = stage_vars and var_bytes + edge_bytes <= SMEM_BYTES
    return threads, stage_vars, stage_edges


def clause_tables(batch):
    """The kernel's clause tables, which depend on the batch alone: vref
    (i32, one an edge of the walk's var-major CSR, `batch.real`) the clause
    of each real edge in var-major order, local to its instance, -1 on a
    clause's second or later slot of one variable (the kernel takes such a
    clause once); lv (i16[F real * slots], slots 4 or 8 as in
    launch_shape) each clause's variables, local to its instance, 0 past
    the clause width (read only where the clauses are staged, whose
    instances have fewer than 2**15 variables)."""
    k = batch.clause_width
    slots = 4 if k <= 4 else 8
    f, e = batch.num_real_clauses, batch.num_real_edges
    inst = batch.clause_batch[:f]
    ev = batch.edge_var[:e].view(f, k)
    earlier = torch.ones(k, k, dtype=torch.bool, device=batch.device)
    repeat = ((ev[:, :, None] == ev[:, None, :]) & earlier.tril(-1)).any(-1)
    clause = (torch.arange(f, device=batch.device)
              - batch.inst_clause_ptr.long()[inst])
    perm = batch.real.var_perm.long()
    vref = torch.where(repeat.view(-1)[perm], -1, clause[perm // k])
    lv = torch.zeros(f, slots, dtype=torch.int16, device=batch.device)
    lv[:, :k] = ev - batch.inst_var_ptr.long()[inst][:, None]
    return vref.to(torch.int32), lv.view(-1)


def replicas_done(batch, energy, replicas):
    """1.0 (a 0-d f32 tensor) once every instance of the replicated batch
    has a replica with no unsat clause (energy <= 0), else 0.0."""
    unsat = (energy > 0).to(torch.float32) * batch.instance_mask
    solved_any = torch.amax(1.0 - unsat.reshape(replicas, -1), dim=0)
    left = (1.0 - solved_any) * batch.instance_mask[:solved_any.shape[0]]
    return (torch.sum(left) <= 0).to(torch.float32)


def walksat_edge_constants(batch, active_vars):
    """w = sign * mask * active_var (scales the gathered assignment into
    the literal value) and dm = mask * active_var (the active degree)."""
    av_e = active_vars[batch.edge_var]
    w = batch.edge_sign * batch.edge_mask * av_e
    dm = batch.edge_mask * av_e
    return w, dm


def walksat_block_plain(assign, *, batch, active_vars, active_clauses, em,
                        K, seed, eps, edge_constants=None):
    """The plain PyTorch version of one block of K iterations."""
    w, dm = (walksat_edge_constants(batch, active_vars)
             if edge_constants is None else edge_constants)
    dev = assign.device
    V, F, B = batch.num_vars, batch.num_clauses, batch.batch_size
    ev, ec = batch.edge_var, batch.edge_clause
    valid = batch.var_mask > 0
    gidx = torch.arange(V, device=dev, dtype=torch.int64)
    bidx = torch.arange(B, device=dev, dtype=torch.int64)
    neg_big = torch.full((V,), -BIG, dtype=torch.float32, device=dev)
    energy = None
    for kk in range(K):
        dist = w * assign[ev]
        agg = segment_sum(dist, ec, F)
        deg = segment_sum(dm, ec, F)
        unsat = (agg == -deg).to(torch.float32) * active_clauses
        energy = segment_sum(unsat, batch.clause_batch, B)
        critical = ((agg[ec] - dist) == 1.0 - deg[ec]).to(torch.float32) * em
        delta = segment_sum(critical * dist, ev, V)
        unsat_v = segment_sum(unsat[ec] * dm, ev, V)

        salt = wrap32(seed + kk * 1000003)
        best = segment_argmax_first(torch.where(valid, -delta, neg_big),
                                    batch.var_batch, B)
        if eps < 0:
            chosen = best
        else:
            uv = unsat_v * active_vars
            vrand = torch.where(
                valid, hash01(gidx, salt) * (uv > 0).to(torch.float32),
                neg_big)
            rnd = segment_argmax_first(vrand, batch.var_batch, B)
            coin = hash01(bidx, wrap32(salt ^ 0x5BD1E995))
            chosen = torch.where(coin > eps, best, rnd)
        flip = ((gidx == chosen[batch.var_batch])
                & (energy[batch.var_batch] > 0)).to(torch.float32)
        assign = assign * (1.0 - 2.0 * flip)
    return assign, energy


def walksat_walk_plain(assign, *, batch, active_vars, active_clauses, em,
                       K, seeds, eps, edge_constants=None, replicas=1):
    """The plain PyTorch version of walksat_walk: one block a seed, with
    replicas > 1 up to the first block at whose end every instance has a
    solved replica."""
    if edge_constants is None:
        edge_constants = walksat_edge_constants(batch, active_vars)
    energy = None
    for seed in seeds:
        assign, energy = walksat_block_plain(
            assign, batch=batch, active_vars=active_vars,
            active_clauses=active_clauses, em=em, K=K, seed=seed, eps=eps,
            edge_constants=edge_constants)
        if replicas > 1 and replicas_done(batch, energy, replicas) > 0:
            break
    return assign, energy


class _Plan:
    """The walk on one batch: the inputs' sizes and, on the card, the
    kernel's argument block with everything that does not change from
    call to call (the batch's pointers and counts, the clause tables, the
    launch shape, the scratch), its shared memory opted in once. A
    plan's scratch serves one launch at a time: launches on one
    stream."""

    def __init__(self, batch):
        self.device = batch.device
        self.sizes = {"V": batch.num_vars, "F": batch.num_clauses,
                      "E": batch.num_edges}
        self.rows = batch.batch_size
        self.args = None
        if self.device.type != "cuda":
            return
        real = batch.real
        threads, stage_vars, stage_edges = launch_shape(batch)
        a = _build.WalkArgs()
        a.ev = batch.edge_var32.data_ptr()
        a.var_ptr = real.var_ptr.data_ptr()
        self.tables = clause_tables(batch)
        a.vref, a.lv = (x.data_ptr() for x in self.tables)
        a.inst_clause_ptr = batch.inst_clause_ptr.data_ptr()
        a.inst_var_ptr = batch.inst_var_ptr.data_ptr()
        a.var_end = real.var_end.data_ptr()
        a.clause_end = real.clause_end.data_ptr()
        a.inst_mask = batch.instance_mask.data_ptr()
        # the replicated walk's arrivals counter and done flag (zeros;
        # the last CTA of a launch leaves the counter 0)
        self.flags = torch.zeros(2, dtype=torch.int32, device=self.device)
        a.flags = self.flags.data_ptr()
        a.n_inst, a.n_rows = batch.num_instances, batch.batch_size
        a.n_vars, a.width = batch.num_vars, batch.clause_width
        a.max_vars, a.max_clauses = real.max_vars, real.max_clauses
        a.threads = threads
        a.stage_vars, a.stage_edges = int(stage_vars), int(stage_edges)
        self.scratch = None
        if not stage_vars:
            self.scratch = torch.empty(2 * batch.num_vars,
                                       dtype=torch.int32,
                                       device=self.device)
            a.sums = self.scratch.data_ptr()
        self.args = a
        self.ref = ctypes.byref(a)
        lib = _build.library()
        with torch.cuda.device(self.device):
            _build.check(lib.pdp_walksat_setup(self.ref), "walksat setup")
        self.call = lib.pdp_walksat_walk
        self.stream = _build.stream_fn(self.device)

    def check(self, **cols):
        """Each column f32[n] of its kind on the batch's device (raises
        otherwise), made contiguous."""
        kept = []
        for name, (x, kind) in cols.items():
            n = self.sizes[kind]
            if x.shape != (n,) or x.dtype != torch.float32:
                raise ValueError(f"walksat: {name} must be f32[{n}], got "
                                 f"{x.dtype} {tuple(x.shape)}")
            if x.device != self.device:
                raise ValueError(f"walksat: {name} is on {x.device}, the "
                                 f"batch on {self.device}")
            kept.append(x if x.is_contiguous() else x.contiguous())
        return kept


_PLANS = _build.PlanCache()


def _plan(batch):
    if batch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"walksat: unsupported device {batch.device}")
    return _PLANS.get((batch,), None, _Plan, batch)


def walksat_walk(assign, *, batch, active_vars, active_clauses, em, K,
                 seeds, eps, edge_constants=None, replicas=1):
    """Run len(seeds) blocks of K WalkSAT iterations (one kernel launch on
    the card; with replicas > 1 one a block, see the module docstring).

    assign: f32[V] in {-1, 0, +1} (0 on inactive variables); seeds: ints
    (any 32-bit values; block j salts its iteration kk with seeds[j] + kk
    * 1000003); eps < 0 is pure greedy. Returns (new_assign f32[V], energy
    f32[B]), energy being each instance's unsat count ENTERING the last
    iteration (the same lag as the per-iteration loop's done flag) of the
    last block that ran."""
    seeds = [wrap32(int(s)) for s in seeds]
    if K < 1 or not seeds:
        raise ValueError(f"walksat: K ({K}) and the number of seeds "
                         f"({len(seeds)}) must be at least 1")
    if replicas < 1 or batch.batch_size % replicas:
        raise ValueError(f"walksat: {replicas} replicas of a batch of "
                         f"{batch.batch_size} rows")
    plan = _plan(batch)
    assign, av, ac, em = plan.check(
        assign=(assign, "V"), active_vars=(active_vars, "V"),
        active_clauses=(active_clauses, "F"), em=(em, "E"))
    if edge_constants is None:
        edge_constants = walksat_edge_constants(batch, av)
    w, dm = plan.check(w=(edge_constants[0], "E"),
                       dm=(edge_constants[1], "E"))
    a = plan.args
    if a is None:
        return walksat_walk_plain(
            assign, batch=batch, active_vars=av, active_clauses=ac, em=em,
            K=K, seeds=seeds, eps=eps, edge_constants=(w, dm),
            replicas=replicas)
    _build.refuse_grad("walksat_walk", (assign, av, ac, em, w, dm))
    V = plan.sizes["V"]
    seeds_d = torch.tensor(seeds, dtype=torch.int32).to(plan.device,
                                                        non_blocking=True)
    # the new assignment and the energies are the two parts of one
    # allocation
    out = assign.new_empty(V + plan.rows)
    a.assign, a.av, a.ac, a.em = (assign.data_ptr(), av.data_ptr(),
                                  ac.data_ptr(), em.data_ptr())
    a.w, a.dm = w.data_ptr(), dm.data_ptr()
    a.out = out.data_ptr()
    a.energy = a.out + 4 * V
    a.K, a.eps, a.replicas = int(K), float(eps), int(replicas)
    a.stream = plan.stream()
    if replicas == 1:
        a.seeds, a.n_blocks, a.check_done = seeds_d.data_ptr(), len(seeds), 0
        _launch(plan)
        return out[:V], out[V:]
    # one launch a block, in place after the first (which reads `assign`
    # and ignores the flag a walk before it left)
    for j in range(len(seeds)):
        a.seeds, a.n_blocks = seeds_d.data_ptr() + 4 * j, 1
        a.check_done = int(j > 0)
        _launch(plan)
        a.assign = a.out
    return out[:V], out[V:]


def _launch(plan):
    rc = plan.call(plan.ref)
    if rc:
        _build.check(rc, "walksat_walk")
    walksat_walk.launches += 1


walksat_walk.launches = 0


def walksat_block(assign, *, batch, active_vars, active_clauses, em, K,
                  seed, eps, edge_constants=None):
    """Run K WalkSAT iterations: walksat_walk with the one seed."""
    return walksat_walk(assign, batch=batch, active_vars=active_vars,
                        active_clauses=active_clauses, em=em, K=K,
                        seeds=[seed], eps=eps, edge_constants=edge_constants)
