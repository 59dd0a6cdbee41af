"""K WalkSAT iterations per launch.

Counterpart of `pdp_solver_tpu/ops/pallas_walksat.py` (`walksat_block`
:285, `walksat_edge_constants` :274, `use_walksat_mega` :265). Each
iteration: clause energies, break-count flip deltas, eps-greedy selection
per instance (first-index argmax; the random lanes come from `hash01`, the
JAX kernel's `_hash01` reproduced bit for bit), and one flip per instance
that still has an unsat clause. Given the same seed the result equals the
JAX kernel's bit for bit, greedy (eps < 0) or not.

The wrapper runs `walksat_block_plain` when the batch lies on the CPU and
the CUDA kernel (`csrc/walksat.cu`) when it lies on the card; calls that
launched the kernel are counted in `walksat_block.launches`.
"""

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
# shared memory of one CTA: 3 floats per variable of the instance
SMEM_BYTES = 232448
MAX_INSTANCE_VARS = SMEM_BYTES // 12 - 64


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


def walksat_edge_constants(batch, active_vars):
    """w = sign * mask * active_var (scales the gathered assignment into
    the literal value) and dm = mask * active_var (the active degree)."""
    av_e = active_vars[batch.edge_var]
    w = batch.edge_sign * batch.edge_mask * av_e
    dm = batch.edge_mask * av_e
    return w, dm


def walksat_block_plain(assign, *, batch, active_vars, active_clauses, em,
                        K, seed, eps, edge_constants=None):
    """The plain PyTorch version of walksat_block."""
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


def walksat_block(assign, *, batch, active_vars, active_clauses, em, K,
                  seed, eps, edge_constants=None):
    """Run K WalkSAT iterations (one kernel launch on the card).

    assign: f32[V] in {-1, 0, +1} (0 on inactive variables); seed: int
    (any 32-bit value); eps < 0 is pure greedy. Returns (new_assign f32[V],
    energy f32[B]), energy being each instance's unsat count ENTERING the
    last iteration (the same lag as the per-iteration loop's done flag)."""
    seed = wrap32(int(seed))
    if batch.device.type == "cpu":
        return walksat_block_plain(
            assign, batch=batch, active_vars=active_vars,
            active_clauses=active_clauses, em=em, K=K, seed=seed, eps=eps,
            edge_constants=edge_constants)
    if batch.device.type != "cuda":
        raise ValueError(f"walksat_block: unsupported device {batch.device}")
    if batch.max_instance_vars > MAX_INSTANCE_VARS:
        raise ValueError(
            f"walksat_block: an instance has {batch.max_instance_vars} "
            f"variables; one CTA holds at most {MAX_INSTANCE_VARS}")
    V, F, E, B = (batch.num_vars, batch.num_clauses, batch.num_edges,
                  batch.batch_size)
    w, dm = (walksat_edge_constants(batch, active_vars)
             if edge_constants is None else edge_constants)
    cols = {"assign": (assign, V), "active_vars": (active_vars, V),
            "active_clauses": (active_clauses, F), "em": (em, E),
            "w": (w, E), "dm": (dm, E)}
    for name, (x, n) in cols.items():
        if x.shape != (n,) or x.dtype != torch.float32 or \
                x.device != batch.device:
            raise ValueError(f"walksat_block: {name} must be float32[{n}] "
                             f"on {batch.device}, got {x.dtype}"
                             f"{tuple(x.shape)} on {x.device}")
    out = assign.contiguous().clone()
    energy = torch.empty(B, dtype=torch.float32, device=batch.device)
    w, dm, em = w.contiguous(), dm.contiguous(), em.contiguous()
    ac, av = active_clauses.contiguous(), active_vars.contiguous()
    rc = _build.library().pdp_walksat_block(
        batch.edge_var32.data_ptr(), w.data_ptr(), dm.data_ptr(),
        em.data_ptr(), ac.data_ptr(), batch.clause_ptr.data_ptr(),
        batch.inst_clause_ptr.data_ptr(), batch.inst_var_ptr.data_ptr(),
        out.data_ptr(), av.data_ptr(), batch.var_mask.data_ptr(),
        energy.data_ptr(), B, batch.max_instance_vars, int(K), seed,
        float(eps), torch.cuda.current_stream(batch.device).cuda_stream)
    _build.check(rc, "walksat_block")
    walksat_block.launches += 1
    return out, energy


walksat_block.launches = 0
