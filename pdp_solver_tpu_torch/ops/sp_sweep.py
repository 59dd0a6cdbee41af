"""The whole Survey Propagation sweep in one launch.

Counterpart of `pdp_solver_tpu/ops/pallas_sp.py` (`sp_full_sweep` :166,
`use_sp_sweep` :159; kernel 9 of PERF.md). The propagator takes it in place
of its two launches (the chained pass `sp_chain`, then `sp_pass_c`) when
`PDP_SP_SWEEP=on` and `use_sp_sweep(batch)`, as the JAX package does
(`modules/propagate.py:566-583`).

sp_full_sweep(batch, *, u_like, eta_in, em, mask, eta_state, sign, force,
              v0, v1, v2, pi=0.0, login=False) -> (new_eta, nv0, nv1, nv2)
    the JAX function's column arguments (its gather ids, clause width and
    variable count come from the batch); every input and output is f32[E].
    With login=True u_like already is log u (p-nd-np's adaptors).

The wrapper runs its plain version (`sp_full_sweep_plain`: the two-step
plain path, `chained_edge_pass_plain[sp_chain]` (`[sp_chain_login]` with
login) then `fused_edge_pass_plain[sp_pass_c]`) when the batch lies on the
CPU and launches the CUDA kernel (`csrc/sp_sweep.cu`, one CTA per
instance, login a compile-time flag) when it lies on the card, or raises.
The kernel takes its variable sums in the order of the chained pass's var
walk (`csrc/common.cuh`, G = `_build.group_width` of the batch's var CSR),
so it gives the bits of its two launches. Launches are counted in
`sp_full_sweep.launches`, and per form ("plain", "login") in
`sp_full_sweep.launches_by_form`.
"""

import torch

from pdp_solver_tpu_torch.ops import _build, fused

# instances with more variables keep their sums in a global scratch: two
# f32 sums a variable fill the 48 KB of shared memory a launch may take
# without opting in to more
SMEM_VARS = 6144
_COLS = ("u_like", "eta_in", "em", "mask", "eta_state", "sign", "force",
         "v0", "v1", "v2")


def use_sp_sweep(batch) -> bool:
    """The JAX package's eligibility (`pallas_sp.py use_sp_sweep` :159,
    which is its chained passes' rule)."""
    return fused.use_chained_pass(batch)


def sp_full_sweep_plain(batch, cols, pi=0.0, login=False):
    """The plain version: the propagator's two plain steps."""
    u_like, eta_in, em, mask, eta_state, sign, force, v0, v1, v2 = cols
    chain = fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN
    _, pn, (new_eta,), _ = fused.chained_edge_pass_plain(
        chain, batch, (u_like, eta_in, em, mask, eta_state, sign))
    _, (nv0, nv1, nv2) = fused.fused_edge_pass_plain(
        fused.SP_PASS_C, batch,
        (pn[0], pn[1], eta_in, em, mask, sign, force, v0, v1, v2),
        scalar=float(pi))
    return new_eta, nv0, nv1, nv2


def sp_full_sweep(batch, *, u_like, eta_in, em, mask, eta_state, sign,
                  force, v0, v1, v2, pi=0.0, login=False):
    """One complete SP sweep; see the module docstring."""
    cols = (u_like, eta_in, em, mask, eta_state, sign, force, v0, v1, v2)
    E = batch.num_edges
    for name, x in zip(_COLS, cols):
        if x.shape != (E,) or x.dtype != torch.float32:
            raise ValueError(f"sp_full_sweep: {name} must be f32[{E}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != batch.device:
            raise ValueError(f"sp_full_sweep: {name} is on {x.device}, the "
                             f"batch on {batch.device}")
    if batch.device.type == "cpu":
        return sp_full_sweep_plain(batch, cols, pi, login)
    if batch.device.type != "cuda":
        raise ValueError(f"sp_full_sweep: unsupported device {batch.device}")
    dev = batch.device
    cols = tuple(x.contiguous() for x in cols)
    outs = [torch.empty(E, dtype=torch.float32, device=dev)
            for _ in range(4)]
    V = batch.num_vars
    scratch = (torch.empty(2 * V, dtype=torch.float32, device=dev)
               if batch.max_instance_vars > SMEM_VARS else None)
    in_p, _in_keep = _build.ptr_array(cols)
    out_p, _out_keep = _build.ptr_array(outs)
    perm = batch.var_perm
    group = _build.group_width(batch.num_real_edges, V)
    md = batch.var_max_degree
    rc = _build.library().pdp_sp_sweep(
        in_p, out_p, batch.edge_var32.data_ptr(),
        batch.edge_clause32.data_ptr(), batch.clause_ptr.data_ptr(),
        batch.var_ptr.data_ptr(), perm.data_ptr() if perm.numel() else None,
        batch.inst_clause_ptr.data_ptr(), batch.inst_var_ptr.data_ptr(),
        batch.batch_size, V, batch.max_instance_vars, batch.num_real_edges,
        E, None if scratch is None else scratch.data_ptr(), group,
        int(md is None or md >= _build.HEAVY_ITERS * group), float(pi),
        int(bool(login)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sp_full_sweep")
    sp_full_sweep.launches += 1
    key = "login" if login else "plain"
    sp_full_sweep.launches_by_form[key] = (
        sp_full_sweep.launches_by_form.get(key, 0) + 1)
    return tuple(outs)


sp_full_sweep.launches = 0
sp_full_sweep.launches_by_form = {}
