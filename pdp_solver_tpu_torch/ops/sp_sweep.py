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
    Only login=False is ported: the log-input variant serves p-nd-np's
    adaptors, which are not ported.

The wrapper runs its plain version (`sp_full_sweep_plain`: the two-step
plain path, `chained_edge_pass_plain[sp_chain]` then
`fused_edge_pass_plain[sp_pass_c]`) when the batch lies on the CPU and
launches the CUDA kernel (`csrc/sp_sweep.cu`, one CTA per instance) when it
lies on the card, or raises. Launches are counted in
`sp_full_sweep.launches`.
"""

import torch

from pdp_solver_tpu_torch.ops import _build, fused

# the JAX kernel's supported uniform clause widths (pallas_fused.py _TILES)
SWEEP_WIDTHS = (2, 3, 4, 5, 6, 7, 8)
# instances with more variables keep their sums in a global scratch: two
# f32 sums a variable fill the 48 KB of shared memory a launch may take
# without opting in to more
SMEM_VARS = 6144
_COLS = ("u_like", "eta_in", "em", "mask", "eta_state", "sign", "force",
         "v0", "v1", "v2")


def use_sp_sweep(batch) -> bool:
    """The JAX package's eligibility: a uniform clause width it has tiles
    for, on a batch that meets the window invariants (the CUDA kernel
    itself needs neither; the rule keeps the two packages on one route)."""
    return bool(batch.fast_var and batch.fast_clause
                and batch.clause_width in SWEEP_WIDTHS)


def sp_full_sweep_plain(batch, cols, pi=0.0):
    """The plain version: the propagator's two plain steps."""
    u_like, eta_in, em, mask, eta_state, sign, force, v0, v1, v2 = cols
    _, pn, (new_eta,), _ = fused.chained_edge_pass_plain(
        fused.SP_CHAIN, batch, (u_like, eta_in, em, mask, eta_state, sign))
    _, (nv0, nv1, nv2) = fused.fused_edge_pass_plain(
        fused.SP_PASS_C, batch,
        (pn[0], pn[1], eta_in, em, mask, sign, force, v0, v1, v2),
        scalar=float(pi))
    return new_eta, nv0, nv1, nv2


def sp_full_sweep(batch, *, u_like, eta_in, em, mask, eta_state, sign,
                  force, v0, v1, v2, pi=0.0, login=False):
    """One complete SP sweep; see the module docstring."""
    if login:
        raise NotImplementedError(
            "sp_full_sweep(login=True) serves p-nd-np's adaptors, which "
            "come with the p-nd-np slice")
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
        return sp_full_sweep_plain(batch, cols, pi)
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
    rc = _build.library().pdp_sp_sweep(
        in_p, out_p, batch.edge_var32.data_ptr(),
        batch.edge_clause32.data_ptr(), batch.clause_ptr.data_ptr(),
        batch.var_ptr.data_ptr(), perm.data_ptr() if perm.numel() else None,
        batch.inst_clause_ptr.data_ptr(), batch.inst_var_ptr.data_ptr(),
        batch.batch_size, V, batch.max_instance_vars, batch.num_real_edges,
        E, None if scratch is None else scratch.data_ptr(), float(pi),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sp_full_sweep")
    sp_full_sweep.launches += 1
    return tuple(outs)


sp_full_sweep.launches = 0
