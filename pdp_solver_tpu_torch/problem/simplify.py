"""CNF simplification: unit propagation and pure-literal peeling.

Counterpart of `pdp_solver_tpu/problem/simplify.py`. The reference passes
(`set_variable_core`, `unit_propagate`, `peel`) are plain tensor code whose
loops test their condition on the host. The solver's path is the fused
loop (`fused_simplify`, `fused_set_variables`): one chained edge pass per
round (clause degrees and satisfied clauses, then unit forcing and
pure-literal degrees per variable) and a node-level tail.
"""

import torch

from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import segment_sum
from pdp_solver_tpu_torch.problem.state import ProblemState


def _to_clauses(batch, x_e):
    return segment_sum(x_e, batch.edge_clause, batch.num_clauses)


def _to_vars(batch, x_e):
    return segment_sum(x_e, batch.edge_var, batch.num_vars)


def _where0(cond, x):
    return torch.where(cond, torch.zeros_like(x), x)


def set_variable_core(batch, state: ProblemState, assignment):
    """Fix variables to +-1; deactivate them and the clauses they satisfy.
    `assignment` is f32[V] in {-1, 0, +1}; zero entries are untouched."""
    assignment = assignment * state.active_vars
    a_e = assignment[batch.edge_var] * batch.edge_mask
    input_num = _to_clauses(batch, torch.abs(a_e))
    clause_eval = _to_clauses(batch, batch.edge_sign * a_e)
    satisfied = (clause_eval > -input_num) & (state.active_clauses > 0)
    assigned = torch.abs(assignment) == 1
    return state.replace(
        active_vars=_where0(assigned, state.active_vars),
        active_clauses=_where0(satisfied, state.active_clauses),
        solution=torch.where(assigned, (assignment + 1.0) / 2.0,
                             state.solution))


def _unit_clauses(batch, state):
    contrib = state.active_vars[batch.edge_var] * batch.edge_mask
    degree = _to_clauses(batch, contrib)
    return (degree == 1).to(torch.float32) * state.active_clauses


def unit_propagate(batch, state: ProblemState) -> ProblemState:
    """Unit-clause propagation; a conflict marks the whole instance UNSAT
    and deactivates it (>= 1 conflicting variable, as in the JAX package)."""
    B = batch.batch_size
    single = _unit_clauses(batch, state)
    while bool(single.sum() > 0):
        s_e = single[batch.edge_clause] * batch.edge_mask
        input_num = _to_vars(batch, s_e)
        var_eval = _to_vars(batch, batch.edge_sign * s_e)
        conflict = ((torch.abs(var_eval) != input_num).to(torch.float32)
                    * state.active_vars)
        unsat_b = segment_sum(conflict, batch.var_batch, B) >= 1
        is_sat = _where0(unsat_b, state.is_sat)
        active_vars = _where0(unsat_b[batch.var_batch], state.active_vars)
        active_clauses = _where0(unsat_b[batch.clause_batch],
                                 state.active_clauses)
        assigned = ((torch.abs(var_eval) == input_num).to(torch.float32)
                    * active_vars)
        assignment = torch.sign(var_eval) * assigned
        active_clauses = _where0(single > 0, active_clauses)
        state = state.replace(active_vars=active_vars,
                              active_clauses=active_clauses, is_sat=is_sat)
        state = set_variable_core(batch, state, assignment)
        single = _unit_clauses(batch, state)
    return state


def peel(batch, state: ProblemState) -> ProblemState:
    """Iteratively fix pure-literal (and isolated) variables."""
    e_ca = state.active_clauses[batch.edge_clause] * batch.edge_mask
    degree = _to_vars(batch, e_ca)
    signed_degree = _to_vars(batch, batch.edge_sign * e_ca)

    def pure_vars():
        return ((degree == torch.abs(signed_degree)).to(torch.float32)
                * state.active_vars)

    single_v = pure_vars()
    while bool(single_v.sum() > 0):
        touched = _to_clauses(batch, single_v[batch.edge_var]
                              * batch.edge_mask)
        single_f = (touched > 0).to(torch.float32) * state.active_clauses
        f_e = single_f[batch.edge_clause] * batch.edge_mask
        delta = _to_vars(batch, f_e) * state.active_vars
        signed_delta = _to_vars(batch, batch.edge_sign * f_e) \
            * state.active_vars
        solution = torch.where(single_v == 1,
                               (torch.sign(signed_degree) + 1.0) / 2.0,
                               state.solution)
        state = state.replace(
            solution=solution,
            active_vars=_where0(single_v == 1, state.active_vars),
            active_clauses=_where0(single_f == 1, state.active_clauses))
        degree = degree - delta
        signed_degree = signed_degree - signed_delta
        single_v = pure_vars()
    return state


def simplify(batch, state: ProblemState) -> ProblemState:
    """Unit propagation followed by peeling."""
    return peel(batch, unit_propagate(batch, state))


def set_variables(batch, state: ProblemState, assignment) -> ProblemState:
    """Fix variables then re-simplify (the reference decimation step)."""
    return simplify(batch, set_variable_core(batch, state, assignment))


def fused_round(batch, state: ProblemState):
    """One combined unit-prop + peel + satisfied-removal round (one chained
    edge pass). Returns (new state, changed: a 0-d bool tensor)."""
    cout, vd, _, _ = fused.chained_edge_pass(
        fused.SROUND, batch,
        (state.active_vars, state.solution, batch.edge_sign,
         batch.edge_mask, state.active_clauses))
    active_clauses = cout[0]
    removed_any = torch.sum(state.active_clauses - active_clauses)
    input_num, var_eval, degree_v, signed_degree_v = vd
    B = batch.batch_size

    conflict = ((torch.abs(var_eval) != input_num).to(torch.float32)
                * state.active_vars)
    unsat_b = segment_sum(conflict, batch.var_batch, B) >= 1
    is_sat = _where0(unsat_b, state.is_sat)
    active_vars = _where0(unsat_b[batch.var_batch], state.active_vars)
    active_clauses = _where0(unsat_b[batch.clause_batch], active_clauses)

    forced = ((input_num > 0) & (torch.abs(var_eval) == input_num))
    forced = forced.to(torch.float32) * active_vars
    pure = ((degree_v == torch.abs(signed_degree_v)).to(torch.float32)
            * active_vars * (1.0 - forced))
    value = forced * torch.sign(var_eval) + pure * torch.sign(signed_degree_v)
    nonzero = (torch.abs(value) > 0).to(torch.float32)
    fixed = torch.maximum(forced, pure * (degree_v > 0).to(torch.float32)) \
        * nonzero
    deactivate = torch.maximum(forced * nonzero, pure)

    solution = torch.where(fixed > 0, (value + 1.0) / 2.0, state.solution)
    active_vars = _where0(deactivate > 0, active_vars)
    new_state = ProblemState(active_vars=active_vars,
                             active_clauses=active_clauses,
                             solution=solution, is_sat=is_sat)
    changed = (removed_any + torch.sum(deactivate)
               + torch.sum(unsat_b.to(torch.float32))) > 0
    return new_state, changed


def fused_simplify(batch, state: ProblemState,
                   max_rounds: int = 0) -> ProblemState:
    """Simplify to the unit-prop + peel fixed point.

    max_rounds > 0 caps the rounds (lazy simplification). A round that
    changes nothing leaves the state as it was, so the capped loop runs
    exactly max_rounds rounds with no host sync and reaches what the JAX
    loop (which stops at the first unchanged round) reaches.
    0 = run to the fixed point, testing `changed` on the host each round."""
    if max_rounds > 0:
        for _ in range(max_rounds):
            state, _ = fused_round(batch, state)
        return state
    while True:
        state, changed = fused_round(batch, state)
        if not bool(changed):
            return state


def fused_set_variables(batch, state: ProblemState, assignment,
                        max_rounds: int = 0) -> ProblemState:
    """Decimation step: write the assignment, deactivate the variables, and
    let the first fused round remove the satisfied clauses."""
    assignment = assignment * state.active_vars
    assigned = torch.abs(assignment) == 1
    state = state.replace(
        active_vars=_where0(assigned, state.active_vars),
        solution=torch.where(assigned, (assignment + 1.0) / 2.0,
                             state.solution))
    return fused_simplify(batch, state, max_rounds=max_rounds)
