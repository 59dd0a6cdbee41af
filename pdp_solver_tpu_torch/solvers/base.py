"""The p-d-p solver: SP propagator x sequential decimator x identity
predictor, with WalkSAT post-processing.

Counterpart of the p-d-p assembly of `pdp_solver_tpu/solvers/base.py`
(`SolverConfig`, `PDPSolver.forward`/`_forward`/`_forward_core` :332-603,
`local_search`/`_local_search` :607-828). The other five assemblies are not
ported yet.

The JAX hot loop is one `lax.while_loop` that stops once no instance is
active. Here it is a Python loop of `iteration_num` iterations with no host
sync: the caller runs it in chunks (the resumable `carry=` /
`finalize=False` API) and reads the per-instance active flags once per
chunk. Once no instance is active an iteration changes nothing but the
decimator's counters, which are held with a device-side flag, so running
out the chunk gives what the JAX loop gives.

All randomness comes from one CPU `torch.Generator` (the same numbers on
the CPU and on the card for the same seed); what the device needs is
copied there.
"""

import dataclasses

import torch

from pdp_solver_tpu_torch.modules import decimate as D
from pdp_solver_tpu_torch.modules import predict as P
from pdp_solver_tpu_torch.modules import propagate as PR
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import segment_argmax_first, segment_sum
from pdp_solver_tpu_torch.ops.walksat import (
    use_walksat_block, walksat_block, walksat_edge_constants)
from pdp_solver_tpu_torch.problem.simplify import fused_simplify
from pdp_solver_tpu_torch.problem.state import (
    ProblemState, compute_edge_mask, edge_active_instance_mask,
    edge_masks_pair, init_problem_state)
from pdp_solver_tpu_torch.train.loss import cnf_evaluate

# WalkSAT iterations per block launch (the JAX package's PDP_WALKSAT_K
# default)
WALKSAT_K = 8


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The p-d-p fields of the JAX package's SolverConfig (same names and
    defaults); the neural assemblies' fields come with their port."""
    model_type: str
    tolerance: float = 0.02
    t_max: float = 100.0
    # fix every variable within this fraction of the instance's max
    # |score| per convergence event (1.0 = argmax only, the reference rule)
    decimation_threshold: float = 1.0
    # argmax-only end-game once an instance's active-var count <= guard
    decimation_guard: float = 0.0
    # cap on simplify rounds per decimation; 0 = run to the fixed point
    simplify_rounds: int = 0
    local_search_iterations: int = 0
    epsilon: float = 0.05


@dataclasses.dataclass
class SolverState:
    prop: PR.SPMessages            # propagator messages
    dec: PR.SPMessages             # messages the decimator hands back
    aux: D.SeqDecimatorState       # sequential decimator bookkeeping


def random_seed32(generator) -> int:
    """One signed 32-bit seed drawn on the host."""
    return int(torch.randint(-(1 << 31), 1 << 31, (1,),
                             generator=generator).item())


def _uniform(generator, shape, device):
    return torch.rand(shape, generator=generator).to(device)


class PDPSolver:
    """The classical p-d-p assembly."""

    def __init__(self, config: SolverConfig):
        self.cfg = config
        t = config.model_type
        if t not in ("np-nd-np", "p-nd-np", "np-d-np", "p-d-p", "walk-sat",
                     "reinforce"):
            raise ValueError(f"unknown model_type {t!r}")
        if t != "p-d-p":
            raise NotImplementedError(
                f"model_type {t!r} is not ported yet (only p-d-p)")
        c = config
        self.prop_cfg = PR.SurveyPropagatorConfig()
        self.dec_cfg = D.SeqDecimatorConfig(
            tolerance=c.tolerance, t_max=c.t_max,
            decimation_threshold=c.decimation_threshold,
            decimation_guard=c.decimation_guard,
            simplify_rounds=c.simplify_rounds)
        self.scorer_cfg = P.SurveyScorerConfig()

    def get_init_state(self, generator, batch, randomized: bool
                       ) -> SolverState:
        """Random (or uniform) SP messages for the propagator and for the
        decimator's first hand-back, and fresh decimator bookkeeping."""
        E, dev = batch.num_edges, batch.device
        prop = PR.survey_propagator_init_state(generator, E, randomized,
                                               "cpu")
        dec = P.scorer_message_init_state(generator, E, randomized, "cpu")

        def to_dev(m):
            return PR.SPMessages(var=tuple(x.to(dev) for x in m.var),
                                 fn=tuple(x.to(dev) for x in m.fn))
        return SolverState(prop=to_dev(prop), dec=to_dev(dec),
                           aux=D.seq_decimator_init_state(batch))

    # -- forward --------------------------------------------------------

    def forward(self, params, generator, batch, init_state: SolverState,
                iteration_num: int, *, check_termination: bool = False,
                carry=None, finalize=True):
        """One solve (or one chunk of it).

        finalize=True returns ((variable_prediction [V, 1], None), state):
        the decimated solution with random fill on still-active variables,
        improved by local search when local_search_iterations > 0.
        finalize=False returns ((None, None), state, carry) with carry =
        (problem, active instances, edge mask); pass it back as `carry=` to
        continue the same solve."""
        if params:
            raise ValueError("p-d-p takes no parameters")
        if carry is None:
            problem = fused_simplify(batch, init_problem_state(batch))
            resume = None
        else:
            problem, active_b0, em0 = carry
            resume = (active_b0, em0)

        problem, state, active_b = self._forward_core(
            batch, problem, init_state, iteration_num, check_termination,
            resume)

        em = compute_edge_mask(batch, problem)
        if not finalize:
            return (None, None), state, (problem, active_b, em)

        pred = P.identity_predictor_apply(generator, problem,
                                          random_fill=True, last_call=True)
        var_pred = pred[0]
        if self.cfg.local_search_iterations > 0:
            var_pred = self._local_search(generator, batch, problem,
                                          var_pred)
        var_pred, problem = _update_solution(problem, var_pred)
        return (var_pred, None), state

    def _forward_core(self, batch, problem, state, iteration_num,
                      check_termination, resume=None):
        """The hot loop (solvers/base.py :456-603, unfolded path)."""
        if resume is not None:
            active_b, em = resume
        else:
            active_b = batch.instance_mask.clone()
            em = batch.edge_mask.clone()
        ae = edge_active_instance_mask(batch, active_b)

        for _ in range(iteration_num):
            prop = PR.survey_propagator_apply(
                self.prop_cfg, batch, state.prop, state.dec, em, ae)
            aux, problem, maybe_active = D.sequential_decimator_apply(
                self.dec_cfg, self.scorer_cfg, batch, state.aux, prop,
                problem, em, active_b if check_termination else None)
            if check_termination:
                # the JAX loop has stopped once no instance is active; the
                # counters are the only state a later iteration would move
                alive = torch.sum(active_b) > 0
                aux = D.SeqDecimatorState(
                    prev_eta=aux.prev_eta,
                    counters=torch.where(alive, aux.counters,
                                         state.aux.counters),
                    has_prev=torch.where(alive, aux.has_prev,
                                         state.aux.has_prev))
                active_b = maybe_active
            state = SolverState(prop=prop, dec=prop, aux=aux)

            if check_termination:
                pred, _ = P.identity_predictor_apply(
                    None, problem, random_fill=True, last_call=False)
                var_pred, problem = _update_solution(problem, pred)
                solved, _ = cnf_evaluate(batch, var_pred)
                active_b = active_b * (solved <= 0.5).to(torch.float32)
            em, ae = edge_masks_pair(batch, problem, active_b)
        return problem, state, active_b

    # -- WalkSAT local search -------------------------------------------

    def local_search(self, generator, batch, problem, var_pred, iterations,
                     seeds=None):
        """Runs `iterations` WalkSAT flips from the prediction and returns
        the improved prediction [V, 1]; feeding the output back in
        continues the search. `seeds` optionally fixes the block seeds
        (one per block of WALKSAT_K iterations)."""
        return self._local_search(generator, batch, problem, var_pred,
                                  iterations, seeds)

    def _local_search(self, generator, batch, problem, var_pred,
                      iterations=None, seeds=None):
        """eps-greedy WalkSAT on the still-active subgraph, one flip per
        instance per iteration: blocks of WALKSAT_K iterations per kernel
        launch, the remainder one chained pass per iteration."""
        V, B, dev = batch.num_vars, batch.batch_size, batch.device
        eps = self.cfg.epsilon
        iters = (self.cfg.local_search_iterations if iterations is None
                 else iterations)
        av = problem.active_vars
        assign = (var_pred[:, 0] > 0.5).to(torch.float32)
        assign = av * (2.0 * assign - 1.0)
        em = compute_edge_mask(batch, problem)

        # after every instance is satisfied a block or iteration flips
        # nothing, so the loops run out without a done test
        K = WALKSAT_K
        if use_walksat_block(batch) and iters >= K > 1:
            econst = walksat_edge_constants(batch, av)
            for blk in range(iters // K):
                seed = (seeds[blk] if seeds is not None
                        else random_seed32(generator))
                assign, _ = walksat_block(
                    assign, batch=batch, active_vars=av,
                    active_clauses=problem.active_clauses, em=em, K=K,
                    seed=seed, eps=eps, edge_constants=econst)
            iters = iters % K

        arange_v = torch.arange(V, device=dev)
        for _ in range(iters):
            _, vd, _, iout = fused.chained_edge_pass(
                fused.WS_CHAIN, batch,
                (assign * av, av, batch.edge_sign, batch.edge_mask, em,
                 problem.active_clauses))
            unsat_b = ((iout[0] > 0).to(torch.float32)
                       * batch.instance_mask)
            best_ind = segment_argmax_first(-vd[0], batch.var_batch, B,
                                            valid=batch.var_mask)
            unsat_v = ((vd[1] * av) > 0).to(torch.float32)
            noise = unsat_v * _uniform(generator, (V,), dev)
            rand_ind = segment_argmax_first(noise, batch.var_batch, B,
                                            valid=batch.var_mask)
            coin = _uniform(generator, (B,), dev) > eps
            chosen = torch.where(coin, best_ind, rand_ind)
            sel = ((arange_v == chosen[batch.var_batch])
                   & (unsat_b[batch.var_batch] > 0))
            assign = torch.where(sel, -assign, assign)
        return ((assign + 1.0) / 2.0)[:, None]


def build_solver(config) -> PDPSolver:
    """A PDPSolver from a SolverConfig or a flat dict with the reference's
    key names (keys of the unported assemblies are ignored)."""
    if isinstance(config, SolverConfig):
        return PDPSolver(config)
    c = dict(config)
    return PDPSolver(SolverConfig(
        model_type=c["model_type"],
        tolerance=c.get("tolerance", 0.02),
        t_max=float(c.get("t_max", 100)),
        decimation_threshold=c.get("decimation_threshold", 1.0),
        decimation_guard=c.get("decimation_guard", 0.0),
        simplify_rounds=int(c.get("simplify_rounds", 0)),
        local_search_iterations=c.get("local_search_iteration", 0),
        epsilon=c.get("epsilon", 0.05),
    ))


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def _update_solution(problem: ProblemState, var_pred):
    """Merge the prediction into the solution on active variables."""
    if var_pred is None:
        return None, problem
    av = problem.active_vars[:, None]
    merged = av * var_pred + (1.0 - av) * problem.solution[:, None]
    return merged, problem.replace(solution=merged[:, 0])


def _group_any(solved, replication):
    """Any-replica-solved, broadcast back to every replica."""
    if replication <= 1:
        return solved
    g = solved.reshape(replication, -1)
    return torch.amax(g, dim=0).repeat(replication)


def _compute_energy(batch, problem: ProblemState, assign):
    """#unsat active clauses per instance; assign f32[V] in {-1, 0, +1}.
    Returns (energy f32[B], unsat f32[F])."""
    F, B = batch.num_clauses, batch.batch_size
    av_e = (assign * problem.active_vars)[batch.edge_var] * batch.edge_mask
    deg_e = problem.active_vars[batch.edge_var] * batch.edge_mask
    agg = segment_sum(batch.edge_sign * av_e, batch.edge_clause, F)
    degree = segment_sum(deg_e, batch.edge_clause, F)
    unsat = (agg == -degree).to(torch.float32) * problem.active_clauses
    return segment_sum(unsat, batch.clause_batch, B), unsat


def _compute_energy_diff(batch, problem: ProblemState, assign, em):
    """Per-variable energy delta if flipped: signed assignments summed over
    the edges whose clause is decided by that edge's literal alone."""
    V, F = batch.num_vars, batch.num_clauses
    dist = (batch.edge_sign * (assign * problem.active_vars)[batch.edge_var]
            * batch.edge_mask)
    deg_e = problem.active_vars[batch.edge_var] * batch.edge_mask
    agg = segment_sum(dist, batch.edge_clause, F)[batch.edge_clause] - dist
    degree = segment_sum(deg_e, batch.edge_clause, F)[batch.edge_clause]
    critical = (agg == (1.0 - degree)).to(torch.float32) * em
    return segment_sum(critical * dist, batch.edge_var, V)
