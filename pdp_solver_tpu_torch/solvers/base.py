"""Solver assemblies: propagator x decimator x predictor, with WalkSAT
post-processing.

Counterpart of `pdp_solver_tpu/solvers/base.py` (`SolverConfig`,
`PDPSolver.forward`/`_forward`/`_forward_core` :332-603,
`local_search`/`_local_search` :607-828, `_deduplicate` :917) for its six
assemblies:
  p-d-p     SP propagator + sequential decimator (SP scorer) + identity
            predictor;
  np-d-np   neural propagator + sequential decimator over its fn[:, 0]
            (scored by a neural predictor with a tanh head) + identity
            predictor, with parameters "prop" and "scorer";
  np-nd-np  neural propagator + neural (GRU) decimator + neural predictor,
            with parameters (`init_params`, or a JAX checkpoint through
            `convert.params_from_jax`);
  p-nd-np   SP propagator reading the neural decimator's states through
            learned adaptors + neural (GRU) decimator over the stacked SP
            columns + neural predictor, with parameters as np-nd-np;
  walk-sat  no hot loop: WalkSAT from the simplified problem's identity
            prediction (random fill on the active variables);
  reinforce SP propagator with the external-force factor pi + REINFORCE
            decimator (SP scorer with pi) + REINFORCE predictor.

In-batch replication (`forward(replication=R)`, the reference's
batch_replication): the batch is replicated R times
(`fg.batch.replicate_batch`), every instance's replicas run side by side
from independent inits (`get_init_state(replication=R)`), an instance
stops once any of its replicas is solved (`_group_any`), the WalkSAT
blocks stop once every instance has a solved replica, and each instance
keeps its first replica of least energy (`_deduplicate`). As in the JAX
package, a resumed solve (`carry=`) takes a batch the caller replicated.

The JAX hot loop is one `lax.while_loop` that stops once no instance is
active. Here it is a Python loop of `iteration_num` iterations with no host
sync: the caller runs it in chunks (the resumable `carry=` /
`finalize=False` API) and reads the per-instance active flags once per
chunk. A p-d-p loop with check_termination takes the JAX package's sweep
folds where it would (`modules/propagate.py sweep_folds`: by default on
the card): the decimator's pass, the edge masks and the verification
ride the sweep's chained pass. With check_termination and
PDP_VERIFY_MASKS=on (read at each call,
default off, as in the JAX package) an eligible batch without the
verify fold verifies the prediction and builds the next edge masks in
one launch (`ops/verify.py`)
instead of `cnf_evaluate`, the freeze and `edge_masks_pair`. Once no
instance is active an iteration changes nothing but the sequential
decimator's counters, which are held with a device-side flag,
so running out the chunk gives what the JAX loop gives. (The neural
states of a stopped instance are frozen, and its prediction and solution
are recomputed from them unchanged.)

Training (np-nd-np, p-nd-np, np-d-np): `forward(..., is_training=True)`
is JAX's `_forward` under is_training, differentiable and outside
no_grad; the trainer is `train/trainer.py`. p-nd-np's SP sweep then takes
its differentiable route (`propagate.sp_sweep_train`, kernel 4 and its
backward rule on the card), and np-d-np's sequential decimator runs on
detached messages under no_grad, its kernels 1 and 2 included: its picks
are an argmax and a sign, through which JAX's gradient is zero (its
stop_gradient of the problem, solvers/base.py:534-542).

Per-instance meta features (`FGBatch.graph_feat`, f32[B, meta_dim]) are
injected as JAX's `_forward` does (:377-399): the dataset's when the
config declares meta_dim > 0 (a width mismatch raises ValueError), zeros
when the dataset has none, and none at meta_dim 0. They reach the edges
once (`common.instances_to_edges`) and every neural module's inputs
(np-d-np's scorer takes none, as in JAX).

The classical draws (message inits, REINFORCE's per-iteration coin, the
random fills) come from one CPU `torch.Generator` (the same numbers on the
CPU and on the card for the same seed); what the device needs is copied
there. The [E, h] neural states (four for np-nd-np, two for p-nd-np's
decimator) are drawn on the batch's device, from a generator seeded by
the CPU one.
"""

import dataclasses
import os

import torch
from torch import nn

from pdp_solver_tpu_torch.fg.batch import replicate_batch
from pdp_solver_tpu_torch.modules import decimate as D
from pdp_solver_tpu_torch.modules.common import instances_to_edges
from pdp_solver_tpu_torch.modules.mlp import COMPUTE_DTYPES
from pdp_solver_tpu_torch.modules import predict as P
from pdp_solver_tpu_torch.modules import propagate as PR
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import segment_argmax_first, segment_sum
from pdp_solver_tpu_torch.ops.verify import use_verify_masks, verify_and_masks
from pdp_solver_tpu_torch.ops.walksat import (
    replicas_done, use_walksat_block, walksat_walk)
from pdp_solver_tpu_torch.problem.simplify import fused_simplify
from pdp_solver_tpu_torch.problem.state import (
    ProblemState, compute_edge_mask, edge_active_instance_mask,
    edge_masks_pair, init_problem_state)
from pdp_solver_tpu_torch.train.loss import cnf_evaluate

# WalkSAT iterations per block, one seed a block (the JAX package's
# PDP_WALKSAT_K default)
WALKSAT_K = 8


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The fields of the JAX package's SolverConfig that the ported
    assemblies read (same names and defaults)."""
    model_type: str
    name: str = "pdp-solver"
    edge_dim: int = 1
    meta_dim: int = 0
    hidden_dim: int = 150
    prediction_dim: int = 1
    mem_hidden_dim: int = 100
    agg_hidden_dim: int = 100
    mem_agg_hidden_dim: int = 50
    classifier_dim: int = 50
    # the neural propagator's dropout, in training only
    dropout: float = 0.0
    tolerance: float = 0.02
    t_max: float = 100.0
    # REINFORCE: the external-force factor of SP and the scorer, and the
    # per-iteration probability of rewriting the forces
    pi: float = 0.0
    decimation_probability: float = 0.5
    # fix every variable within this fraction of the instance's max
    # |score| per convergence event (1.0 = argmax only, the reference rule)
    decimation_threshold: float = 1.0
    # argmax-only end-game once an instance's active-var count <= guard
    decimation_guard: float = 0.0
    # cap on simplify rounds per decimation; 0 = run to the fixed point
    simplify_rounds: int = 0
    local_search_iterations: int = 0
    epsilon: float = 0.05
    # "bfloat16" runs the neural aggregators and GRU cells in bf16
    # (modules/mlp.py), whatever parameters are passed; the message and
    # state storage, the classifiers and all classical math stay f32, as in
    # the JAX package
    compute_dtype: str = "float32"


@dataclasses.dataclass
class SolverState:
    """p-d-p: SPMessages, SPMessages, SeqDecimatorState.
    reinforce: SPMessages, SPMessages, ReinforceDecimatorState.
    np-nd-np: (var, fn) [E, h] pairs for prop and dec, and aux ().
    np-d-np: (var, fn) [E, h] pairs for prop and dec (the propagator's
    last output), and SeqDecimatorState.
    p-nd-np: SPMessages for prop, a (var, fn) [E, h] pair for dec, and
    aux ().
    walk-sat: (), (), ()."""
    prop: object      # propagator message state
    dec: object       # decimator state / the messages it hands back
    aux: object       # sequential decimator bookkeeping, or ()


def random_seed32(generator) -> int:
    """One signed 32-bit seed drawn on the host."""
    return int(torch.randint(-(1 << 31), 1 << 31, (1,),
                             generator=generator).item())


def _uniform(generator, shape, device):
    return torch.rand(shape, generator=generator).to(device)


class PDPSolver:
    """The p-d-p, np-d-np, np-nd-np, p-nd-np, walk-sat and reinforce
    assemblies."""

    def __init__(self, config: SolverConfig):
        self.cfg = config
        t = config.model_type
        if t not in ("np-nd-np", "p-nd-np", "np-d-np", "p-d-p", "walk-sat",
                     "reinforce"):
            raise ValueError(f"unknown model_type {t!r}")
        if config.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(COMPUTE_DTYPES)}, not "
                             f"{config.compute_dtype!r}")
        c = config
        self.prop_cfg = self.dec_cfg = self.scorer_cfg = None
        # which parts are neural: the propagator (np-nd-np, np-d-np), the
        # GRU decimator and the neural predictor (np-nd-np, p-nd-np)
        self.neural_prop = t in ("np-nd-np", "np-d-np")
        self.neural_dec = t in ("np-nd-np", "p-nd-np")
        if t == "walk-sat":
            return
        seq_cfg = D.SeqDecimatorConfig(
            tolerance=c.tolerance, t_max=c.t_max,
            decimation_threshold=c.decimation_threshold,
            decimation_guard=c.decimation_guard,
            simplify_rounds=c.simplify_rounds)
        if t == "p-d-p":
            self.prop_cfg = PR.SurveyPropagatorConfig()
            self.dec_cfg = seq_cfg
            self.scorer_cfg = P.SurveyScorerConfig()
            return
        if t == "reinforce":
            self.prop_cfg = PR.SurveyPropagatorConfig(pi=c.pi)
            self.dec_cfg = D.ReinforceDecimatorConfig(
                decimation_probability=c.decimation_probability)
            self.scorer_cfg = P.SurveyScorerConfig(pi=c.pi)
            return
        neural_prop_cfg = PR.NeuralPropagatorConfig(
            edge_dim=c.edge_dim, decimator_dim=c.hidden_dim,
            meta_dim=c.meta_dim, hidden_dim=c.hidden_dim,
            mem_hidden_dim=c.mem_hidden_dim,
            mem_agg_hidden_dim=c.mem_agg_hidden_dim,
            agg_hidden_dim=c.agg_hidden_dim, dropout=c.dropout,
            compute_dtype=c.compute_dtype)
        if t == "np-d-np":
            # the sequential decimator's scorer is a neural predictor with
            # a tanh head and one output (reference solver.py:630-634)
            self.prop_cfg = neural_prop_cfg
            self.dec_cfg = seq_cfg
            self.scorer_cfg = self._predictor_cfg(1, "tanh")
            return
        if t == "p-nd-np":
            self.prop_cfg = PR.SurveyPropagatorConfig(
                include_adaptors=True, decimator_dim=c.hidden_dim)
            # SP messages arrive as [E, 3] var / [E, 2] fn blocks (the JAX
            # package's fix of the reference's (3, 1), solvers/base.py:170)
            msg_dims = (3, 2)
        else:
            self.prop_cfg = neural_prop_cfg
            msg_dims = (c.hidden_dim, c.hidden_dim)
        self.dec_cfg = D.NeuralDecimatorConfig(
            var_message_dim=msg_dims[0], fn_message_dim=msg_dims[1],
            meta_dim=c.meta_dim, hidden_dim=c.hidden_dim,
            edge_dim=c.edge_dim, dropout=c.dropout,
            compute_dtype=c.compute_dtype)
        self.pred_cfg = self._predictor_cfg(c.prediction_dim, "sigmoid")

    def _predictor_cfg(self, prediction_dim, kind):
        c = self.cfg
        return P.NeuralPredictorConfig(
            decimator_dim=c.hidden_dim, prediction_dim=prediction_dim,
            edge_dim=c.edge_dim, meta_dim=c.meta_dim,
            mem_hidden_dim=c.mem_hidden_dim,
            agg_hidden_dim=c.agg_hidden_dim,
            mem_agg_hidden_dim=c.mem_agg_hidden_dim,
            classifier_dim=c.classifier_dim, classifier_kind=kind,
            compute_dtype=c.compute_dtype)

    def _param_keys(self):
        if self.neural_dec:
            return ("prop", "dec", "predictor")
        return ("prop", "scorer") if self.neural_prop else ()

    def init_params(self, device="cuda"):
        """Freshly initialised parameters: {} for the classical assemblies
        (p-d-p, walk-sat, reinforce); for np-nd-np and p-nd-np a
        ModuleDict of the propagator ("prop": the neural propagator, or
        p-nd-np's SP adaptors), the decimator ("dec") and the predictor
        ("predictor"); for np-d-np one of the neural propagator ("prop")
        and the decimator's scorer ("scorer"); in eval mode (a trainer
        puts them in train mode, which turns dropout on)."""
        if not self._param_keys():
            return {}
        prop = (PR.NeuralPropagator(self.prop_cfg) if self.neural_prop
                else PR.SurveyAdaptors(self.prop_cfg))
        if not self.neural_dec:
            parts = {"prop": prop,
                     "scorer": P.NeuralPredictor(self.scorer_cfg)}
        else:
            parts = {"prop": prop, "dec": D.NeuralDecimator(self.dec_cfg),
                     "predictor": P.NeuralPredictor(self.pred_cfg)}
        return nn.ModuleDict(parts).to(device).eval()

    def get_init_state(self, generator, batch, randomized: bool,
                       replication: int = 1) -> SolverState:
        """p-d-p and reinforce: random (or uniform) SP messages for the
        propagator and for the decimator's first hand-back, and fresh
        decimator bookkeeping. np-nd-np: random U(-1, 1) (or zero) [E, h]
        states. np-d-np: two such pairs (the propagator's, and the one
        its first decimation reads) and fresh decimator bookkeeping.
        p-nd-np: SP messages for the propagator (from the CPU generator)
        and U(-1, 1) (or zero) [E, h] states for the decimator. walk-sat:
        no state. With replication R, the state of the R-fold replicated
        batch (R * E edges, R * B instances)."""
        E, dev = batch.num_edges * replication, batch.device
        if self.cfg.model_type == "walk-sat":
            return SolverState(prop=(), dec=(), aux=())

        def neural_states(n):
            g = torch.Generator(device=dev)
            g.manual_seed(random_seed32(generator))
            return [PR.neural_init_state(g, E, self.cfg.hidden_dim,
                                         randomized, dev) for _ in range(n)]

        def to_dev(m):
            return PR.SPMessages(var=tuple(x.to(dev) for x in m.var),
                                 fn=tuple(x.to(dev) for x in m.fn))
        if self.neural_prop:
            prop, dec = neural_states(2)
            aux = (() if self.neural_dec
                   else D.seq_decimator_init_state(batch, replication))
            return SolverState(prop=prop, dec=dec, aux=aux)
        prop = to_dev(PR.survey_propagator_init_state(generator, E,
                                                      randomized, "cpu"))
        if self.neural_dec:
            return SolverState(prop=prop, dec=neural_states(1)[0], aux=())
        dec = P.scorer_message_init_state(generator, E, randomized, "cpu")
        aux = (D.reinforce_decimator_init_state(batch, replication)
               if self.cfg.model_type == "reinforce"
               else D.seq_decimator_init_state(batch, replication))
        return SolverState(prop=prop, dec=to_dev(dec), aux=aux)

    # -- building blocks ------------------------------------------------

    def _check_params(self, params):
        keys = self._param_keys()
        if not keys:
            if params:
                raise ValueError(f"{self.cfg.model_type} takes no "
                                 "parameters")
            return
        missing = set(keys) - set(params or {})
        if missing:
            raise ValueError(f"{self.cfg.model_type} parameters lack "
                             f"{sorted(missing)}")

    def _meta_edges(self, batch):
        """The per-edge meta features [E, meta_dim], or None (JAX _forward
        :377-399)."""
        md = self.cfg.meta_dim
        if md <= 0:
            return None
        have = batch.graph_feat.shape[1]
        if have > 0:
            if have != md:
                raise ValueError(f"dataset meta feature width {have} != "
                                 f"configured meta_feature_dim {md}")
            feat = batch.graph_feat
        else:
            feat = torch.zeros((batch.batch_size, md), device=batch.device)
        return instances_to_edges(batch, feat)

    def _propagate(self, params, batch, prop, dec, em, ae, meta_e=None,
                   generator=None):
        if self.neural_prop:
            return params["prop"](batch, prop, dec, em, ae,
                                  self.cfg.compute_dtype,
                                  generator=generator, meta_e=meta_e)
        return PR.survey_propagator_apply(
            self.prop_cfg, batch, prop, dec, em, ae,
            adaptors=params["prop"] if self.neural_dec else None)

    def _scorer_fn(self, params, batch):
        """np-d-np's score of each variable [V, 1]: the tanh predictor on
        the propagator's messages under their own edge mask (JAX
        solvers/base.py _scorer_fn :286-293); None for the survey scorer
        of p-d-p, which rides the decimator's pass."""
        if not self.neural_prop or self.neural_dec:
            return None

        def fn(message_state, problem):
            em = compute_edge_mask(batch, problem)
            return params["scorer"](batch, message_state, em,
                                    self.cfg.compute_dtype)[0]
        return fn

    def _predict(self, params, generator, batch, problem, dec, em,
                 last_call, meta_e=None):
        """The variable prediction [V, 1]."""
        if self.neural_dec:
            return params["predictor"](batch, dec, em,
                                       self.cfg.compute_dtype,
                                       meta_e=meta_e)[0]
        if self.cfg.model_type == "reinforce":
            return P.reinforce_predictor_apply(batch, dec)[0]
        return P.identity_predictor_apply(generator, problem,
                                          random_fill=True,
                                          last_call=last_call)[0]

    # -- forward --------------------------------------------------------

    def forward(self, params, generator, batch, init_state: SolverState,
                iteration_num: int, *, is_training: bool = False,
                check_termination: bool = False, replication: int = 1,
                carry=None, finalize=True):
        """One solve (or one chunk of it), under torch.no_grad(); with
        is_training=True the differentiable training forward instead
        (`_forward_train`, the neural assemblies), whose `generator` is the
        one its dropout masks are drawn from, on the batch's device.

        finalize=True returns ((variable_prediction [V, 1], None), state):
        the decimated solution with random fill on still-active variables
        (p-d-p, np-d-np, walk-sat), the sign of the summed forces
        (reinforce) or the neural prediction (np-nd-np, p-nd-np), improved
        by local search when local_search_iterations > 0. walk-sat runs no
        hot loop: its state comes back untouched and every instance stays
        active. finalize=False returns ((None, None), state, carry) with
        carry = (problem, active instances, edge mask); pass it back as
        `carry=` to continue the same solve.

        replication R > 1: init_state is the replicated batch's
        (get_init_state(..., replication=R)); the state and the carry come
        back in the replicated layout and the prediction, deduplicated, in
        the batch's. With `carry=` the batch must already be replicated
        (as in the JAX package)."""
        if is_training:
            return self._forward_train(params, generator, batch, init_state,
                                       iteration_num)
        with torch.no_grad():
            return self._forward(params, generator, batch, init_state,
                                 iteration_num, check_termination,
                                 replication, carry, finalize)

    def _forward(self, params, generator, batch, init_state, iteration_num,
                 check_termination, replication, carry, finalize):
        self._check_params(params)
        if replication > 1 and carry is None:
            batch = replicate_batch(batch, replication)
        if carry is None:
            problem = fused_simplify(batch, init_problem_state(batch))
            resume = None
        else:
            problem, active_b0, em0 = carry
            resume = (active_b0, em0)

        meta_e = self._meta_edges(batch)
        if self.cfg.model_type == "walk-sat":
            state, active_b = init_state, batch.instance_mask.clone()
        else:
            problem, state, active_b = self._forward_core(
                params, generator, batch, problem, init_state,
                iteration_num, check_termination, resume, replication,
                meta_e)

        em = compute_edge_mask(batch, problem)
        if not finalize:
            return (None, None), state, (problem, active_b, em)

        var_pred = self._predict(params, generator, batch, problem,
                                 state.dec, em, last_call=True,
                                 meta_e=meta_e)
        if self.cfg.local_search_iterations > 0:
            var_pred = self._local_search(generator, batch, problem,
                                          var_pred, replication=replication)
        var_pred, problem = _update_solution(problem, var_pred)
        if replication > 1:
            var_pred = _deduplicate(batch, problem, var_pred, replication)
        return (var_pred, None), state

    def check_trainable(self):
        """Raise unless the assembly has a training forward (the neural
        ones: np-nd-np, p-nd-np, np-d-np)."""
        t = self.cfg.model_type
        if not (self.neural_prop or self.neural_dec):
            raise NotImplementedError(
                f"{t} has no parameters to train: the neural assemblies "
                "(np-nd-np, p-nd-np, np-d-np) train")

    def _forward_train(self, params, generator, batch, state,
                       iteration_num):
        """JAX `_forward` under is_training (:352-454): no simplification
        first, an unrolled loop of iteration_num iterations with no
        termination check, then the prediction merged into the solution;
        no local search and no replication. np-nd-np and p-nd-np predict
        with the neural predictor; np-d-np with its scorer's soft
        assignment (tanh score + 1) / 2 (JAX :426-439). The propagator's
        dropout (modules in .train()) draws from `generator`. Returns
        ((variable_prediction [V, 1], None), state), differentiable in
        the parameters and in the init state's neural tensors; np-d-np's
        `aux` carries no grad."""
        problem, state, meta_e = self._train_core(
            params, generator, batch, state, iteration_num)
        if self.neural_dec:
            em = compute_edge_mask(batch, problem)
            var_pred = self._predict(params, None, batch, problem, state.dec,
                                     em, last_call=True, meta_e=meta_e)
        else:
            score = self._scorer_fn(params, batch)(state.dec, problem)
            var_pred = (score + 1.0) * 0.5
        var_pred, _ = _update_solution(problem, var_pred)
        return (var_pred, None), state

    def _train_core(self, params, generator, batch, state, iteration_num):
        """The training forward's loop (JAX `_forward_core` under
        is_training): returns (problem, state, meta_e). The problem starts
        fresh; only np-d-np's decimator changes it. Its decimation runs on
        detached messages under no_grad, so kernels 1 (`smax`) and 2
        (`sround`) launch on the card, and its scorer call there is
        detached too; the differentiable scorer call is the prediction's."""
        self.check_trainable()
        self._check_params(params)
        meta_e = self._meta_edges(batch)
        problem = init_problem_state(batch)
        active_b = batch.instance_mask
        em = batch.edge_mask
        ae = edge_active_instance_mask(batch, active_b)
        dtype = self.cfg.compute_dtype
        scorer_fn = self._scorer_fn(params, batch)
        for _ in range(iteration_num):
            prop = self._propagate(params, batch, state.prop, state.dec, em,
                                   ae, meta_e, generator)
            if self.neural_dec:
                dec = params["dec"](batch, state.dec, prop, ae, dtype,
                                    meta_e=meta_e)
                state = SolverState(prop=prop, dec=dec, aux=())
            else:
                with torch.no_grad():
                    aux, problem, _ = D.sequential_decimator_apply(
                        self.dec_cfg, self.scorer_cfg, batch, state.aux,
                        tuple(x.detach() for x in prop), problem, em, None,
                        scorer_fn=scorer_fn)
                state = SolverState(prop=prop, dec=prop, aux=aux)
            # the masks carry no grad: the problem is a constant here, or
            # moved by the decimator's picks alone
            em, ae = edge_masks_pair(batch, problem, active_b)
        return problem, state, meta_e

    def _forward_core(self, params, generator, batch, problem, state,
                      iteration_num, check_termination, resume=None,
                      replication=1, meta_e=None):
        """The hot loop (solvers/base.py :456-603). REINFORCE draws its
        coin from `generator` once per iteration. With replication an
        instance is solved once any of its replicas is, and
        PDP_VERIFY_MASKS's one-launch verification is not taken, as in
        the JAX package. A p-d-p loop
        with check_termination folds work into its sweep wherever the JAX
        package would (`propagate.sweep_folds`, :478-494): the
        decimator's pass, then the edge masks, then the verification of
        the current solution, which freezes the instances it finds solved
        before this iteration's decimation. That verification is of the
        solution the previous iteration left (the in-loop identity
        prediction changes no solution), so the active flags follow the
        unfolded path's, except that the sweep's own freeze and the exit
        lag the last verification by one iteration."""
        t = self.cfg.model_type
        fold_dec, fold_masks, fold_verify = (
            PR.sweep_folds(batch) if t == "p-d-p" and check_termination
            else (False, False, False))
        # the verification in one launch with the next masks yields to the
        # verify fold, as in the JAX package (:550)
        use_vm = (check_termination and replication == 1
                  and not fold_verify and use_verify_masks(batch)
                  and os.environ.get("PDP_VERIFY_MASKS", "off") == "on")
        seq = not self.neural_dec and t != "reinforce"
        scorer_fn = self._scorer_fn(params, batch)
        if resume is not None:
            active_b, em = resume
        else:
            active_b = batch.instance_mask.clone()
            em = batch.edge_mask.clone()
        ae = edge_active_instance_mask(batch, active_b)

        for _ in range(iteration_num):
            if seq and check_termination:
                # the JAX loop runs this iteration while an instance is
                # active
                alive = torch.sum(active_b) > 0
            prop_agg = None
            if fold_verify:
                prop, prop_agg, em, ae, (max_sat, got_sat) = \
                    PR.survey_propagate_folded_masks(
                        self.prop_cfg, batch, state.prop, state.dec,
                        problem, active_b, verify=True)
                solved = _group_any((max_sat == got_sat).to(torch.float32),
                                    replication)
                active_b = active_b * (solved <= 0.5).to(torch.float32)
            elif fold_masks:
                prop, prop_agg, em, ae = PR.survey_propagate_folded_masks(
                    self.prop_cfg, batch, state.prop, state.dec, problem,
                    active_b)
            elif fold_dec:
                prop, prop_agg = PR.survey_propagate_with_decimator_agg(
                    self.prop_cfg, batch, state.prop, state.dec, em, ae,
                    problem.active_clauses)
            else:
                prop = self._propagate(params, batch, state.prop, state.dec,
                                       em, ae, meta_e)
            if self.neural_dec:
                # the neural decimator never changes the problem
                dec = params["dec"](batch, state.dec, prop, ae,
                                    self.cfg.compute_dtype, meta_e=meta_e)
                state = SolverState(prop=prop, dec=dec, aux=())
            elif t == "reinforce":
                # once no instance is active every edge is frozen and the
                # state stops moving, as when the JAX loop has exited
                coin = (float(torch.rand((), generator=generator))
                        < self.dec_cfg.decimation_probability)
                aux, dec, maybe_active = D.reinforce_decimator_apply(
                    self.dec_cfg, self.scorer_cfg, batch, state.aux, prop,
                    problem, em, active_b if check_termination else None,
                    ae, coin)
                if check_termination:
                    active_b = maybe_active
                state = SolverState(prop=prop, dec=dec, aux=aux)
            else:
                aux, problem, maybe_active = D.sequential_decimator_apply(
                    self.dec_cfg, self.scorer_cfg, batch, state.aux, prop,
                    problem, em, active_b if check_termination else None,
                    scorer_fn=scorer_fn, precomputed_agg=prop_agg)
                if check_termination:
                    # the JAX loop has stopped once no instance is active;
                    # the counters are the only state a later iteration
                    # would move
                    aux = D.SeqDecimatorState(
                        prev_eta=aux.prev_eta,
                        counters=torch.where(alive, aux.counters,
                                             state.aux.counters),
                        has_prev=torch.where(alive, aux.has_prev,
                                             state.aux.has_prev))
                    active_b = maybe_active
                state = SolverState(prop=prop, dec=prop, aux=aux)

            if check_termination and not fold_verify:
                pred = self._predict(params, None, batch, problem, state.dec,
                                     em, last_call=False, meta_e=meta_e)
                var_pred, problem = _update_solution(problem, pred)
                if use_vm:
                    # verification, the freeze of the instances it solved
                    # and the next masks in one launch
                    solved, _, em, ae = verify_and_masks(batch, problem,
                                                         active_b, var_pred)
                else:
                    solved, _ = cnf_evaluate(batch, var_pred)
                    solved = _group_any(solved, replication)
                active_b = active_b * (solved <= 0.5).to(torch.float32)
            # under the mask fold the next sweep makes its own masks
            if not (use_vm or fold_masks):
                em, ae = edge_masks_pair(batch, problem, active_b)
        return problem, state, active_b

    # -- WalkSAT local search -------------------------------------------

    @torch.no_grad()
    def local_search(self, generator, batch, problem, var_pred, iterations,
                     seeds=None, replication=1):
        """Runs `iterations` WalkSAT flips from the prediction and returns
        the improved prediction [V, 1]; feeding the output back in
        continues the search. `seeds` optionally fixes the block seeds
        (one per block of WALKSAT_K iterations). With replication the
        batch is a replicated one, and the search stops once every
        instance has a solved replica."""
        return self._local_search(generator, batch, problem, var_pred,
                                  iterations, seeds, replication)

    def _local_search(self, generator, batch, problem, var_pred,
                      iterations=None, seeds=None, replication=1):
        """eps-greedy WalkSAT on the still-active subgraph, one flip per
        instance per iteration: every whole block of WALKSAT_K iterations
        in one walksat_walk call (its block seeds drawn first; one kernel
        launch on the card, or one a block with replication), the
        remainder one chained pass per iteration. With replication the
        blocks, then the remaining iterations, stop once every instance
        has a solved replica (the JAX package's block_done): the walk tests
        it after each block on the device, the remainder carries it as a
        device flag that gates the flips, so neither syncs."""
        V, B, dev = batch.num_vars, batch.batch_size, batch.device
        eps = self.cfg.epsilon
        iters = (self.cfg.local_search_iterations if iterations is None
                 else iterations)
        av = problem.active_vars
        assign = (var_pred[:, 0] > 0.5).to(torch.float32)
        assign = av * (2.0 * assign - 1.0)
        em = compute_edge_mask(batch, problem)

        # without replication, a block or iteration flips nothing once every
        # instance is satisfied, so the loops run out without a done test;
        # with it, `live` is 0 once every instance has a solved replica
        R = replication
        live = torch.ones((), device=dev) if R > 1 else None
        K = WALKSAT_K
        if use_walksat_block(batch) and iters >= K > 1:
            n = iters // K
            if seeds is None:
                blocks = [random_seed32(generator) for _ in range(n)]
            elif len(seeds) < n:
                raise ValueError(f"local_search: {iters} iterations take "
                                 f"{n} block seeds, got {len(seeds)}")
            else:
                blocks = list(seeds[:n])
            assign, energy = walksat_walk(
                assign, batch=batch, active_vars=av,
                active_clauses=problem.active_clauses, em=em, K=K,
                seeds=blocks, eps=eps, replicas=R)
            iters = iters % K
            if R > 1:
                live = 1.0 - replicas_done(batch, energy, R)

        arange_v = torch.arange(V, device=dev)
        for _ in range(iters):
            _, vd, _, iout = fused.chained_edge_pass(
                fused.WS_CHAIN, batch,
                (assign * av, av, batch.edge_sign, batch.edge_mask, em,
                 problem.active_clauses))
            unsat_b = ((iout[0] > 0).to(torch.float32)
                       * batch.instance_mask)
            if live is not None:
                # this iteration still flips; the next one only if some
                # instance has no solved replica yet
                unsat_b = unsat_b * live
                live = live * (1.0 - replicas_done(batch, iout[0], R))
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
    key names (keys that no ported assembly reads are ignored;
    compute_dtype must be "float32" or "bfloat16")."""
    if isinstance(config, SolverConfig):
        return PDPSolver(config)
    c = dict(config)
    return PDPSolver(SolverConfig(
        model_type=c["model_type"],
        name=c.get("model_name", "pdp-solver"),
        edge_dim=c.get("edge_feature_dim", 1),
        meta_dim=c.get("meta_feature_dim", 0),
        hidden_dim=c.get("hidden_dim", 150),
        prediction_dim=c.get("prediction_dim", 1),
        mem_hidden_dim=c.get("mem_hidden_dim", 100),
        agg_hidden_dim=c.get("agg_hidden_dim", 100),
        mem_agg_hidden_dim=c.get("mem_agg_hidden_dim", 50),
        classifier_dim=c.get("classifier_dim", 50),
        dropout=c.get("dropout", 0.0),
        tolerance=c.get("tolerance", 0.02),
        t_max=float(c.get("t_max", 100)),
        pi=c.get("pi", 0.0),
        decimation_probability=c.get("decimation_probability", 0.5),
        decimation_threshold=c.get("decimation_threshold", 1.0),
        decimation_guard=c.get("decimation_guard", 0.0),
        simplify_rounds=int(c.get("simplify_rounds", 0)),
        local_search_iterations=c.get("local_search_iteration", 0),
        epsilon=c.get("epsilon", 0.05),
        compute_dtype=c.get("compute_dtype", "float32"),
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


def _deduplicate(rep_batch, problem: ProblemState, var_pred, replication):
    """Each instance's first replica of least energy (JAX solvers/base.py
    _deduplicate :917, reference solver.py:401-431): the replicated layout
    is [R, V0] by construction, so the pick is a reshape and an argmin
    (torch.argmin returns the first minimum). Returns [V0, 1]."""
    R = replication
    B0 = rep_batch.batch_size // R
    V0 = rep_batch.num_vars // R
    assign = 2.0 * var_pred[:, 0] - 1.0
    energy, _ = _compute_energy(rep_batch, problem, assign)
    best_r = torch.argmin(energy.reshape(R, B0), dim=0)
    pred_r = var_pred[:, 0].reshape(R, V0)
    v0 = torch.arange(V0, device=var_pred.device)
    return pred_r[best_r[rep_batch.var_batch[:V0]], v0][:, None]


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
