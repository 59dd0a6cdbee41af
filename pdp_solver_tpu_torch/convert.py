"""Carry weights and state from the JAX package into the port.

The JAX side hands over numpy arrays (`jax.tree_util.tree_map(np.asarray,
x)` keeps its NamedTuple structure); nothing here imports JAX.
"""

import numpy as np
import torch

from pdp_solver_tpu_torch.modules.decimate import SeqDecimatorState
from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.problem.state import ProblemState
from pdp_solver_tpu_torch.solvers.base import SolverState


def _t(x, device):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def params_from_jax(np_params):
    """Parameters of the ported assemblies. p-d-p has none (the JAX
    package's init_params returns {} for it), so this returns {} and
    raises on any key it does not know."""
    unknown = sorted(dict(np_params))
    if unknown:
        raise KeyError(f"no ported module takes parameters {unknown}")
    return {}


def messages_from_jax(np_msgs, device="cuda") -> SPMessages:
    """A JAX SPMessages ((q_u, q_s, q_dc), (eta, force))."""
    var, fn = np_msgs
    return SPMessages(var=tuple(_t(x, device) for x in var),
                      fn=tuple(_t(x, device) for x in fn))


def seq_decimator_state_from_jax(np_aux, device="cuda") -> SeqDecimatorState:
    """A JAX SeqDecimatorState (prev_eta, counters, has_prev)."""
    prev_eta, counters, has_prev = np_aux
    return SeqDecimatorState(prev_eta=_t(prev_eta, device),
                             counters=_t(counters, device),
                             has_prev=_t(has_prev, device).reshape(()))


def problem_from_jax(np_problem, device="cuda") -> ProblemState:
    """A JAX ProblemState (active_vars, active_clauses, solution, is_sat)."""
    return ProblemState(*(_t(x, device) for x in np_problem))


def state_from_jax(np_state, device="cuda"):
    """A JAX SolverState (prop, dec, aux), SPMessages or SeqDecimatorState
    as numpy arrays -> the port's dataclass of tensors on `device`."""
    kind = type(np_state).__name__
    if kind == "SPMessages":
        return messages_from_jax(np_state, device)
    if kind == "SeqDecimatorState":
        return seq_decimator_state_from_jax(np_state, device)
    if kind == "ProblemState":
        return problem_from_jax(np_state, device)
    if kind == "SolverState" or len(np_state) == 3:
        prop, dec, aux = np_state
        return SolverState(prop=messages_from_jax(prop, device),
                           dec=messages_from_jax(dec, device),
                           aux=seq_decimator_state_from_jax(aux, device))
    raise TypeError(f"cannot convert {kind}")
