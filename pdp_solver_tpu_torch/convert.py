"""Carry weights and state from the JAX package into the port.

The JAX side hands over numpy arrays (`jax.tree_util.tree_map(np.asarray,
x)` keeps its NamedTuple structure), or a checkpoint `.npz` written by
`pdp_solver_tpu/train/checkpoint.py`; nothing here imports JAX.
"""

import re

import numpy as np
import torch

from pdp_solver_tpu_torch.modules.decimate import (
    ReinforceDecimatorState, SeqDecimatorState)
from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.problem.state import ProblemState
from pdp_solver_tpu_torch.solvers.base import (
    PDPSolver, SolverConfig, SolverState)

# JAX leaf name -> (torch parameter name, transposed?)
_LEAVES = {"w": ("weight", True), "b": ("bias", False),
           "w_ih": ("weight_ih", True), "w_hh": ("weight_hh", True),
           "b_ih": ("bias_ih", False), "b_hh": ("bias_hh", False)}
_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _t(x, device):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def load_jax_checkpoint(path):
    """A JAX checkpoint .npz as a nested dict of numpy arrays. Its keys are
    `jax.tree_util.keystr` paths such as "['params']['dec']['fn_gru']
    ['w_ih']"; a list index "[0]" becomes the int key 0, and a NamedTuple
    field ".mu" (the optimizer state's) the key "mu"."""
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            parts = [a or c or int(b)
                     for a, b, c in _KEY_PART.findall(key)]
            if not parts or "".join(
                    m.group(0) for m in _KEY_PART.finditer(key)) != key:
                raise ValueError(f"{path}: cannot parse key {key!r}")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def _flatten(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def _np_nd_np_config(tree):
    """The np-nd-np widths, read off the parameter shapes."""
    try:
        gru = tree["dec"]["var_gru"]
        agg = tree["prop"]["var_agg"]
        cls = tree["predictor"]["classifier"]
        hidden = np.shape(gru["w_hh"])[0]
        mem_agg = np.shape(agg["w2_m"]["w"])[1]
        return SolverConfig(
            model_type="np-nd-np", hidden_dim=hidden,
            edge_dim=np.shape(agg["w1_a"]["w"])[0] - mem_agg,
            mem_hidden_dim=np.shape(agg["w1_m"]["w"])[1],
            mem_agg_hidden_dim=mem_agg,
            agg_hidden_dim=np.shape(agg["w1_a"]["w"])[1],
            classifier_dim=np.shape(cls["l1"]["w"])[1],
            prediction_dim=np.shape(cls["l2"]["w"])[1])
    except (KeyError, TypeError, IndexError) as e:
        raise KeyError(f"not an np-nd-np parameter tree: lacks {e}") from e


def _np_d_np_config(tree):
    """The np-d-np widths, read off the parameter shapes: the propagator's
    aggregators as np-nd-np's (their w1_a takes the mem_agg columns and
    the sign feature), the scorer's classifier for classifier_dim (its
    aggregator's w1_a takes the mem_agg columns alone, NeuralPredictorConfig
    .aggregator_cfg's feature_dim 0; load_into checks its shapes)."""
    try:
        agg = tree["prop"]["var_agg"]
        cls = tree["scorer"]["classifier"]
        mem_agg = np.shape(agg["w2_m"]["w"])[1]
        return SolverConfig(
            model_type="np-d-np", hidden_dim=np.shape(agg["w2_a"]["w"])[1],
            edge_dim=np.shape(agg["w1_a"]["w"])[0] - mem_agg,
            mem_hidden_dim=np.shape(agg["w1_m"]["w"])[1],
            mem_agg_hidden_dim=mem_agg,
            agg_hidden_dim=np.shape(agg["w1_a"]["w"])[1],
            classifier_dim=np.shape(cls["l1"]["w"])[1])
    except (KeyError, TypeError, IndexError) as e:
        raise KeyError(f"not an np-d-np parameter tree: lacks {e}") from e


def _p_nd_np_config(tree):
    """The p-nd-np widths, read off the parameter shapes: the decimator's
    GRU takes the 3 stacked SP columns and the sign (edge_dim = w_ih rows
    - 3); the predictor's aggregator has no feature input, so its widths
    come from its own layers."""
    try:
        gru = tree["dec"]["var_gru"]
        agg = tree["predictor"]["var_agg"]
        cls = tree["predictor"]["classifier"]
        return SolverConfig(
            model_type="p-nd-np", hidden_dim=np.shape(gru["w_hh"])[0],
            edge_dim=np.shape(gru["w_ih"])[0] - 3,
            mem_hidden_dim=np.shape(agg["w1_m"]["w"])[1],
            mem_agg_hidden_dim=np.shape(agg["w2_m"]["w"])[1],
            agg_hidden_dim=np.shape(agg["w1_a"]["w"])[1],
            classifier_dim=np.shape(cls["l1"]["w"])[1],
            prediction_dim=np.shape(cls["l2"]["w"])[1])
    except (KeyError, TypeError, IndexError) as e:
        raise KeyError(f"not a p-nd-np parameter tree: lacks {e}") from e


def _is_p_nd_np(tree):
    """A p-nd-np tree: its propagator holds the SP adaptors only."""
    prop = tree.get("prop")
    return (isinstance(prop, dict) and "var_agg" not in prop
            and ("var_proj" in prop or "fn_proj" in prop))


def load_into(module, np_tree):
    """Copy a JAX parameter tree of numpy arrays into `module` (an
    Aggregator, GRUCell, ... or a ModuleDict of them): every leaf must land
    on one parameter of the same shape, JAX [in, out] linear and GRU
    weights transposed, and every parameter must be given. Raises KeyError
    on an unknown or missing key, ValueError on a shape that does not
    fit. Returns the module."""
    own = dict(module.named_parameters())
    seen = set()
    for name, arr in _flatten(np_tree):
        prefix, _, leaf = name.rpartition(".")
        if leaf not in _LEAVES:
            raise KeyError(f"unknown parameter {name!r}")
        tname, transpose = _LEAVES[leaf]
        tname = f"{prefix}.{tname}" if prefix else tname
        if tname not in own:
            raise KeyError(f"unknown parameter {name!r}")
        value = arr.T if transpose else arr
        if tuple(value.shape) != tuple(own[tname].shape):
            raise ValueError(f"{name}: shape {arr.shape} does not fit "
                             f"{tname} {tuple(own[tname].shape)}")
        with torch.no_grad():
            own[tname].copy_(_t(value, own[tname].device))
        seen.add(tname)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"parameters not given: {missing}")
    return module


def params_from_jax(np_params, device="cuda"):
    """The port's parameters from a JAX parameter tree of numpy arrays
    (`init_params` output, or `load_jax_checkpoint(path)["params"]`).

    {} (p-d-p) gives {}. A tree with "prop", "dec" and "predictor" gives
    the ModuleDict of PDPSolver.init_params: p-nd-np when "prop" holds the
    SP adaptors (`var_proj`, `fn_proj`) and no aggregator, else np-nd-np.
    A tree with "prop" (the neural propagator) and "scorer" gives np-d-np's.
    Its widths are read off the shapes, and it is loaded by `load_into`
    (which raises on an unknown, missing or misshapen key)."""
    tree = dict(np_params)
    if not tree:
        return {}
    if "scorer" in tree:
        kind, make = {"prop", "scorer"}, _np_d_np_config
    else:
        kind = {"prop", "dec", "predictor"}
        make = _p_nd_np_config if _is_p_nd_np(tree) else _np_nd_np_config
    unknown = sorted(set(tree) - kind)
    if unknown:
        raise KeyError(f"no ported module takes parameters {unknown}")
    return load_into(PDPSolver(make(tree)).init_params(device), tree)


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


def reinforce_decimator_state_from_jax(np_aux, device="cuda"
                                       ) -> ReinforceDecimatorState:
    """A JAX ReinforceDecimatorState (prev_eta, has_prev)."""
    prev_eta, has_prev = np_aux
    return ReinforceDecimatorState(prev_eta=_t(prev_eta, device),
                                   has_prev=_t(has_prev, device).reshape(()))


def _aux_from_jax(np_aux, device):
    if type(np_aux).__name__ == "ReinforceDecimatorState":
        return reinforce_decimator_state_from_jax(np_aux, device)
    return seq_decimator_state_from_jax(np_aux, device)


def problem_from_jax(np_problem, device="cuda") -> ProblemState:
    """A JAX ProblemState (active_vars, active_clauses, solution, is_sat)."""
    return ProblemState(*(_t(x, device) for x in np_problem))


def _is_neural_pair(x):
    return (type(x) is tuple and len(x) == 2
            and all(isinstance(a, np.ndarray) and a.ndim == 2 for a in x))


def state_from_jax(np_state, device="cuda"):
    """A JAX SolverState (prop, dec, aux), SPMessages, SeqDecimatorState,
    ReinforceDecimatorState, ProblemState or neural (var [E, h], fn [E, h])
    pair as numpy arrays -> the port's counterpart on `device`. walk-sat's
    empty state ((), (), ()) stays empty; p-nd-np's mixed state (SP
    messages, a neural pair, ()) and np-d-np's (two neural pairs and a
    SeqDecimatorState) keep their mix."""
    kind = type(np_state).__name__
    if kind == "SPMessages":
        return messages_from_jax(np_state, device)
    if kind in ("SeqDecimatorState", "ReinforceDecimatorState"):
        return _aux_from_jax(np_state, device)
    if kind == "ProblemState":
        return problem_from_jax(np_state, device)
    if _is_neural_pair(np_state):
        return tuple(_t(x, device) for x in np_state)
    if kind == "SolverState" or len(np_state) == 3:
        prop, dec, aux = np_state
        if prop == () and dec == () and aux == ():
            return SolverState(prop=(), dec=(), aux=())
        if _is_neural_pair(dec):
            return SolverState(prop=state_from_jax(prop, device),
                               dec=state_from_jax(dec, device),
                               aux=_aux_from_jax(aux, device) if aux
                               else ())
        return SolverState(prop=messages_from_jax(prop, device),
                           dec=messages_from_jax(dec, device),
                           aux=_aux_from_jax(aux, device))
    raise TypeError(f"cannot convert {kind}")
