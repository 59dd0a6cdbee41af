"""Simplification: the port against the JAX package, bit-equal.

The JAX side runs its fused round through the chained Pallas kernel in
interpret mode (PDP_FUSED_PASS=on). Every output is a 0/1 flag or a
0 / 0.5 / 1 solution value, so equality is exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.problem.state import init_problem_state as jax_init

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.problem import simplify
from pdp_solver_tpu_torch.problem.state import init_problem_state

# the JAX problem package re-exports a function named `simplify`
jsimp = importlib.import_module("pdp_solver_tpu.problem.simplify")


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")


def _instances(seed):
    """SAT and UNSAT instances with units and pure literals to propagate."""
    rng = np.random.default_rng(seed)
    insts = []
    for _ in range(4):
        cl = random_ksat(rng, 16, 30, k=3)
        cl += [[int(rng.integers(1, 17)) * int(rng.choice([-1, 1]))]]
        insts.append(cnf_instance(16, cl))
    insts.append(cnf_instance(4, [[1], [-1, 2], [-2, -1], [3, 4]]))  # UNSAT
    insts.append(cnf_instance(5, [[1, 2], [1, -3], [-2, 4, 5], [2]]))
    return insts


def _assert_same_state(jstate, tstate):
    for f in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)


def _both(seed):
    insts = _instances(seed)
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    assert jb.fast_var and jb.fast_clause
    return jb, tb


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_rounds", [0, 1, 2])
def test_fused_simplify_matches_jax(fused_env, seed, max_rounds):
    jb, tb = _both(seed)
    ref = jsimp.fused_simplify(jb, jax_init(jb), max_rounds=max_rounds)
    got = simplify.fused_simplify(tb, init_problem_state(tb),
                                  max_rounds=max_rounds)
    _assert_same_state(ref, got)
    if max_rounds == 0:
        assert float(np.asarray(ref.is_sat)[4]) == 0.0    # the UNSAT one


@pytest.mark.parametrize("max_rounds", [0, 1])
def test_fused_set_variables_matches_jax(fused_env, max_rounds):
    jb, tb = _both(2)
    rng = np.random.default_rng(3)
    j0 = jsimp.fused_simplify(jb, jax_init(jb))
    t0 = simplify.fused_simplify(tb, init_problem_state(tb))
    assign = (rng.choice([-1.0, 0.0, 1.0], jb.num_vars,
                         p=[0.2, 0.6, 0.2])).astype(np.float32)
    ref = jsimp.fused_set_variables(jb, j0, jnp.asarray(assign),
                                    max_rounds=max_rounds)
    got = simplify.fused_set_variables(tb, t0, torch.from_numpy(assign),
                                       max_rounds=max_rounds)
    _assert_same_state(ref, got)


def test_reference_passes_match_jax():
    jb, tb = _both(4)
    jp, tp = jax_init(jb), init_problem_state(tb)
    _assert_same_state(jsimp.unit_propagate(jb, jp),
                       simplify.unit_propagate(tb, tp))
    _assert_same_state(jsimp.peel(jb, jp), simplify.peel(tb, tp))
    _assert_same_state(jsimp.simplify(jb, jp), simplify.simplify(tb, tp))
    assign = np.zeros(jb.num_vars, np.float32)
    assign[[0, 5, 17]] = [1.0, -1.0, 1.0]
    _assert_same_state(
        jsimp.set_variables(jb, jp, jnp.asarray(assign)),
        simplify.set_variables(tb, tp, torch.from_numpy(assign)))
