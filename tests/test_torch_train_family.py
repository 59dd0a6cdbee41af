"""Training p-nd-np and np-d-np: the port against the JAX package on the CPU.

The same numpy-seeded instances go through both packages; parameters are
made by the JAX trainer and handed over with convert.load_into. With
PDP_SEGMENT_BACKEND=windowed the JAX batch takes kernels 4, 6 and 7 in
Pallas interpret mode with their custom VJPs; under its training_mode
p-nd-np's SP sweep takes the XLA fallback (segment sums, gathers), which
the port's training route (`propagate.sp_sweep_train`) follows. Both sides
draw nothing: randomized=False (zero or uniform init states) and dropout
0. JAX's value_and_grad of its loss is compiled once per assembly (one
mixed-width padded shape, T = 2, remat off for a shorter compile).

np-d-np's decimation is forced (tolerance 10: every instance counts as
converged), so its decimated problem moves in every outer step after the
first; the port decimates on detached messages under no_grad, JAX cuts
its tape at the problem, and the problems must agree bit for bit.

Tolerances: the BPTT loss to rtol 1e-5; each parameter's gradient to
||g_port - g_jax|| <= 1e-5 ||g_jax|| + 1e-12; parameters after three
optax-order steps to atol 1e-6; the decimated problems, the decimator's
counters and flags exactly; the r4 step at hidden 150 to atol 1e-6.

The clamp-tie rule (`ops/segment.py clamp_min`): a pure literal's q_u
sits at its tie (opp = 0, so s == d), but there opp carries no
derivative, so the tie moves no gradient of the BPTT loss. The rule shows
where opp is 0 in value with a derivative: surveys eta_in = 0 on a
variable's opposite-polarity edges (log(1 - 0) = 0, d/d eta = -1).
`test_sweep_vjp_matches_jax_at_zero_surveys` holds the route's VJP
against jax.vjp there and shows that torch.clamp in q_triplet_stable
fails it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.fg.generators import UniformCNFGenerator as JaxUniform
from pdp_solver_tpu.modules import propagate as JPR
from pdp_solver_tpu.ops.pallas_fused import training_mode
from pdp_solver_tpu.problem.state import init_problem_state as jax_init
from pdp_solver_tpu.train.trainer import SatTrainer as JaxTrainer

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import propagate as PR
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import safe_exp
from pdp_solver_tpu_torch.solvers.base import SolverState, build_solver
from pdp_solver_tpu_torch.train.trainer import SatTrainer, state_tensors
from pdp_solver_tpu_torch.utils import training

MODELS = ("p-nd-np", "np-d-np")
BASE = dict(model_name="tf", hidden_dim=12, mem_hidden_dim=10,
            agg_hidden_dim=10, mem_agg_hidden_dim=8, classifier_dim=8,
            prediction_dim=1, dropout=0.0, train_outer_recurrence_num=2,
            train_inner_recurrence_num=1, learning_rate=1e-3,
            weight_decay=1e-4, clip_norm=0.65, exploration=0.1,
            loss_sharpness=5, randomized=False, batch_size=4,
            tolerance=10.0, t_max=10, **{"lambda": 0.8})
STEP = 4.0   # global_step of the comparisons
PAD = (64, 256, 1024, 8)


def _cfg(model, **kw):
    return dict(BASE, model_type=model, **kw)


def _instances(seed, count=5, k=(2, 5)):
    g = JaxUniform(6, 12, k[0], k[1], 2.0, 4.0, seed=seed)
    return [g.generate() for _ in range(count)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(_np(tree))


def _pure_literals(insts):
    """How many variables appear with one sign only."""
    n = 0
    for inst in insts:
        for v in range(inst[0]):
            signs = set(np.asarray(inst[3])[inst[2][0] == v].tolist())
            n += len(signs) == 1
    return n


@pytest.fixture(scope="module", params=MODELS)
def side(request):
    """One assembly's JAX trainer, three mixed-width batches of one padded
    shape, its value_and_grad and optax update, compiled once."""
    model = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("PDP_SEGMENT_BACKEND", "windowed")
    mp.setenv("PDP_COMPILE_CACHE", "off")
    jt = JaxTrainer(_cfg(model, train_remat=False), seed=0)
    jt._make_optimizer()
    insts = [_instances(s) for s in (5, 6, 7)]
    jbs = [jax_pack(i, pad_v=PAD[0], pad_f=PAD[1], pad_e=PAD[2],
                    pad_b=PAD[3]) for i in insts]
    assert all(b.fast_var and b.fast_clause and b.clause_width == 0
               for b in jbs)
    vag = jax.jit(jax.value_and_grad(jt._loss_fn()))

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = jt._optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    yield dict(model=model, trainer=jt, insts=insts, jbs=jbs, vag=vag,
               update=update)
    mp.undo()


def _port_trainer(model, params, **kw):
    tr = SatTrainer(_cfg(model, **kw), device="cpu")
    convert.load_into(tr.params, _np(params))
    return tr


def _port_batch(insts):
    return pack_instances(insts, device="cpu", pad_v=PAD[0], pad_f=PAD[1],
                          pad_e=PAD[2], pad_b=PAD[3])


def _grads_match(ref_grads, module, rel=1e-5):
    flat = jax.tree_util.tree_flatten_with_path(_np(ref_grads))[0]
    mine = jax.tree_util.tree_leaves(convert.grads_to_jax(module))
    assert len(flat) == len(mine)
    worst = 0.0
    for (path, a), b in zip(flat, mine):
        err = np.linalg.norm(b - a)
        assert err <= rel * np.linalg.norm(a) + 1e-12, (
            jax.tree_util.keystr(path), err, np.linalg.norm(a))
        worst = max(worst, err / max(np.linalg.norm(a), 1e-30))
    return worst


# ---------------------------------------------------------------- the loss

def test_loss_and_gradients_match_jax(side):
    """The BPTT loss and every parameter's gradient, on a batch that
    holds pure literals."""
    jb = side["jbs"][0]
    assert _pure_literals(side["insts"][0]) > 0
    ref, ref_g = side["vag"](side["trainer"].params, jax.random.PRNGKey(0),
                             jb, jnp.float32(STEP))
    tr = _port_trainer(side["model"], side["trainer"].params)
    got = tr.loss(tr.params, _port_batch(side["insts"][0]),
                  torch.tensor(STEP))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    _grads_match(ref_g, tr.params)


def test_three_optax_steps_match_jax(side):
    jt = side["trainer"]
    params, opt_state = jt.params, jt._optimizer.init(jt.params)
    tr = _port_trainer(side["model"], params)
    ts = tr.init_train_state()
    for i in range(3):
        loss_v, grads = side["vag"](params, jax.random.PRNGKey(0),
                                    side["jbs"][i], jnp.float32(STEP))
        params, opt_state = side["update"](grads, opt_state, params)
        ts = ts._replace(global_step=torch.tensor(STEP))
        ts, got = tr.train_step(ts, _port_batch(side["insts"][i]))
        np.testing.assert_allclose(float(got), float(loss_v), rtol=1e-5)
    for a, b in zip(_leaves(params), jax.tree_util.tree_leaves(
            convert.params_to_jax(ts.params))):
        np.testing.assert_allclose(b, a, atol=1e-6)


def test_np_d_np_decimated_problems_match_jax(monkeypatch):
    """np-d-np's training forward, outer step by outer step (3 steps of 2
    iterations, the aux carried, the problem fresh in each): the
    decimated problem and the decimator's bookkeeping bit for bit, the
    states to 1e-5."""
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")
    jt = JaxTrainer(_cfg("np-d-np"), seed=2)
    js = jt.solver
    insts = _instances(9)
    jb = jax_pack(insts, pad_v=PAD[0], pad_f=PAD[1], pad_e=PAD[2],
                  pad_b=PAD[3])
    tr = _port_trainer("np-d-np", jt.params)
    tb = _port_batch(insts)
    rng = np.random.default_rng(4)
    h = BASE["hidden_dim"]
    init = [rng.uniform(-1, 1, (PAD[2], h)).astype(np.float32)
            for _ in range(4)]
    jstate = js.get_init_state(jax.random.PRNGKey(0), jb, False)
    jstate = jstate._replace(prop=(jnp.asarray(init[0]),
                                   jnp.asarray(init[1])),
                             dec=(jnp.asarray(init[2]),
                                  jnp.asarray(init[3])))
    state = SolverState(prop=(torch.tensor(init[0]), torch.tensor(init[1])),
                        dec=(torch.tensor(init[2]), torch.tensor(init[3])),
                        aux=tr.solver.get_init_state(None, tb, False).aux)

    @jax.jit
    def jstep(params, state):
        with training_mode():
            problem, state, _, _ = js._forward_core(
                params, jax.random.PRNGKey(0), jb, jax_init(jb), state, 2,
                True, False, 1)
        return problem, state

    moved = 0
    for t in range(3):
        jproblem, jstate = jstep(jt.params, jstate)
        problem, state, _ = tr.solver._train_core(tr.params, None, tb,
                                                  state, 2)
        for f in ("active_vars", "active_clauses", "solution", "is_sat"):
            np.testing.assert_array_equal(getattr(problem, f).numpy(),
                                          np.asarray(getattr(jproblem, f)),
                                          err_msg=f"step {t}: {f}")
        for f in ("counters", "has_prev"):
            np.testing.assert_array_equal(
                getattr(state.aux, f).numpy().reshape(-1),
                np.asarray(getattr(jstate.aux, f)).reshape(-1))
        np.testing.assert_allclose(state.aux.prev_eta.detach().numpy(),
                                   np.asarray(jstate.aux.prev_eta),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(state.prop, jstate.prop):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
        moved += int((problem.active_vars.sum()
                      < tb.var_mask.sum()).item())
    assert moved >= 2     # decimation ran in every step after the first


def test_state_tensors_round_trip():
    """The trainer's flat view of each assembly's state rebuilds it."""
    tb = _port_batch(_instances(3))
    for model in ("np-nd-np",) + MODELS:
        st = training.numpy_init_state(tb, 12, 1, "cpu", model)
        flat, rebuild = state_tensors(st)
        back = rebuild(flat)
        assert type(back.prop) is type(st.prop)
        assert type(back.aux) is type(st.aux)
        again, _ = state_tensors(back)
        assert all(a is b for a, b in zip(flat, again))


# ---------------------------------------------------------------- the sweep

def _sweep_inputs(jb, seed, zero_surveys):
    """SP inputs on every edge; with zero_surveys the surveys eta_in of
    the negative edges of every other variable are exactly 0."""
    rng = np.random.default_rng(seed)
    E = jb.num_edges
    u = rng.uniform(0.05, 0.95, E).astype(np.float32)
    eta = rng.uniform(0.02, 0.98, E).astype(np.float32)
    if zero_surveys:
        ev, sign = np.asarray(jb.edge_var), np.asarray(jb.edge_sign)
        eta[(ev % 2 == 0) & (sign < 0)] = 0.0
    v = rng.uniform(0.1, 1.0, (3, E)).astype(np.float32)
    v /= v.sum(0)
    state = rng.uniform(0.0, 1.0, E).astype(np.float32)
    w = rng.normal(size=(4, E)).astype(np.float32)
    return u, eta, v, state, w


def _clamp_q_triplet(same, opp):
    """q_triplet_stable with torch.clamp: the whole gradient to x at a
    tie."""
    b = torch.maximum(same, opp)
    s, o = safe_exp(same - b), safe_exp(opp - b)
    d = safe_exp(same + opp - b)
    q_u = torch.clamp(s - d, min=0.0)
    q_s = torch.clamp(o - d, min=0.0)
    return q_u, q_s, d, torch.clamp(q_u + q_s + d, min=1e-20)


def _port_sweep_vjp(tb, ins):
    u, eta, v, state, w = ins
    tu, teta = torch.tensor(u, requires_grad=True), torch.tensor(
        eta, requires_grad=True)
    tv = [torch.tensor(x, requires_grad=True) for x in v]
    msgs = PR.SPMessages(var=tuple(tv), fn=(torch.tensor(state),
                                            torch.zeros(len(u))))
    dec = PR.SPMessages(var=(tu, tu, tu), fn=(teta, torch.zeros(len(u))))
    out = PR.survey_propagator_apply(PR.SurveyPropagatorConfig(), tb, msgs,
                                     dec, tb.edge_mask, tb.edge_mask)
    cols = (out.fn[0],) + out.var
    sum(torch.sum(c * torch.tensor(x)) for c, x in zip(cols, w)).backward()
    return [x.grad.numpy() for x in [tu, teta] + tv]


@pytest.mark.parametrize("widths", ["uniform", "mixed"])
def test_sweep_vjp_matches_jax_at_zero_surveys(monkeypatch, widths):
    """The training route's VJP against jax.vjp of JAX's XLA fallback
    (training_mode), where exact zero surveys put q_u on its tie with a
    derivative behind opp; with torch.clamp in q_triplet_stable the
    gradients of eta_in fall outside the tolerance."""
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    insts = _instances(13, count=4, k=(3, 3) if widths == "uniform"
                       else (2, 5))
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    ins = _sweep_inputs(jb, 3, zero_surveys=True)
    u, eta, v, state, w = ins
    E = len(u)

    def jsweep(u, eta, v0, v1, v2):
        msgs = JPR.SPMessages(var=(v0, v1, v2),
                              fn=(jnp.asarray(state), jnp.zeros(E)))
        dec = JPR.SPMessages(var=(u, u, u), fn=(eta, jnp.zeros(E)))
        with training_mode():
            out = JPR.survey_propagator_apply(
                {}, JPR.SurveyPropagatorConfig(), jb, msgs, dec,
                jb.edge_mask, jb.edge_mask)
        cols = (out.fn[0],) + out.var
        return sum(jnp.sum(c * x) for c, x in zip(cols, w))

    ref = [np.asarray(g) for g in jax.grad(jsweep, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(u), jnp.asarray(eta), *map(jnp.asarray, v))]

    def close(got):
        return all(np.allclose(a, b, rtol=1e-5, atol=1e-5)
                   for a, b in zip(got, ref))
    got = _port_sweep_vjp(tb, ins)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(PR, "q_triplet_stable", _clamp_q_triplet)
    assert not close(_port_sweep_vjp(tb, ins))


@pytest.mark.parametrize("login", [False, True])
@pytest.mark.parametrize("widths", ["uniform", "mixed"])
def test_training_sweep_equals_serving_plain_route(widths, login):
    """From one state, the training route's values and the serving
    route's plain versions (chained_edge_pass_plain + fused_edge_pass_plain
    on the CPU): equal on a mixed-width batch (the same index_add_ sums),
    within 1e-6 on a uniform one (its clause sums a reshape)."""
    insts = _instances(17, count=4, k=(3, 3) if widths == "uniform"
                       else (2, 5))
    tb = pack_instances(insts, device="cpu")
    u, eta, v, state, _ = _sweep_inputs(tb, 5, zero_surveys=False)
    u_like = np.log(u) if login else u
    force = np.sign(np.random.default_rng(2).normal(size=len(u))).astype(
        np.float32)
    ins = [torch.tensor(x) for x in (u_like, eta, *v, state, force)]
    em = ae = tb.edge_mask
    _, pn, (serve_eta,), _ = fused.chained_edge_pass_plain(
        fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN, tb,
        (ins[0], ins[1], em, ae, ins[5], tb.edge_sign))
    _, serve_v = fused.fused_edge_pass_plain(
        fused.SP_PASS_C, tb, (pn[0], pn[1], ins[1], em, ae, tb.edge_sign,
                              ins[6], *ins[2:5]))
    got = PR.sp_sweep_train(tb, ins[0], ins[1], em, ae, ins[5], ins[6],
                            tuple(ins[2:5]), 0.0, login)
    for a, b in zip(got, (serve_eta,) + tuple(serve_v)):
        if widths == "mixed":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_training_route_is_taken_under_autograd_only():
    """Under no_grad (serving) the sweep keeps its chained pass; with an
    input that requires grad it takes sp_sweep_train."""
    tb = _port_batch(_instances(3))
    tr = SatTrainer(_cfg("p-nd-np"), device="cpu")
    st = tr.solver.get_init_state(tr._gen, tb, True)
    calls = []
    real = PR.sp_sweep_train

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    PR.sp_sweep_train = spy
    try:
        with torch.no_grad():
            tr.solver._propagate(tr.params, tb, st.prop, st.dec,
                                 tb.edge_mask, tb.edge_mask)
        assert not calls
        out = tr.solver._propagate(tr.params, tb, st.prop, st.dec,
                                   tb.edge_mask, tb.edge_mask)
        assert calls and out.var[0].requires_grad
    finally:
        PR.sp_sweep_train = real


# ---------------------------------------------------------------- r4

@pytest.mark.parametrize("model", MODELS)
def test_r4_train_state_resumes_and_steps_like_jax(monkeypatch, model):
    """The r4 train state (parameters and Adam's moments) read by each
    package, then one step on a small batch at hidden 150 (T = 1)."""
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")
    cfg = dict(training.FAMILY_RECIPES[model], dropout=0.0,
               randomized=False, train_outer_recurrence_num=1,
               train_remat=False, tolerance=10.0)
    path = os.path.join(training.ROOT, "trained-models", cfg["model_name"],
                        "best" if model == "p-nd-np" else "last")
    jt = JaxTrainer(cfg, seed=0)
    jt._make_optimizer()
    jts = jt._load_train_state(jt.init_train_state(), path)
    tr = SatTrainer(cfg, device="cpu")
    ts = tr._load_train_state(tr.init_train_state(), path)
    adam = convert.adam_to_jax(ts.opt, ts.params)
    assert int(adam["count"]) == int(jts.opt_state[2].count) > 0
    for a, b in zip(_leaves(jts.opt_state[2].nu),
                    jax.tree_util.tree_leaves(adam["nu"])):
        np.testing.assert_array_equal(a, b)
    insts = _instances(21, count=3)
    jb = jax_pack(insts, pad_v=PAD[0], pad_f=PAD[1], pad_e=PAD[2],
                  pad_b=PAD[3])
    jts = jts._replace(global_step=jnp.float32(STEP))
    jts, jloss = jt._train_step_fn()(jts, jax.random.PRNGKey(0), jb)
    ts = ts._replace(global_step=torch.tensor(STEP))
    ts, loss_v = tr.train_step(ts, _port_batch(insts))
    np.testing.assert_allclose(float(loss_v), float(jloss), rtol=1e-5)
    for a, b in zip(_leaves(jts.params), jax.tree_util.tree_leaves(
            convert.params_to_jax(ts.params))):
        np.testing.assert_allclose(b, a, atol=1e-6)


# ---------------------------------------------------------------- recipes

def test_family_recipes_are_the_jax_runs():
    """FAMILY_RECIPES is tools/train_family.py's BASE + FAMILY, with its
    train_scan; family_stream its mixture (the first component from n
    10)."""
    path = os.path.join(training.ROOT, "tools", "train_family.py")
    with open(path) as f:
        src = f.read()
    ns = {}
    for name in ("BASE = dict(", "FAMILY = {"):
        start = src.index(name)
        exec(compile(src[start:src.index("\n\n", start)], path, "exec"), ns)
    for model in MODELS:
        want = dict(ns["BASE"], model_type=model, model_name=f"{model}-r4",
                    **ns["FAMILY"][model])
        want["train_scan"] = model == "np-d-np"
        assert training.FAMILY_RECIPES[model] == want
    assert ('"TRAIN_SCAN", "1" if model_type == "np-d-np" else "0"'
            in src)
    assert ("[UniformCNFGenerator(10, 100, 2, 10, 2.0, 10.0),\n"
            "         UniformCNFGenerator(4, 100, 3, 3, 2.0, 4.2),\n"
            "         UniformCNFGenerator(5, 100, 4, 4, 7.0, 9.9)],\n"
            "        weights=[0.5, 0.25, 0.25]") in src
    from pdp_solver_tpu.fg.generators import MixtureCNFGenerator
    ref = MixtureCNFGenerator(
        [JaxUniform(10, 100, 2, 10, 2.0, 10.0),
         JaxUniform(4, 100, 3, 3, 2.0, 4.2),
         JaxUniform(5, 100, 4, 4, 7.0, 9.9)],
        weights=[0.5, 0.25, 0.25], seed=23)
    ref.reseed(23)
    gen = training.family_stream(23)
    assert [c._min_n for c in gen._components] == [10, 4, 5]
    for _ in range(20):
        a, b = gen.generate(), ref.generate()
        assert a[:2] == b[:2] and a[4] == b[4]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("model", ["p-d-p", "walk-sat", "reinforce"])
def test_classical_assemblies_do_not_train(model):
    """check_trainable takes the three neural assemblies and refuses the
    classical ones, which have no parameters."""
    for neural in ("np-nd-np",) + MODELS:
        build_solver(_cfg(neural)).check_trainable()
    with pytest.raises(NotImplementedError, match="no parameters"):
        build_solver(_cfg(model)).check_trainable()
