"""The neural building blocks as nn.Modules.

Counterpart of `pdp_solver_tpu/modules/mlp.py` (:33-173). A JAX linear
layer `x @ w + b` with `w` stored [in, out] is an `nn.Linear` whose weight
is `w.T`; the GRU cell keeps torch's nn.GRUCell layout (weight_ih [3h, in],
weight_hh [3h, h], gate order r, z, n), which is the JAX package's layout
transposed. `convert.params_from_jax` loads JAX parameters into these.

Mixed precision (the JAX package's compute_dtype="bfloat16",
`pdp_solver_tpu/modules/mlp.py` aggregator_apply :128-173 and the GRU of
`modules/decimate.py` :78-85) is written out as explicit casts, as in the
JAX package, not torch.autocast (which picks per op what runs in f32).
The parameters stay f32 masters and carry no precision: a module takes
its compute_dtype at call time (the solver passes its own; a module called
alone uses its config's), and a layer rounds its weights to bf16 on every
call, held in f32 where its input is f32, as JAX's cast_tree and its type
promotion of an f32 input and bf16 weights do.
"""

import dataclasses

import torch
from torch import nn
from torch.nn import functional as Fn

from pdp_solver_tpu_torch.modules import common


# the compute_dtype values the JAX package's SolverConfig takes, and the
# cast each asks for (None: none)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def cast_for(cfg, compute_dtype=None):
    """The cast a module runs with: compute_dtype's (the caller's), else
    its config's."""
    return COMPUTE_DTYPES[compute_dtype or cfg.compute_dtype]


def linear(layer, x, dtype=None):
    """layer(x), with dtype: x @ round_dtype(w) + round_dtype(b) in x's
    type (JAX's linear_apply after cast_tree)."""
    if dtype is None:
        return layer(x)

    def cast(p):
        return None if p is None else p.to(dtype).to(x.dtype)
    return Fn.linear(x, cast(layer.weight), cast(layer.bias))


class Perceptron(nn.Module):
    """sigmoid(l2(relu(l1 x))), l2 without bias (reference
    trainer.py:20-29)."""

    def __init__(self, in_dim, hidden_dim, out_dim):
        super().__init__()
        self.l1 = nn.Linear(in_dim, hidden_dim)
        self.l2 = nn.Linear(hidden_dim, out_dim, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.l2(torch.relu(self.l1(x))))


class PerceptronTanh(Perceptron):
    """tanh(l2(relu(l1 x))) (reference util.py:242-251)."""

    def forward(self, x):
        return torch.tanh(self.l2(torch.relu(self.l1(x))))


class MLP(nn.Module):
    """relu inner layers, then a bias-free sigmoid output layer."""

    def __init__(self, layer_dims):
        super().__init__()
        self.inner = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(layer_dims[:-2],
                                            layer_dims[1:-1]))
        self.out = nn.Linear(layer_dims[-2], layer_dims[-1], bias=False)

    def forward(self, x):
        for layer in self.inner:
            x = torch.relu(layer(x))
        return torch.sigmoid(self.out(x))


class GRUCell(nn.Module):
    """torch.nn.GRUCell's function, written out (gate order r, z, n):
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))."""

    def __init__(self, in_dim, hidden_dim):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_dim, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_dim,
                                                  hidden_dim))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_dim))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden_dim))
        k = hidden_dim ** -0.5
        for p in self.parameters():
            nn.init.uniform_(p, -k, k)

    def forward(self, x, h, dtype=None):
        """The new state, in h's type. With dtype (bf16), the weights, x
        and h are cast to it, the cell runs in it (the products' sums
        kept in f32 by the matrix product, each op's result rounded), and
        the result is cast back (JAX decimate.py:78-85)."""
        w = (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)
        out_dtype = h.dtype
        if dtype is not None:
            w = [p.to(dtype) for p in w]
            x, h = x.to(dtype), h.to(dtype)
        w_ih, w_hh, b_ih, b_hh = w
        gi = torch.addmm(b_ih, x, w_ih.t())
        gh = torch.addmm(b_hh, h, w_hh.t())
        i_r, i_z, i_n = gi.chunk(3, dim=1)
        h_r, h_z, h_n = gh.chunk(3, dim=1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return ((1.0 - z) * n + z * h).to(out_dtype)


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Mirrors reference MessageAggregator.__init__ (util.py:14-49)."""
    input_dim: int
    output_dim: int
    mem_hidden_dim: int
    mem_agg_hidden_dim: int
    agg_hidden_dim: int
    feature_dim: int
    include_self: bool


class Aggregator(nn.Module):
    """Deep-set aggregation (reference util.py:51-77; JAX mlp.py:139).

    forward(batch, state_e [E, in], feature_e [E, f] or None, orient,
    edge_mask_e [E] or None): per edge, log_sigmoid(w2_m(log_sigmoid(
    w1_m x))); rows masked by edge_mask_e; summed per variable (orient
    "var") or per clause ("clause"). include_self=False subtracts each
    edge's own row and returns edge rows, include_self=True returns node
    rows. Then the features are appended and log_sigmoid(w2_a(
    log_sigmoid(w1_a .))) applied."""

    def __init__(self, cfg: AggregatorConfig):
        super().__init__()
        self.cfg = cfg
        mem_agg = cfg.mem_agg_hidden_dim
        self.has_mem = cfg.mem_hidden_dim > 0 and mem_agg > 0
        self.has_agg = cfg.agg_hidden_dim > 0 and mem_agg > 0
        if self.has_mem:
            self.w1_m = nn.Linear(cfg.input_dim, cfg.mem_hidden_dim)
            self.w2_m = nn.Linear(cfg.mem_hidden_dim, mem_agg, bias=False)
        if self.has_agg:
            if cfg.mem_hidden_dim <= 0:
                mem_agg = cfg.input_dim
            self.w1_a = nn.Linear(mem_agg + cfg.feature_dim,
                                  cfg.agg_hidden_dim)
            self.w2_a = nn.Linear(cfg.agg_hidden_dim, cfg.output_dim,
                                  bias=False)

    def forward(self, batch, state_e, feature_e, orient, edge_mask_e=None,
                dtype=None):
        """dtype=torch.bfloat16 follows JAX's aggregator_apply(dtype=):
        state_e, feature_e, the edge mask and the weights are cast to
        bf16, so the first MLP and the masking run in bf16; the sums are
        f32 (`common.scatter_to_vars`: JAX's f32 edge mask promotes them),
        so the subtract of the own row, the features' concatenation and
        the second MLP (bf16 weights held in f32) are f32, as in JAX; the
        result has state_e's type."""
        if orient not in ("var", "clause"):
            raise ValueError(f"orient must be 'var' or 'clause', not "
                             f"{orient!r}")
        out_dtype = state_e.dtype
        if dtype is not None:
            state_e = state_e.to(dtype)
            if feature_e is not None:
                feature_e = feature_e.to(dtype)
            if edge_mask_e is not None:
                edge_mask_e = edge_mask_e.to(dtype)
        if self.has_mem:
            state_e = Fn.logsigmoid(linear(self.w2_m, Fn.logsigmoid(
                linear(self.w1_m, state_e, dtype)), dtype))
        if edge_mask_e is not None:
            state_e = state_e * common.col(edge_mask_e)

        if orient == "var" and not self.cfg.include_self:
            agg = common.aggregate_minus_self_var(batch, state_e)
        elif orient == "var":
            agg = common.scatter_to_vars(batch, state_e)
        else:
            agg = common.scatter_to_clauses(batch, state_e)
            if not self.cfg.include_self:
                agg = common.gather_from_clauses(batch, agg) - state_e

        if feature_e is not None:
            agg = torch.cat([agg, feature_e.to(agg.dtype)], dim=1)
        if self.has_agg:
            agg = Fn.logsigmoid(linear(self.w2_a, Fn.logsigmoid(
                linear(self.w1_a, agg, dtype)), dtype))
        return agg.to(out_dtype)
