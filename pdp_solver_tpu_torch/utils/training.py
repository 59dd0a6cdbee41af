"""The training recipes the port runs: np-nd-np at the flagship recipe and
at `config/Train/np-nd-np-4sat.yaml`; p-nd-np and np-d-np at the recipes
that made their r4 checkpoints; p-nd-np at
`config/Train/p-nd-np-cnf-3-10.yaml`.

`FLAGSHIP_RECIPE` is the configuration of the JAX package's flagship run,
the one that produced the shipped r3 weights (`tools/train_flagship.py`
CFG :58-66): hidden 150, mem_hidden 100, agg_hidden 100, mem_agg_hidden
50, classifier 50, dropout 0.2, T = 10 outer x 1 inner BPTT steps,
lambda 1, lr 1e-4, weight decay 1e-10, clip 0.65, exploration 0.1,
kappa 5, train_remat on. Its segments are packed to `FIXED_DIMS` (V, F,
E, B) = (8192, 32768, 131072, 128) (:75-77), and its stream is
`flagship_stream`, the mixture of :137-141: uniform k-SAT with n 4-100,
k 2-10, alpha 2-10 (weight 0.5), 3-SAT with n 4-100, alpha 2-4.2 (0.25)
and 4-SAT with n 5-100, alpha 7-9.9 (0.25).

`FAMILY_RECIPES["p-nd-np"]` and `["np-d-np"]` are `tools/train_family.py`
BASE + FAMILY (:43-60), with train_scan as that script sets it
(:121-122: on for np-d-np); their stream is `family_stream`, the mixture
of :142-147, whose first component has n from 10 (the flagship's from
4), packed to the same `FIXED_DIMS`.

`NP_ND_NP_4SAT` and `P_ND_NP_CNF_3_10` are `config/Train/np-nd-np-4sat.yaml`
and `config/Train/p-nd-np-cnf-3-10.yaml`, key for key, so that the card's
machine needs no PyYAML (tests/test_torch_train.py and
tests/test_torch_meta.py hold them against the files read by
`utils/config.py`).
"""

import os

import numpy as np
import torch

from pdp_solver_tpu_torch.fg.generators import (
    MixtureCNFGenerator, UniformCNFGenerator)
from pdp_solver_tpu_torch.fg.loader import BatchLoader
from pdp_solver_tpu_torch.modules.decimate import SeqDecimatorState
from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.solvers.base import SolverState

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the settings every JAX training run shares (tools/train_flagship.py CFG,
# tools/train_family.py BASE)
_BASE = dict(
    prediction_dim=1, dropout=0.2, train_outer_recurrence_num=10,
    train_inner_recurrence_num=1, learning_rate=1e-4, weight_decay=1e-10,
    clip_norm=0.65, exploration=0.1, loss_sharpness=5, randomized=True,
    batch_size=512, train_batch_limit=4 * 10 ** 9, train_remat=True,
    test_batch_limit=4 * 10 ** 7, test_recurrence_num=1000,
    local_search_iteration=0, epsilon=0.5, **{"lambda": 1.0})

FLAGSHIP_RECIPE = dict(
    _BASE, model_type="np-nd-np", model_name="np-nd-np-r3",
    hidden_dim=150, mem_hidden_dim=100, agg_hidden_dim=100,
    mem_agg_hidden_dim=50, classifier_dim=50)

FIXED_DIMS = (8192, 32768, 131072, 128)


def flagship_stream(seed):
    """The flagship run's training stream, seeded as the JAX run seeds it
    (the mixture's choice and, through reseed, each component)."""
    gen = MixtureCNFGenerator(
        [UniformCNFGenerator(4, 100, 2, 10, 2.0, 10.0),
         UniformCNFGenerator(4, 100, 3, 3, 2.0, 4.2),
         UniformCNFGenerator(5, 100, 4, 4, 7.0, 9.9)],
        weights=[0.5, 0.25, 0.25], seed=seed)
    gen.reseed(seed)
    return gen


def _segments(stream, recipe, dims, device, epoch_size):
    c = recipe
    return BatchLoader(
        generator=stream, epoch_size=epoch_size,
        batch_size=c["batch_size"], limit=c["train_batch_limit"],
        hidden_dim=c["hidden_dim"], fixed_shape=True, fixed_dims=dims,
        device=device).iter_segments()


def flagship_segments(seed, dims=FIXED_DIMS, device="cuda",
                      epoch_size=10 ** 9):
    """(batch, misc, macro_done) segments of the flagship stream packed to
    `dims` (the flagship run's loader, :142-147)."""
    return _segments(flagship_stream(seed), FLAGSHIP_RECIPE, dims, device,
                     epoch_size)


FAMILY_RECIPES = {
    "p-nd-np": dict(_BASE, model_type="p-nd-np",
                    model_name="p-nd-np-r4", hidden_dim=150,
                    mem_hidden_dim=50, agg_hidden_dim=50,
                    mem_agg_hidden_dim=50, classifier_dim=50,
                    has_meta_data=True, train_scan=False),
    "np-d-np": dict(_BASE, model_type="np-d-np",
                    model_name="np-d-np-r4", hidden_dim=150,
                    mem_hidden_dim=100, agg_hidden_dim=100,
                    mem_agg_hidden_dim=50, classifier_dim=50,
                    tolerance=0.02, t_max=10, train_scan=True),
}


def family_stream(seed):
    """The r4 runs' training stream (`tools/train_family.py` :142-147):
    uniform k-SAT with n 10-100, k 2-10, alpha 2-10 (weight 0.5), 3-SAT
    with n 4-100, alpha 2-4.2 (0.25), 4-SAT with n 5-100, alpha 7-9.9
    (0.25), seeded as that script seeds it (`seed` is its start_step +
    23)."""
    gen = MixtureCNFGenerator(
        [UniformCNFGenerator(10, 100, 2, 10, 2.0, 10.0),
         UniformCNFGenerator(4, 100, 3, 3, 2.0, 4.2),
         UniformCNFGenerator(5, 100, 4, 4, 7.0, 9.9)],
        weights=[0.5, 0.25, 0.25], seed=seed)
    gen.reseed(seed)
    return gen


def family_segments(seed, model_type, dims=FIXED_DIMS, device="cuda",
                    epoch_size=10 ** 9):
    """(batch, misc, macro_done) segments of `family_stream(seed)` packed
    to `dims` by the r4 runs' loader (the same for both recipes)."""
    return _segments(family_stream(seed), FAMILY_RECIPES[model_type], dims,
                     device, epoch_size)


def numpy_init_state(batch, hidden_dim, seed, device, model_type="np-nd-np"):
    """An init state drawn with numpy, the same on every device: U(-1, 1)
    [E, h] pairs for the neural states (np-nd-np and np-d-np: two pairs;
    p-nd-np: its decimator's), p-nd-np's SP messages as
    `survey_propagator_init_state` draws them (a normalised random
    simplex, uniform surveys, zero forces), np-d-np's fresh sequential
    decimator bookkeeping."""
    rng = np.random.default_rng(seed)
    E = batch.num_edges

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    def pair():
        return tuple(t(rng.uniform(-1.0, 1.0, (E, hidden_dim)))
                     for _ in range(2))
    if model_type == "p-nd-np":
        v = rng.uniform(size=(E, 3))
        v = v / v.sum(axis=1, keepdims=True)
        prop = SPMessages(var=tuple(t(v[:, i]) for i in range(3)),
                          fn=(t(rng.uniform(size=E)), t(np.zeros(E))))
        return SolverState(prop=prop, dec=pair(), aux=())
    prop, dec = pair(), pair()
    if model_type == "np-d-np":
        return SolverState(prop=prop, dec=dec, aux=SeqDecimatorState(
            prev_eta=torch.zeros(E, device=device),
            counters=torch.zeros(batch.batch_size, device=device),
            has_prev=torch.zeros((), device=device)))
    return SolverState(prop=prop, dec=dec, aux=())


NP_ND_NP_4SAT_YAML = os.path.join(ROOT, "config", "Train",
                                  "np-nd-np-4sat.yaml")
NP_ND_NP_4SAT = {
    "model_name": "np-nd-np-4sat", "model_type": "np-nd-np",
    "version": "0.0g", "has_meta_data": False,
    "train_path": ["datasets/train.json"],
    "validation_path": ["datasets/validation.json"],
    "test_path": ["datasets/test.json"], "model_path": "trained-models",
    "repetition_num": 1, "train_epoch_size": 40000, "epoch_num": 500,
    "label_dim": 1, "edge_feature_dim": 1, "meta_feature_dim": 0,
    "error_dim": 3, "metric_index": 0, "prediction_dim": 1,
    "hidden_dim": 150, "mem_hidden_dim": 100, "agg_hidden_dim": 100,
    "mem_agg_hidden_dim": 50, "classifier_dim": 50, "batch_size": 5000,
    "learning_rate": 0.0001, "exploration": 0.1, "verbose": True,
    "randomized": True, "train_inner_recurrence_num": 1,
    "train_outer_recurrence_num": 10, "test_recurrence_num": 1000,
    "max_cache_size": 100000, "dropout": 0.2, "clip_norm": 0.65,
    "weight_decay": 1e-10, "loss_sharpness": 5,
    "train_batch_limit": 4000000, "test_batch_limit": 40000000,
    "generator": "uniform", "min_n": 5, "max_n": 100, "min_alpha": 7,
    "max_alpha": 10, "min_k": 4, "max_k": 4,
    "local_search_iteration": 100, "epsilon": 0.05, "lambda": 1,
}

P_ND_NP_CNF_3_10_YAML = os.path.join(ROOT, "config", "Train",
                                     "p-nd-np-cnf-3-10.yaml")
P_ND_NP_CNF_3_10 = {
    "model_name": "p-nd-np-cnf-3-10", "model_type": "p-nd-np",
    "version": "2.0", "has_meta_data": True,
    "train_path": ["datasets/train.json"],
    "validation_path": ["datasets/validation.json"],
    "test_path": ["datasets/test.json"], "model_path": "trained-models",
    "repetition_num": 1, "train_epoch_size": 200000, "epoch_num": 500,
    "label_dim": 1, "edge_feature_dim": 1, "meta_feature_dim": 1,
    "error_dim": 3, "metric_index": 0, "prediction_dim": 1,
    "hidden_dim": 150, "mem_hidden_dim": 50, "agg_hidden_dim": 50,
    "mem_agg_hidden_dim": 50, "classifier_dim": 50, "batch_size": 5000,
    "learning_rate": 0.0001, "exploration": 0.1, "verbose": True,
    "randomized": True, "train_inner_recurrence_num": 1,
    "train_outer_recurrence_num": 10, "test_recurrence_num": 20,
    "max_cache_size": 100000, "dropout": 0.2, "clip_norm": 0.65,
    "weight_decay": 1e-10, "loss_sharpness": 5,
    "train_batch_limit": 4000000, "test_batch_limit": 40000000,
    "generator": "uniform", "min_n": 10, "max_n": 100, "min_alpha": 2,
    "max_alpha": 10, "min_k": 2, "max_k": 10,
    "local_search_iteration": 10, "epsilon": 0.05, "lambda": 1,
}
