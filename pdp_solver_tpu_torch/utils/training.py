"""The training recipes the port runs: np-nd-np at the flagship recipe and
at `config/Train/np-nd-np-4sat.yaml`.

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

`NP_ND_NP_4SAT` is `config/Train/np-nd-np-4sat.yaml`, key for key, so
that the card's machine needs no PyYAML (tests/test_torch_train.py holds
it against the file read by `utils/config.py`).
"""

import os

import numpy as np
import torch

from pdp_solver_tpu_torch.fg.generators import (
    MixtureCNFGenerator, UniformCNFGenerator)
from pdp_solver_tpu_torch.fg.loader import BatchLoader
from pdp_solver_tpu_torch.solvers.base import SolverState

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FLAGSHIP_RECIPE = dict(
    model_type="np-nd-np", model_name="np-nd-np-r3",
    hidden_dim=150, mem_hidden_dim=100, agg_hidden_dim=100,
    mem_agg_hidden_dim=50, classifier_dim=50, prediction_dim=1,
    dropout=0.2, train_outer_recurrence_num=10,
    train_inner_recurrence_num=1, learning_rate=1e-4, weight_decay=1e-10,
    clip_norm=0.65, exploration=0.1, loss_sharpness=5, randomized=True,
    batch_size=512, train_batch_limit=4 * 10 ** 9, train_remat=True,
    test_batch_limit=4 * 10 ** 7, test_recurrence_num=1000,
    local_search_iteration=0, epsilon=0.5, **{"lambda": 1.0})

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


def flagship_segments(seed, dims=FIXED_DIMS, device="cuda",
                      epoch_size=10 ** 9):
    """(batch, misc, macro_done) segments of the flagship stream packed to
    `dims` (the flagship run's loader, :142-147)."""
    c = FLAGSHIP_RECIPE
    return BatchLoader(
        generator=flagship_stream(seed), epoch_size=epoch_size,
        batch_size=c["batch_size"], limit=c["train_batch_limit"],
        hidden_dim=c["hidden_dim"], fixed_shape=True, fixed_dims=dims,
        device=device).iter_segments()


def numpy_init_state(batch, hidden_dim, seed, device):
    """An np-nd-np init state drawn with numpy: four U(-1, 1) [E, h]
    arrays, the same on every device."""
    rng = np.random.default_rng(seed)
    x = [torch.from_numpy(rng.uniform(
        -1.0, 1.0, (batch.num_edges, hidden_dim)).astype(np.float32)).to(
            device) for _ in range(4)]
    return SolverState(prop=(x[0], x[1]), dec=(x[2], x[3]), aux=())


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
