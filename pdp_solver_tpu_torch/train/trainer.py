"""Training: the T-step BPTT energy loss, the optimizer and the train loop.

Counterpart of `pdp_solver_tpu/train/trainer.py` (`SatTrainer` :41) for
the three neural assemblies, np-nd-np, p-nd-np and np-d-np, whose
forward is differentiable here (`PDPSolver.forward(is_training=True)`):

  * the loss (:94-159): an init state, then T outer steps of
    train_inner_recurrence_num iterations each, the energy of each
    step's prediction weighted lambda^(T-1-t); with train_remat (default
    on) each outer step is recomputed in the backward pass
    (torch.utils.checkpoint, as JAX's jax.checkpoint), which keeps one
    step's [E, h] activations alive instead of T. The state passes from
    step to step whole: np-d-np's sequential-decimator bookkeeping (its
    `aux`) rides through the checkpoint as tensors without grad, and its
    problem starts fresh in every step, as JAX's forward is called with
    carry=None at each. train_scan (JAX :114-150: a lax.scan over the
    outer steps, a compile-size switch) has the same math and is
    accepted: the steps here are a Python loop either way;
  * the optimizer in optax's order (:76-84): clip by global norm
    (optax's rule: scale by max_norm / norm only when norm >= max_norm;
    not clip_grad_norm_, which divides by norm + 1e-6), then add
    weight_decay * p, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root), then -learning_rate. torch.optim.Adam with
    weight_decay is the last three: it adds wd * p to the gradient
    before its moments, as optax's add_decayed_weights does before
    scale_by_adam;
  * `train` (:252-420): repetitions, epochs of generated or file-backed
    segments, global_step advanced once per macro-batch, validation
    (`test_metrics` :545-565) each epoch, best/last checkpoints in the
    JAX package's format (`train/checkpoint.py`) and losses.npy /
    errors.npy at the end. Step losses stay on the device until the
    epoch ends.

Random numbers: the trainer holds one CPU torch.Generator seeded with
random_seed & 0x7FFFFFFF (JAX :46). It draws, on the host and so without
a device sync, the seed of each outer step's dropout generator and the
seeds of the init states, whose tensors are drawn on the device (as the
solver does, `solvers/base.py`). A step's dropout generator is made
inside its checkpointed function from that seed, so the recompute of
train_remat draws the same masks (torch.utils.checkpoint's
preserve_rng_state covers only the default generators). The numbers
differ from JAX's PRNG; the tests compare the two packages with dropout
0 and randomized=False, where neither draws.

Checkpoints resume whole: the JAX package's train states hold Adam's
moments under ['opt'][2] (the r4 checkpoints of p-nd-np and np-d-np do),
and `_load_train_state` loads them into torch.optim.Adam.

Data parallelism (`data_parallel > 1`), `test`, `predict` and the
parallel solve are not ported (ROADMAP.md queue 1, items 8 and 9).
"""

import itertools
import os
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.loader import BatchLoader
from pdp_solver_tpu_torch.modules.decimate import SeqDecimatorState
from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.solvers.base import (
    PDPSolver, SolverState, build_solver, random_seed32)
from pdp_solver_tpu_torch.train import checkpoint as ckpt
from pdp_solver_tpu_torch.train.loss import (
    LOSS_EPS, cnf_evaluate, energy_loss)


class TrainState(NamedTuple):
    params: torch.nn.ModuleDict
    opt: torch.optim.Adam
    global_step: torch.Tensor   # f32 scalar on the device: the annealing


def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm, in place: every gradient times
    max_norm / norm where norm >= max_norm, as (g / norm) * max_norm;
    unchanged below it. No host sync."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def state_tensors(state: SolverState):
    """A training state's tensors in one flat tuple (prop, dec, aux), and
    the function that rebuilds the state from such a tuple: for
    torch.utils.checkpoint, which takes and returns tensors."""
    parts = []
    for part in (state.prop, state.dec):
        if isinstance(part, SPMessages):
            parts.append(("sp", len(part.var), (*part.var, *part.fn)))
        else:
            parts.append(("pair", 0, tuple(part)))
    aux = (() if isinstance(state.aux, tuple)
           else (state.aux.prev_eta, state.aux.counters, state.aux.has_prev))
    sizes = [len(p[2]) for p in parts]

    def rebuild(tensors):
        out, i = [], 0
        for (kind, n_var, _), n in zip(parts, sizes):
            xs = tuple(tensors[i:i + n])
            i += n
            out.append(SPMessages(var=xs[:n_var], fn=xs[n_var:])
                       if kind == "sp" else xs)
        rest = tuple(tensors[i:])
        return SolverState(prop=out[0], dec=out[1],
                           aux=SeqDecimatorState(*rest) if rest else ())
    return parts[0][2] + parts[1][2] + aux, rebuild


class SatTrainer:
    def __init__(self, config: dict, logger=None, seed=0, device="cuda"):
        self._config = dict(config)
        self._logger = logger
        self.device = torch.device(device)
        self.solver: PDPSolver = build_solver(config)
        self._seed = int(config.get("random_seed", seed)) & 0x7FFFFFFF
        self._gen = torch.Generator()
        self._gen.manual_seed(self._seed)
        # a fresh init from the seed alone, the same on every device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self._seed)
            self.params = self.solver.init_params("cpu").to(self.device)
        if self._config.get("verbose"):
            self._log("The model parameter count is %d." % sum(
                p.numel() for p in self.params.parameters()))
        # the annealing step the metric losses are evaluated at (JAX :55)
        self.global_step = torch.ones((), device=self.device)

    # ---------------------------------------------------------------- utils

    def _log(self, msg):
        if self._logger is not None:
            self._logger.info(msg)

    def _make_optimizer(self, params):
        c = self._config
        self._clip_norm = float(c.get("clip_norm", 0.65))
        return torch.optim.Adam(
            params.parameters(), lr=float(c.get("learning_rate", 1e-4)),
            betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(c.get("weight_decay", 0.0)))

    def init_train_state(self) -> TrainState:
        return TrainState(params=self.params,
                          opt=self._make_optimizer(self.params),
                          global_step=torch.zeros((), device=self.device))

    # ---------------------------------------------------------------- train

    def _outer_step(self, params, batch, t_inner, seed, rebuild):
        """One outer BPTT step as a function of the state tensors, for
        torch.utils.checkpoint: its dropout generator is made from `seed`
        here, so a recompute draws the same masks."""
        def step(*tensors):
            gen = None
            if seed is not None:
                gen = torch.Generator(device=batch.device)
                gen.manual_seed(seed)
            (pred, _), st = self.solver.forward(
                params, gen, batch, rebuild(tensors), t_inner,
                is_training=True)
            return (pred, *state_tensors(st)[0])
        return step

    def loss(self, params, batch, global_step, init_state=None):
        """The T-step lambda-discounted BPTT energy loss (JAX `_loss_fn`
        :94-159; reference base.py:162-173), a scalar on the device.
        init_state, when given, replaces the drawn init state. Under
        torch.no_grad() it is the held-out energy: no recompute."""
        self.solver.check_trainable()
        c = self._config
        t_outer = int(c.get("train_outer_recurrence_num", 1))
        t_inner = int(c.get("train_inner_recurrence_num", 1))
        lam = float(c.get("lambda", 1.0))
        alpha = float(c.get("exploration", 1.0))
        kappa = c.get("loss_sharpness", 1)
        remat = (bool(c.get("train_remat", True))
                 and torch.is_grad_enabled())
        # the neural propagator is the one module with dropout
        drop = (params.training and self.solver.neural_prop
                and self.solver.cfg.dropout > 0.0)
        state = init_state
        if state is None:
            state = self.solver.get_init_state(
                self._gen, batch, bool(c.get("randomized", True)))
        tensors, rebuild = state_tensors(state)
        loss = torch.zeros((), device=batch.device)
        for t in range(t_outer):
            seed = random_seed32(self._gen) if drop else None
            step = self._outer_step(params, batch, t_inner, seed, rebuild)
            if remat:
                pred, *tensors = checkpoint(step, *tensors,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                pred, *tensors = step(*tensors)
            step_loss = energy_loss(batch, pred, global_step, alpha, kappa)
            loss = loss + step_loss * (lam ** (t_outer - t - 1))
        return loss

    def train_step(self, train_state: TrainState, batch):
        """One optimizer step on one segment: the loss, its gradients,
        then optax's order of clip, decayed weights, Adam and -lr. The
        parameters and Adam's state change in place; returns
        (train_state, loss) with the loss a device scalar."""
        params, opt = train_state.params, train_state.opt
        params.train()
        opt.zero_grad(set_to_none=True)
        loss = self.loss(params, batch, train_state.global_step)
        loss.backward()
        ps = list(params.parameters())
        for p in ps:
            if p.grad is None:   # optax updates every leaf, with g = 0
                p.grad = torch.zeros_like(p)
        clip_by_global_norm([p.grad for p in ps], self._clip_norm)
        opt.step()
        return train_state, loss.detach()

    def train_segments(self, train_state, segments, max_steps=None):
        """One train_step per (batch, misc, macro_done) segment (at most
        max_steps), global_step advanced on the last segment of each
        macro-batch (reference base.py:144-145). Returns (train_state,
        the step losses as device scalars, folded every 256 steps with no
        host sync, the number of instances)."""
        losses, n_inst = [], 0
        for batch, _, macro_done in itertools.islice(segments, max_steps):
            n_inst += batch.num_instances
            train_state, loss = self.train_step(train_state, batch)
            losses.append(loss)
            if len(losses) >= 256:
                losses = [torch.stack(losses).sum()]
            if macro_done:
                train_state = train_state._replace(
                    global_step=train_state.global_step + 1.0)
        return train_state, losses, n_inst

    def train(self, train_files, validation_files, last_export_path=None,
              best_export_path=None, metric_index=0, load_model=None,
              reset_step=False, generator=None, train_epoch_size=0):
        """The train loop (JAX :252-420; reference base.py:311-404)."""
        c = self._config
        if int(c.get("data_parallel", 1)) > 1:
            raise NotImplementedError(
                "data-parallel training is not ported yet (ROADMAP.md "
                "queue 1, item 9)")
        train_state = self.init_train_state()

        def restore(train_state):
            """The checkpoint is reloaded at the start of every
            repetition (reference base.py:343-350)."""
            if load_model == "best" and best_export_path:
                train_state = self._load_train_state(train_state,
                                                     best_export_path)
            elif load_model == "last" and last_export_path:
                train_state = self._load_train_state(train_state,
                                                     last_export_path)
            if reset_step:
                train_state = train_state._replace(
                    global_step=torch.zeros((), device=self.device))
            return train_state

        train_loader = BatchLoader(
            input_file=None if generator is not None else train_files[0],
            generator=generator, epoch_size=train_epoch_size,
            batch_size=c.get("batch_size", 5000),
            limit=c.get("train_batch_limit", 4000000),
            hidden_dim=c.get("hidden_dim", 3), shuffle=True,
            fixed_shape=generator is not None,
            fixed_dims=c.get("fixed_dims"),
            max_cache_size=c.get("max_cache_size", 100000),
            device=self.device)
        val_loader = BatchLoader(
            input_file=validation_files[0],
            batch_size=c.get("batch_size", 5000),
            limit=c.get("test_batch_limit", 40000000),
            hidden_dim=c.get("hidden_dim", 3),
            max_cache_size=c.get("max_cache_size", 100000),
            device=self.device)

        epoch_num = int(c.get("epoch_num", 1))
        rep_num = int(c.get("repetition_num", 1))
        errors = np.zeros((3, epoch_num, rep_num), np.float32)
        losses = np.zeros((epoch_num, rep_num), np.float32)
        best_error = np.inf

        for rep in range(rep_num):
            train_state = restore(train_state)
            for epoch in range(epoch_num):
                start = time.time()
                train_state, step_losses, total_examples = \
                    self.train_segments(train_state,
                                        train_loader.iter_segments())
                total_loss = (float(torch.stack(step_losses).sum())
                              if step_losses else 0.0)
                losses[epoch, rep] = total_loss / max(total_examples, 1)
                self.params = train_state.params
                self.global_step = train_state.global_step
                err = self.test_metrics(val_loader)
                errors[:, epoch, rep] = err
                duration = time.time() - start

                if last_export_path:
                    self._save_train_state(train_state, last_export_path)
                if best_export_path and err[metric_index] < best_error:
                    best_error = err[metric_index]
                    self._save_train_state(train_state, best_export_path)

                self._log("Rep %d, Epoch %d: error=%s loss=%.5f (%.1fs)" % (
                    rep + 1, epoch + 1, np.array_str(err),
                    losses[epoch, rep], duration))

        if best_export_path:
            np.save(os.path.join(best_export_path, "losses"), losses)
            np.save(os.path.join(best_export_path, "errors"), errors)
        self.params = train_state.params
        return train_state, errors, losses

    # ---------------------------------------------------------------- test

    def _run_batch(self, batch):
        """One serving forward of test_recurrence_num iterations with the
        termination check (and local search, if configured)."""
        iters = int(self._config.get("test_recurrence_num", 1000))
        state = self.solver.get_init_state(self._gen, batch, randomized=True)
        (var_pred, _), _ = self.solver.forward(
            self.params, self._gen, batch, state, iters,
            check_termination=True)
        return var_pred

    def test_metrics(self, loader):
        """[accuracy (L1 of solved against the label), recall, loss],
        summed over instances / total (JAX :545-565; reference
        base.py:184-250)."""
        c = self._config
        err = np.zeros(3, np.float64)
        total = 0
        self.params.eval()
        with torch.no_grad():
            for batch, _ in loader:
                var_pred = self._run_batch(batch)
                solved, _ = cnf_evaluate(batch, var_pred)
                mask = batch.instance_mask.cpu().numpy()
                s = (solved.cpu().numpy() > 0.5).astype(np.float32)
                lab = batch.label.cpu().numpy()
                n_real = mask.sum()
                l1 = float((np.abs(s - lab) * mask).sum() / max(n_real, 1))
                recall = float((lab * np.abs(s - lab) * mask).sum()
                               / max((lab * mask).sum(), LOSS_EPS))
                loss = float(energy_loss(
                    batch, var_pred, self.global_step,
                    c.get("exploration", 1.0), c.get("loss_sharpness", 1)))
                err += np.array([l1, recall, loss]) * n_real
                total += n_real
        return (err / max(total, 1)).astype(np.float32)

    def test(self, *args, **kwargs):
        raise NotImplementedError("SatTrainer.test is not ported yet "
                                  "(ROADMAP.md queue 1, item 8: the CLIs)")

    def predict(self, *args, **kwargs):
        raise NotImplementedError("SatTrainer.predict is not ported yet "
                                  "(ROADMAP.md queue 1, item 8: the CLIs)")

    def _format_predictions(self, *args, **kwargs):
        raise NotImplementedError("SatTrainer._format_predictions is not "
                                  "ported yet (ROADMAP.md queue 1, item 8)")

    def _parallel_solve_fn(self, *args, **kwargs):
        raise NotImplementedError("the parallel solve is not ported yet "
                                  "(ROADMAP.md queue 1, item 9)")

    # ---------------------------------------------------------------- ckpt

    def _name(self):
        return self.solver.cfg.name

    def _save_train_state(self, train_state: TrainState, path):
        """params + Adam's state + global_step, in the JAX package's
        layout (JAX :691-702)."""
        ckpt.save_params(path, {
            "params": convert.params_to_jax(train_state.params),
            "opt": ckpt.opt_state(convert.adam_to_jax(train_state.opt,
                                                      train_state.params)),
            "global_step": np.float32(float(train_state.global_step)),
        }, self._name())

    def _load_train_state(self, train_state: TrainState, path):
        """A checkpoint of either package (JAX :704-723). A params-only
        checkpoint (before round 5: r3, np-nd-np-full) leaves Adam's state
        as it is: fresh, after init_train_state."""
        name = self._name()
        params, opt = train_state.params, train_state.opt
        template = {"params": convert.params_to_jax(params),
                    "global_step": np.zeros((), np.float32)}
        has_opt = any(k.startswith("['opt']")
                      for k in ckpt.checkpoint_keys(path, name))
        if has_opt:
            adam = convert.adam_to_jax(opt, params)
            adam["count"] = np.zeros((), np.int32)
            template["opt"] = ckpt.opt_state(adam)
        restored = ckpt.load_params(path, template, name)
        convert.load_into(params, restored["params"])
        if has_opt:
            convert.adam_from_jax(opt, params,
                                  restored["opt"][ckpt.OPT_STATE]._asdict())
        return train_state._replace(global_step=torch.as_tensor(
            restored["global_step"], dtype=torch.float32,
            device=self.device))
