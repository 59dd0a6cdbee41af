"""Progressive batch compaction for long-budget solves.

Counterpart of `pdp_solver_tpu/solvers/compact.py` (`compacting_solve`
:174, `_solve_attempt`, `remap_state`, park/unpark, the restart
`schedule`). The solve runs in chunks of the resumable forward; after each
chunk the per-instance active/solved flags come to the host (one sync),
solved instances are harvested, instances that stopped unsolved are parked
for local search, and when the survivors fit a strictly smaller edge
bucket they are repacked and the carried state is remapped on the device.
After the iteration budget all unsolved instances get the WalkSAT budget
on one compact batch.

With replicas=R every instance enters each attempt as R slots (its
owner's), packed side by side, whose random inits differ; an owner is
solved once any of its slots verifies (the first to verify wins) and its
sibling slots are dropped at the next harvest; the local-search phase
runs R slots of each unsolved owner.

Not ported: the TPU fault-recovery mirror (`resilient`, `mirror_every`).
"""

import dataclasses
import time

import numpy as np
import torch

from pdp_solver_tpu_torch.fg.batch import FGBatch, pack_instances
from pdp_solver_tpu_torch.problem.state import ProblemState
from pdp_solver_tpu_torch.train.loss import cnf_evaluate


def tree_map(fn, x):
    """Apply fn to every tensor leaf of dataclasses / tuples / lists."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, y) for y in x)
    return x


def instance_slices(instances):
    """Per-instance (v_off, f_off, e_off, n, m, e) in the packed layout."""
    out = []
    v = f = e = 0
    for inst in instances:
        n, m, ei = int(inst[0]), int(inst[1]), int(inst[2].shape[1])
        out.append((v, f, e, n, m, ei))
        v += n
        f += m
        e += ei
    return out


def _dim_maps(old_slices, keep, new_slices):
    """(src_idx, dst_idx) gather maps for each of the four dims."""
    maps = {}
    for dim, (off_i, cnt_i) in {"V": (0, 3), "F": (1, 4),
                                "E": (2, 5)}.items():
        src, dst = [], []
        for j, i in enumerate(keep):
            o, c = old_slices[i][off_i], old_slices[i][cnt_i]
            n_ = new_slices[j][off_i]
            src.append(np.arange(o, o + c))
            dst.append(np.arange(n_, n_ + c))
        maps[dim] = (np.concatenate(src) if src else np.zeros(0, np.int64),
                     np.concatenate(dst) if dst else np.zeros(0, np.int64))
    maps["B"] = (np.asarray(keep, np.int64),
                 np.arange(len(keep), dtype=np.int64))
    return maps


def remap_state(tree, keep, old_batch: FGBatch, new_batch: FGBatch,
                old_slices, new_slices):
    """Remap every tensor leaf from the old packed layout to the new one on
    its device. Leaves are classified by leading dimension (E/V/F/B must be
    distinct); padding is zero-filled, scalars pass through."""
    old_dims = {"E": old_batch.num_edges, "V": old_batch.num_vars,
                "F": old_batch.num_clauses, "B": old_batch.batch_size}
    if len(set(old_dims.values())) != 4:
        raise ValueError(f"ambiguous packed dims {old_dims}: cannot "
                         "classify state arrays by leading dimension")
    new_dims = {"E": new_batch.num_edges, "V": new_batch.num_vars,
                "F": new_batch.num_clauses, "B": new_batch.batch_size}
    by_old = {v: k for k, v in old_dims.items()}
    maps = _dim_maps(old_slices, keep, new_slices)
    dev_maps = {}

    def leaf(x):
        if x.dim() == 0 or x.shape[0] not in by_old:
            return x
        dim = by_old[x.shape[0]]
        if dim not in dev_maps:
            src, dst = maps[dim]
            dev_maps[dim] = (torch.from_numpy(src).to(x.device),
                             torch.from_numpy(dst).to(x.device))
        src, dst = dev_maps[dim]
        out = x.new_zeros((new_dims[dim],) + tuple(x.shape[1:]))
        out[dst] = x[src]
        return out

    return tree_map(leaf, tree)


def _park(store, orig, problem_host, slices, slot):
    """Record an instance's final problem state for the local-search phase
    (problem_host: a ProblemState of numpy arrays)."""
    v, f, _, n, m, _ = slices[slot]
    store[orig] = {
        "active_vars": problem_host.active_vars[v:v + n].copy(),
        "active_clauses": problem_host.active_clauses[f:f + m].copy(),
        "solution": problem_host.solution[v:v + n].copy(),
        "is_sat": float(problem_host.is_sat[slot]),
    }


def _unpark(store, todo, batch: FGBatch, slices):
    """Rebuild a packed ProblemState from parked per-instance records."""
    V, F, B = batch.num_vars, batch.num_clauses, batch.batch_size
    av = np.zeros(V, np.float32)
    ac = np.zeros(F, np.float32)
    sol = 0.5 * np.ones(V, np.float32)
    iss = 0.5 * np.ones(B, np.float32)
    for slot, orig in enumerate(todo):
        v, f, _, n, m, _ = slices[slot]
        rec = store[orig]
        av[v:v + n] = rec["active_vars"]
        ac[f:f + m] = rec["active_clauses"]
        sol[v:v + n] = rec["solution"]
        iss[slot] = rec["is_sat"]
    dev = batch.device
    return ProblemState(active_vars=torch.from_numpy(av).to(dev),
                        active_clauses=torch.from_numpy(ac).to(dev),
                        solution=torch.from_numpy(sol).to(dev),
                        is_sat=torch.from_numpy(iss).to(dev))


def _to_host(problem: ProblemState) -> ProblemState:
    return tree_map(lambda x: x.cpu().numpy(), problem)


def compacting_solve(solver, params, generator, instances, iterations, *,
                     ls_iterations=None, chunk=50, min_edges=32768,
                     schedule=None, replicas=1, device="cuda"):
    """Full solve over `instances` with progressive batch compaction and an
    optional restart schedule.

    Returns (solutions, solved, stats): solutions a list of f32[n_i]
    assignments in {0, 1}, solved a bool list (verified against the
    formula on the device by cnf_evaluate), stats a dict of telemetry;
    one entry an instance whatever `replicas`.
    schedule: optional list of (iterations, ls_iterations) attempts;
    still-unsolved instances re-enter the next attempt with a fresh random
    message init. replicas: slots an instance (see the module docstring;
    the JAX package's compacting_solve(replicas=) :177)."""
    ls_total = (solver.cfg.local_search_iterations
                if ls_iterations is None else ls_iterations)
    if schedule is None:
        schedule = [(iterations, ls_total)]
    count = len(instances)
    solutions = [None] * count
    solved = [False] * count
    remaining = list(range(count))
    all_stats = {"attempts": [], "compactions": [], "chunks": 0,
                 "ls_wall_s": 0.0, "pdp_wall_s": 0.0}
    t0 = time.time()
    R = max(replicas, 1)
    for it_k, ls_k in schedule:
        subset = [instances[i] for i in remaining for _ in range(R)]
        owners = [j for j in range(len(remaining)) for _ in range(R)]
        sols_k, solved_k, st_k = _solve_attempt(
            solver, params, generator, subset, it_k, ls_iterations=ls_k,
            chunk=chunk, min_edges=min_edges, device=device, owners=owners)
        for j, orig in enumerate(remaining):
            solutions[orig] = sols_k[j]
            solved[orig] = solved_k[j]
        all_stats["attempts"].append(
            {"iterations": it_k, "ls": ls_k, "instances": len(remaining),
             "solved": int(sum(solved_k)),
             "loop_solved": st_k["loop_solved"], "wall_s": st_k["wall_s"],
             "ls_wall_s": st_k["ls_wall_s"],
             "progress": st_k.get("progress", [])})
        all_stats["compactions"].extend(st_k["compactions"])
        for k in ("chunks", "ls_wall_s", "pdp_wall_s"):
            all_stats[k] += st_k[k]
        remaining = [i for i in remaining if not solved[i]]
        if not remaining:
            break
    all_stats["wall_s"] = round(time.time() - t0, 3)
    all_stats["solved"] = int(sum(solved))
    return solutions, solved, all_stats


def _solve_attempt(solver, params, generator, instances, iterations, *,
                   ls_iterations, chunk, min_edges, device, owners):
    """One compacting solve pass (see compacting_solve). owners: the owner
    of each slot (consecutive, from 0); the lists returned are per
    owner."""
    n_slots = len(instances)
    owner_of = list(owners)
    count = max(owner_of) + 1 if owner_of else 0
    ls_replicas = max(n_slots // max(count, 1), 1)
    ls_chunk = max(chunk * 4, 200)
    solutions = [None] * count
    solved = [False] * count
    parked = {}

    # --- phase 1: decimation loop with compaction -----------------------
    live = list(range(n_slots))      # slot index per batch slot
    batch = pack_instances(instances, device=device)
    slices = instance_slices(instances)
    state = solver.get_init_state(generator, batch, randomized=True)
    carry = None
    sv = None
    stats = {"compactions": [], "chunks": 0, "progress": []}
    done = 0
    chunk0, e0 = chunk, batch.num_edges
    sv_aligned = True
    n_finished_prev = 0
    t0 = time.time()
    while done < iterations and live:
        n = min(chunk, iterations - done)
        _, state, carry = solver.forward(
            params, generator, batch, state, n, check_termination=True,
            carry=carry, finalize=False)
        sv, _ = cnf_evaluate(batch, carry[0].solution[:, None])
        flags = torch.stack([carry[1], sv]).cpu().numpy()   # one sync
        active_b = flags[0][:len(live)]
        solved_b = flags[1][:len(live)]
        done += n
        sv_aligned = True
        stats["chunks"] += 1
        finished = [s for s in range(len(live)) if active_b[s] <= 0]
        if len(finished) == n_finished_prev:
            continue
        n_finished_prev = len(finished)
        problem_host = _to_host(carry[0])
        _harvest(live, solved_b, owner_of, slices, problem_host, solutions,
                 solved)
        stats["progress"].append(
            (done, int(sum(solved)), int((active_b > 0).sum()),
             round(time.time() - t0, 3)))
        # live slots of unsolved owners stay; stopped ones are parked
        keep = []
        for slot, orig in enumerate(live):
            ow = owner_of[orig]
            if solved[ow]:
                continue
            if active_b[slot] > 0:
                keep.append(slot)
            else:
                _park(parked, ow, problem_host, slices, slot)
        if not keep:
            live = []
            break
        if batch.num_edges > min_edges and len(keep) < len(live):
            new_insts = [instances[live[s]] for s in keep]
            tentative = pack_instances(new_insts, device=device)
            if tentative.num_edges < batch.num_edges:
                new_slices = instance_slices(new_insts)
                state = remap_state(state, keep, batch, tentative, slices,
                                    new_slices)
                carry = remap_state(carry, keep, batch, tentative, slices,
                                    new_slices)
                live = [live[s] for s in keep]
                batch, slices = tentative, new_slices
                n_finished_prev = 0
                chunk = min(chunk0 * (e0 // batch.num_edges), chunk0 * 4)
                sv_aligned = False
                stats["compactions"].append(
                    {"iter": done, "instances": len(live),
                     "edges": batch.num_edges})
    stats["pdp_wall_s"] = round(time.time() - t0, 3)

    # leftover live instances (budget exhausted): park for local search
    if live and carry is not None:
        problem_host = _to_host(carry[0])
        solved_b = (sv.cpu().numpy()[:len(live)] if sv_aligned
                    else np.zeros(len(live)))
        _harvest(live, solved_b, owner_of, slices, problem_host, solutions,
                 solved)
        for slot, orig in enumerate(live):
            if not solved[owner_of[orig]]:
                _park(parked, owner_of[orig], problem_host, slices, slot)

    # --- phase 2: local search on the unsolved set -----------------------
    stats["loop_solved"] = int(sum(solved))
    t1 = time.time()
    todo = [i for i in range(count) if not solved[i] and i in parked]
    if ls_iterations > 0 and todo:
        # R slots of each unsolved owner again: WalkSAT depends on its
        # start as much as the loop on its init
        ls_owner = [o for o in todo for _ in range(ls_replicas)]
        inst_of = {}
        for slot, ow in enumerate(owner_of):
            inst_of.setdefault(ow, instances[slot])
        ls_insts = [inst_of[o] for o in ls_owner]
        ls_batch = pack_instances(ls_insts, device=device)
        ls_slices = instance_slices(ls_insts)
        problem = _unpark(parked, ls_owner, ls_batch, ls_slices)
        noise = (torch.rand((ls_batch.num_vars, 1), generator=generator)
                 > 0.5).to(torch.float32).to(ls_batch.device)
        av = problem.active_vars[:, None]
        pred = torch.where(av > 0, noise, problem.solution[:, None])
        sv = torch.zeros((ls_batch.batch_size,), device=ls_batch.device)
        done_ls = 0
        while done_ls < ls_iterations:
            n = min(ls_chunk, ls_iterations - done_ls)
            new = solver.local_search(generator, ls_batch, problem, pred, n)
            pred = av * new + (1.0 - av) * problem.solution[:, None]
            sv, _ = cnf_evaluate(ls_batch, pred)
            done_ls += n
            hit = sv[:len(ls_owner)].reshape(len(todo), ls_replicas) > 0
            if bool(hit.any(dim=1).all()):
                break
        pred_host = pred[:, 0].cpu().numpy()
        sv_host = sv.cpu().numpy()
        for slot, o in enumerate(ls_owner):
            hit = bool(sv_host[slot] > 0)
            if solved[o]:
                continue        # an earlier slot of the owner verified
            if hit or solutions[o] is None:
                v, _, _, nv, _, _ = ls_slices[slot]
                solutions[o] = (pred_host[v:v + nv] > 0.5).astype(
                    np.float32)
                solved[o] = hit
    else:
        for i in todo:
            solutions[i] = (parked[i]["solution"] > 0.5).astype(np.float32)
    stats["ls_wall_s"] = round(time.time() - t1, 3)
    stats["wall_s"] = round(time.time() - t0, 3)
    stats["solved"] = int(sum(solved))
    n_of = {}
    for slot, ow in enumerate(owner_of):
        n_of.setdefault(ow, int(instances[slot][0]))
    for i in range(count):
        if solutions[i] is None:
            solutions[i] = np.zeros(n_of[i], np.float32)
    return solutions, solved, stats


def _harvest(live, solved_b, owner_of, slices, problem_host, solutions,
             solved):
    """Record the solution of every live slot that verified, the first
    slot of an owner to verify winning."""
    for slot, orig in enumerate(live):
        ow = owner_of[orig]
        if solved_b[slot] > 0 and not solved[ow]:
            v, _, _, nv, _, _ = slices[slot]
            solutions[ow] = (problem_host.solution[v:v + nv]
                             > 0.5).astype(np.float32)
            solved[ow] = True
