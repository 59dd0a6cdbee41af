"""Streaming CNF generators for unsupervised training.

The port's own copy of `pdp_solver_tpu/fg/generators.py` (numpy only):
the same instances from the same seed.

Host-side numpy ports of reference src/pdp/generator.py: uniform random
k-SAT, and the Community Attachment ("modular") model of Giraldez-Cru &
Levy (fixed-k and variable-k variants). Each generator yields per-instance
tuples (n, m, graph_map[2,E], edge_sign[E], label) consumed by
fg.batch.pack_instances.

Unlike the reference (whose DataLoader workers share one global numpy RNG),
every generator owns an explicit numpy Generator so per-host streams shard
deterministically (seed = base_seed + host_id).
"""

import numpy as np


def _sat_label(n, clause_list):
    """Labeling hook. The reference stub returns False for every formula
    (generator.py:15-17); plug a real solver here for labeled data (see
    label_instances below for the batch API)."""
    return -1.0


def label_instances(instances, iterations=1000, ls_iterations=None,
                    attempts=2, seed=0):
    """Label instance tuples by solving them with p-d-p and WalkSAT (JAX
    generators.py :24, through compacting_solve). Not ported yet: it
    waits for the labelling item of ROADMAP.md's queue 1 (item 7)."""
    raise NotImplementedError(
        "label_instances is not ported yet (ROADMAP.md queue 1, item 7)")


class CNFGeneratorBase:
    def __init__(self, min_n, max_n, min_alpha, max_alpha, seed=None):
        self._min_n = min_n
        self._max_n = max_n
        self._min_alpha = min_alpha
        self._max_alpha = max_alpha
        self._rng = np.random.default_rng(seed)

    def reseed(self, seed):
        self._rng = np.random.default_rng(seed)

    def generate(self):
        raise NotImplementedError

    def max_dims(self):
        """Worst-case (V, F, E) of a single generated instance, for static
        bucket sizing."""
        raise NotImplementedError


class UniformCNFGenerator(CNFGeneratorBase):
    """Uniform random k-SAT (reference generator.py:98-157): n ~ U[min_n,max_n],
    alpha ~ U[min_a,max_a], per-clause length k ~ U[min_k, min(max_k, n-1)],
    variables without replacement, iid polarities."""

    def __init__(self, min_n, max_n, min_k, max_k, min_alpha, max_alpha,
                 seed=None):
        super().__init__(min_n, max_n, min_alpha, max_alpha, seed)
        self._min_k = min_k
        self._max_k = max_k

    def generate(self):
        r = self._rng
        n = int(r.integers(self._min_n, self._max_n + 1))
        alpha = r.uniform(self._min_alpha, self._max_alpha)
        m = max(1, int(n * alpha))
        kmax = min(self._max_k, n - 1)
        if kmax < self._min_k:
            # n too small for the requested clause length (the reference
            # crashes inside np.random here, generator.py:113); clamp to
            # the only feasible length instead
            kmax = max(kmax, 1)
            lengths = np.full(m, kmax, np.int64)
        else:
            lengths = r.integers(self._min_k, kmax + 1, size=m)
        E = int(lengths.sum())
        ev = np.empty(E, dtype=np.int32)
        ec = np.empty(E, dtype=np.int32)
        off = 0
        for i, k in enumerate(lengths):
            ev[off:off + k] = r.choice(n, int(k), replace=False)
            ec[off:off + k] = i
            off += int(k)
        signs = (2.0 * r.integers(0, 2, size=E) - 1.0).astype(np.float32)
        return (n, m, np.stack([ev, ec]), signs, -1.0)

    def max_dims(self):
        n = self._max_n
        m = int(n * self._max_alpha) + 1
        return n, m, m * min(self._max_k, n - 1)


class ModularCNFGenerator(CNFGeneratorBase):
    """Community Attachment model, fixed clause length k
    (reference generator.py:163-264): with prob p = q + 1/c a clause picks all
    variables from one random community, else one from each of k distinct
    communities."""

    def __init__(self, k, min_n, max_n, min_q, max_q, min_c, max_c,
                 min_alpha, max_alpha, seed=None):
        super().__init__(min_n, max_n, min_alpha, max_alpha, seed)
        self._k = k
        self._min_q = min_q
        self._max_q = max_q
        self._min_c = min_c
        self._max_c = max_c

    def _communities(self, n, k_eff):
        r = self._rng
        q = r.uniform(self._min_q, self._max_q)
        c = int(r.integers(self._min_c, self._max_c + 1))
        c = max(1, min(c, n // max(k_eff, 1) - 1)) if n // max(k_eff, 1) > 1 \
            else 1
        size = n // c
        comm_size = np.full(c, size, dtype=np.int64)
        comm_size[-1] += n - comm_size.sum()
        p = q + 1.0 / c
        perm = r.permutation(n)
        return c, size, comm_size, p, perm

    def _pick_clause_vars(self, n, k, c, size, comm_size, p, perm):
        r = self._rng
        if r.uniform() <= p:
            comm = int(r.integers(0, c))
            lo = size * comm
            pool = np.arange(lo, lo + comm_size[comm])
            return perm[r.choice(pool, k, replace=False)]
        if c >= k:
            comms = r.choice(c, k, replace=False)
            inner = (r.uniform(size=k) * comm_size[comms]).astype(np.int64)
            return perm[size * comms + inner]
        return r.choice(n, k, replace=False)

    def generate(self):
        r = self._rng
        n = int(r.integers(self._min_n, self._max_n + 1))
        alpha = r.uniform(self._min_alpha, self._max_alpha)
        m = max(1, int(n * alpha))
        k = self._k
        c, size, comm_size, p, perm = self._communities(n, k)
        E = m * k
        ev = np.empty(E, dtype=np.int32)
        ec = np.empty(E, dtype=np.int32)
        for i in range(m):
            ev[i * k:(i + 1) * k] = self._pick_clause_vars(
                n, k, c, size, comm_size, p, perm)
            ec[i * k:(i + 1) * k] = i
        signs = (2.0 * r.integers(0, 2, size=E) - 1.0).astype(np.float32)
        return (n, m, np.stack([ev, ec]), signs, -1.0)

    def max_dims(self):
        n = self._max_n
        m = int(n * self._max_alpha) + 1
        return n, m, m * self._k


class VariableModularCNFGenerator(ModularCNFGenerator):
    """Community Attachment with per-clause length k ~ U[min_k, min(max_k,
    n-1, community size)] (reference generator.py:270-377)."""

    def __init__(self, min_k, max_k, min_n, max_n, min_q, max_q, min_c, max_c,
                 min_alpha, max_alpha, seed=None):
        super().__init__(min_k, min_n, max_n, min_q, max_q, min_c, max_c,
                         min_alpha, max_alpha, seed)
        self._min_k = min_k
        self._max_k = max_k

    def generate(self):
        r = self._rng
        n = int(r.integers(self._min_n, self._max_n + 1))
        alpha = r.uniform(self._min_alpha, self._max_alpha)
        m = max(1, int(n * alpha))
        c, size, comm_size, p, perm = self._communities(n, self._min_k)
        kmax = max(self._min_k, min(self._max_k, n - 1, size))
        lengths = r.integers(min(self._min_k, size), kmax + 1, size=m)
        lengths = np.maximum(lengths, 1)
        E = int(lengths.sum())
        ev = np.empty(E, dtype=np.int32)
        ec = np.empty(E, dtype=np.int32)
        off = 0
        for i, k in enumerate(lengths):
            k = int(k)
            ev[off:off + k] = self._pick_clause_vars(
                n, k, c, size, comm_size, p, perm)
            ec[off:off + k] = i
            off += k
        signs = (2.0 * r.integers(0, 2, size=E) - 1.0).astype(np.float32)
        return (n, m, np.stack([ev, ec]), signs, -1.0)

    def max_dims(self):
        n = self._max_n
        m = int(n * self._max_alpha) + 1
        return n, m, m * min(self._max_k, n - 1)


class MixtureCNFGenerator(CNFGeneratorBase):
    """Weighted mixture of sub-generators: each generate() call draws one
    component by weight. Used for curriculum-style training streams (e.g.
    the reference's broad uniform k-SAT recipe blended with extra mass on
    the evaluation bands). max_dims is the elementwise worst case, so
    fixed-shape loaders stay valid for every component."""

    def __init__(self, components, weights=None, seed=None):
        if not components:
            raise ValueError("MixtureCNFGenerator needs >= 1 component")
        self._components = list(components)
        w = np.asarray(weights if weights is not None
                       else [1.0] * len(components), np.float64)
        self._weights = w / w.sum()
        self._rng = np.random.default_rng(seed)

    def reseed(self, seed):
        self._rng = np.random.default_rng(seed)
        for i, g in enumerate(self._components):
            g.reseed(None if seed is None else seed * 1000003 + i)

    def generate(self):
        i = int(self._rng.choice(len(self._components), p=self._weights))
        return self._components[i].generate()

    def max_dims(self):
        dims = [g.max_dims() for g in self._components]
        return tuple(max(d[i] for d in dims) for i in range(3))


def make_generator(config: dict, seed=None) -> CNFGeneratorBase:
    """Build a generator from reference config keys
    (satyr-train-test.py:87-95)."""
    kind = config.get("generator", "uniform")
    if kind == "modular":
        return ModularCNFGenerator(
            config["min_k"], config["min_n"], config["max_n"],
            config["min_q"], config["max_q"], config["min_c"],
            config["max_c"], config["min_alpha"], config["max_alpha"],
            seed=seed)
    if kind == "v-modular":
        return VariableModularCNFGenerator(
            config["min_k"], config["max_k"], config["min_n"],
            config["max_n"], config["min_q"], config["max_q"],
            config["min_c"], config["max_c"], config["min_alpha"],
            config["max_alpha"], seed=seed)
    return UniformCNFGenerator(
        config["min_n"], config["max_n"], config["min_k"], config["max_k"],
        config["min_alpha"], config["max_alpha"], seed=seed)
