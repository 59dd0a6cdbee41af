"""The shared benchmark set: uniform random 4-SAT, n=100, alpha=9.0.

A standalone copy of the JAX package's generator (its module sits inside a
package whose imports pull in JAX). Same seed, same draws, same bytes:
the fingerprint of the default set is d3cba04af19db12d.
"""

import hashlib

import numpy as np

SHARED_SET_FINGERPRINT = "d3cba04af19db12d"


def make_ksat_set(seed=0, count=128, n=100, alpha=9.0, k=4):
    """List of (n, m, graph_map[2,E], edge_sign[E], label) instances."""
    rng = np.random.default_rng(seed)
    m = int(n * alpha)
    insts = []
    for _ in range(count):
        ev = np.empty(m * k, dtype=np.int32)
        ec = np.empty(m * k, dtype=np.int32)
        for ci in range(m):
            ev[ci * k:(ci + 1) * k] = rng.choice(n, k, replace=False)
            ec[ci * k:(ci + 1) * k] = ci
        signs = (2.0 * rng.integers(0, 2, size=m * k) - 1.0).astype(
            np.float32)
        insts.append((n, m, np.stack([ev, ec]), signs, -1.0))
    return insts


def dataset_fingerprint(insts):
    h = hashlib.sha256()
    for n, m, gmap, signs, _ in insts:
        h.update(np.int64(n).tobytes())
        h.update(np.int64(m).tobytes())
        h.update(np.ascontiguousarray(gmap).tobytes())
        h.update(np.ascontiguousarray(signs).tobytes())
    return h.hexdigest()[:16]
