"""The compact JSON-lines CNF format, byte-compatible with the reference.

The port's own copy of `pdp_solver_tpu/fg/jsonfmt.py` (numpy only), so
that the port imports nothing of the JAX package.

One CNF per line:  [[n, m], signed 1-based var ids (one per edge, clause
order), 1-based clause ids, label, [optional id]]  - produced by reference
dimacs2json.py:85-91 and parsed by dataset.py:120-136.
"""

import json

import numpy as np


def parse_line(line):
    """JSON line -> (n, m, graph_map[2,E], edge_sign[E], label, misc[, meta]).

    Extension over the reference format: an optional 6th element holds a
    per-instance meta feature vector (the reference's `meta_data` slot is
    plumbed through its modules but its JSON path always yields None,
    dataset.py:136; this row extension is the missing data source)."""
    data = json.loads(line)
    n, m = data[0]
    signed_vars = np.asarray(data[1], dtype=np.int64)
    clause_ids = np.asarray(data[2], dtype=np.int64)
    ev = (np.abs(signed_vars) - 1).astype(np.int32)
    ec = (np.abs(clause_ids) - 1).astype(np.int32)
    signs = np.sign(signed_vars).astype(np.float32)
    misc = data[4] if len(data) > 4 else []
    out = (int(n), int(m), np.stack([ev, ec]), signs, float(data[3]), misc)
    if len(data) > 5:
        out = out + (np.asarray(data[5], dtype=np.float32),)
    return out


def instance_to_line(n, m, gmap, signs, label, misc=None):
    """Inverse of parse_line, matching the reference writer's formatting
    (str(list) with double quotes, dimacs2json.py:111)."""
    signed_vars = [int(v) for v in (gmap[0] + 1) * signs.astype(np.int64)]
    clause_ids = [int(c) for c in gmap[1] + 1]
    row = [[int(n), int(m)], signed_vars, clause_ids, label]
    if misc:
        row.append(misc)
    return str(row).replace("'", '"')


def clauses_to_line(n, clauses, label, misc=None):
    signed_vars, clause_ids = [], []
    for ci, clause in enumerate(clauses):
        for lit in clause:
            signed_vars.append(int(lit))
            clause_ids.append(ci + 1)
    row = [[int(n), len(clauses)], signed_vars, clause_ids, label]
    if misc:
        row.append(misc)
    return str(row).replace("'", '"')


def read_json_dataset(path):
    """All instances of a JSON-lines file (list of parse_line tuples)."""
    out = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(parse_line(line))
    return out
