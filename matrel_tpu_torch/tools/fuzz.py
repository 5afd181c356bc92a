"""Random expression trees and their numpy oracle — the port's copy of
``tests/test_fuzz.py``'s ``np_eval``, ``_rand_spec`` and ``gen_expr``.

:func:`gen_expr` draws from the numpy ``Generator`` in exactly the JAX
generator's order: every ``rng`` call of the original is made here, in
the same place, with the same arguments. So one seed builds the same
tree in both packages — the same node kinds, shapes and scalar
constants, and bit-equal leaf arrays (``env[uid]``) — and the tests
that hold the port against the JAX package rest on it. Do not add,
drop or reorder a draw.

Leaves are made on the mesh's device (the session's: the card unless
the mesh was made for the CPU). COO leaves hold host edge lists, as in
the JAX package; their plans are built on the device at execution.
"""

from __future__ import annotations

import numpy as np

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import P
from matrel_tpu_torch.ir import expr as E

#: The numpy form of each structured join merge and predicate (the IR's
#: own callables are torch's).
_NP_MERGE = {"left": lambda a, b: a + np.zeros_like(b),
             "right": lambda a, b: b + np.zeros_like(a),
             "add": np.add, "mul": np.multiply}
_NP_PRED = {"eq": np.equal, "lt": np.less, "le": np.less_equal,
            "gt": np.greater, "ge": np.greater_equal}


def _merge_of(attrs):
    kind = attrs.get("merge_kind")
    return _NP_MERGE[kind] if kind else attrs["merge"]


def np_eval(e, env):
    """Reference evaluation of a MatExpr over numpy leaf values."""
    k = e.kind
    if k in ("leaf", "sparse_leaf", "coo_leaf"):
        return env[e.uid]
    if k == "transpose":
        return np_eval(e.children[0], env).T
    if k == "matmul":
        return np_eval(e.children[0], env) @ np_eval(e.children[1], env)
    if k == "elemwise":
        a, b = (np_eval(c, env) for c in e.children)
        op = e.attrs["op"]
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
        if op == "div":
            return np.where(b == 0, 0.0, a / np.where(b == 0, 1.0, b))
        raise NotImplementedError(op)
    if k == "scalar":
        x = np_eval(e.children[0], env)
        op, v = e.attrs["op"], e.attrs["value"]
        if op == "add":
            return x + v
        if op == "mul":
            return x * v
        return np.power(x, v)
    if k == "agg":
        x = np_eval(e.children[0], env)
        kind, axis = e.attrs["agg"], e.attrs["axis"]
        if kind == "sum":
            if axis == "row":
                return x.sum(1, keepdims=True)
            if axis == "col":
                return x.sum(0, keepdims=True)
            if axis == "all":
                return x.sum().reshape(1, 1)
            return np.trace(x).reshape(1, 1)
        raise NotImplementedError(kind)
    if k == "vec":
        x = np_eval(e.children[0], env)
        return x.T.reshape(-1, 1)
    if k == "rank1":
        a, u, v = (np_eval(c, env) for c in e.children)
        return a + u @ v.T
    if k == "solve":
        a, b = (np_eval(c, env) for c in e.children)
        return np.linalg.solve(a, b).astype(np.float32)
    if k == "inverse":
        return np.linalg.inv(np_eval(e.children[0], env)).astype(np.float32)
    if k == "select_value":
        x = np_eval(e.children[0], env)
        pred, fill = e.attrs["predicate"], e.attrs["fill"]
        return np.where(np.asarray(pred(x)), x, fill).astype(np.float32)
    if k == "join_index":
        a, b = (np_eval(c, env) for c in e.children)
        return np.asarray(_merge_of(e.attrs)(a, b), dtype=np.float32)
    if k == "join_value":
        a, b = (np_eval(c, env) for c in e.children)
        va = a.T.reshape(-1)
        vb = b.T.reshape(-1)
        pair = np.asarray(_merge_of(e.attrs)(va[:, None], vb[None, :]))
        if e.attrs["predicate"] is not None:
            kind = e.attrs.get("pred_kind")
            pred = _NP_PRED[kind] if kind else e.attrs["predicate"]
            mask = np.asarray(pred(va[:, None], vb[None, :]))
            pair = np.where(mask, pair, 0.0)
        return pair.astype(np.float32)
    if k == "select_index":
        x = np_eval(e.children[0], env).copy()
        rows, cols = e.attrs["rows"], e.attrs["cols"]
        if rows is not None:
            keep = np.asarray(rows(np.arange(x.shape[0])))
            x[~keep, :] = 0
        if cols is not None:
            keep = np.asarray(cols(np.arange(x.shape[1])))
            x[:, ~keep] = 0
        return x
    raise NotImplementedError(k)


def _rand_spec(rng, shape):
    """A random leaf PartitionSpec: canonical (None), 1D row/col over
    all devices, replicated, or a partial sharding. Size-1 dims stay
    canonical (they are never padded, so 1D specs cannot divide)."""
    if shape[0] <= 1 or shape[1] <= 1:
        return None
    pool = [None, P(("x", "y"), None), P(None, ("x", "y")),
            P(None, None), P("x", None), P(None, "y")]
    return pool[int(rng.integers(len(pool)))]


def gen_expr(rng, env, mesh, depth, shape=None, leaf_kinds=("dense",),
             dtype_pop=("float32",), structured_join=False,
             rand_specs=False):
    """Random expression with consistent shapes; fills env[uid] for leaves.
    ``leaf_kinds``: population for leaf flavors — "dense" (BlockMatrix),
    "sparse" (BlockSparseMatrix tile stack), "coo" (element-sparse plan);
    all three enter the same IR and must agree with the numpy oracle.
    ``dtype_pop``: device dtypes for dense leaves (the numpy oracle env
    always stores exact f32 — mixed-dtype callers compare dtypes, not
    numerics). ``structured_join``: use structured string merges for
    join_index (dtype-inferable) instead of a callable."""
    def sub(depth, shape):
        return gen_expr(rng, env, mesh, depth, shape, leaf_kinds, dtype_pop,
                        structured_join, rand_specs)

    def leaf_of(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        kind = str(rng.choice(leaf_kinds))
        if kind == "sparse":
            a = a * (rng.random(shape) < 0.6)
            from matrel_tpu_torch.core.sparse import BlockSparseMatrix
            node = BlockSparseMatrix.from_numpy(a, block_size=4,
                                                mesh=mesh).expr()
        elif kind == "coo":
            from matrel_tpu_torch.core.coo import COOMatrix
            a = a * (rng.random(shape) < 0.6)
            r, c = np.nonzero(a)
            node = COOMatrix.from_edges(r, c, a[r, c], shape=shape).expr()
        else:
            spec = _rand_spec(rng, shape) if rand_specs else None
            node = E.leaf(BlockMatrix.from_numpy(
                a, mesh=mesh, dtype=str(rng.choice(dtype_pop)),
                spec=spec))
        env[node.uid] = a
        return node

    dims = [1, 3, 5, 8, 13]
    if shape is None:
        shape = (int(rng.choice(dims[1:])), int(rng.choice(dims[1:])))
    if depth <= 0:
        return leaf_of(shape)
    choice = rng.choice(
        ["matmul", "elemwise", "scalar", "transpose", "agg_chain",
         "select", "select_value", "join_index", "join_value", "rank1",
         "solve", "gram", "leaf"])
    if choice == "gram" and shape[0] == shape[1]:
        # AᵀA / AAᵀ with a SHARED operand node: under
        # matmul_precision="high" the symmetric 2-pass lowering, under
        # other precisions the generic path
        k = int(rng.choice(dims[1:]))
        if rng.random() < 0.5:
            x = sub(depth - 1, (k, shape[0]))
            return E.matmul(E.transpose(x), x)
        x = sub(depth - 1, (shape[0], k))
        return E.matmul(x, E.transpose(x))
    if choice == "matmul":
        k = int(rng.choice(dims[1:]))
        a = sub(depth - 1, (shape[0], k))
        b = sub(depth - 1, (k, shape[1]))
        return E.matmul(a, b)
    if choice == "elemwise":
        op = str(rng.choice(["add", "sub", "mul"]))
        a = sub(depth - 1, shape)
        b = sub(depth - 1, shape)
        return E.elemwise(op, a, b)
    if choice == "scalar":
        op = str(rng.choice(["add", "mul"]))
        c = sub(depth - 1, shape)
        return E.scalar_op(op, c, float(rng.uniform(-2, 2)))
    if choice == "transpose":
        c = sub(depth - 1, (shape[1], shape[0]))
        return E.transpose(c)
    if choice == "agg_chain":
        # produce shape via aggregation of a larger operand when possible
        if shape[1] == 1 and shape[0] > 1:
            inner = sub(depth - 1, (shape[0], int(rng.choice(dims[1:]))))
            return E.agg(inner, "sum", "row")
        if shape == (1, 1):
            inner = sub(depth - 1, (int(rng.choice(dims[1:])),) * 2)
            return E.agg(inner, "sum", "all")
        return leaf_of(shape)
    if choice == "select":
        c = sub(depth - 1, shape)
        m = int(rng.integers(2, 5))
        return E.select_index(c, rows=lambda i, m=m: i % m != 0)
    if choice == "select_value":
        c = sub(depth - 1, shape)
        t = float(rng.uniform(-0.5, 0.5))
        return E.select_value(c, lambda v, t=t: v > t)
    if choice == "join_index":
        a = sub(depth - 1, shape)
        b = sub(depth - 1, shape)
        if structured_join:
            return E.join_on_index(
                a, b, str(rng.choice(["left", "right", "add", "mul"])))
        return E.join_on_index(a, b, lambda x, y: x * y + x)
    if choice == "join_value":
        # pair matrix shaped (s0, s1) from column-vector operands; a
        # parent agg triggers the streaming lowering, otherwise the
        # capped materialisation runs
        a = sub(depth - 1, (shape[0], 1))
        b = sub(depth - 1, (shape[1], 1))
        merge = str(rng.choice(["left", "right", "add", "mul"]))
        pred = str(rng.choice(["eq", "lt", "le", "gt", "ge"]))
        return E.join_on_value(a, b, merge, pred)
    if choice == "solve":
        # well-conditioned lhs: a random leaf shifted to diagonal
        # dominance, far from singularity across all seeds
        n = shape[0]
        m_np = rng.standard_normal((n, n)).astype(np.float32)
        m_np = (m_np @ m_np.T / n + 2.0 * np.eye(n, dtype=np.float32))
        node = E.leaf(BlockMatrix.from_numpy(
            m_np, mesh=mesh,
            spec=_rand_spec(rng, (n, n)) if rand_specs else None))
        env[node.uid] = m_np
        b = sub(depth - 1, shape)
        if rng.random() < 0.5:
            return E.solve(node, b)
        return E.matmul(E.inverse(node), b)   # the R7 fusion
    if choice == "rank1":
        a = sub(depth - 1, shape)
        u = sub(depth - 1, (shape[0], 1))
        v = sub(depth - 1, (shape[1], 1))
        return E.rank_one_update(a, u, v)
    return leaf_of(shape)
