"""SQL-ish entry point over registered matrix tables — the counterpart
of ``matrel_tpu/sql.py``, with the same grammar: an expression language
over the session catalog, compiled to the same MatExpr IR as the DSL,
hence optimized and executed identically.

Grammar (Python-expression syntax, parsed via ``ast`` — no eval):
    SELECT <expr>
        [FROM t1, t2, ...]        -- restricts AND validates the visible
                                     tables against the session catalog
        [WHERE <pred over v>]     -- sugar for select(<expr>, "<pred>")
        [PRECISION '<sla>']       -- per-query accuracy SLA ("exact"/
                                     "high"/"fast"/explicit dtype) for
                                     precision-tiered execution
    <expr> :=
        A * B            matrix multiply        A + B | A - B  elementwise
        A .* B | A % B   element multiply       A / B          elementwise
        elemmin(A, B) | elemmax(A, B)           elementwise min/max
        2 * A | A * 2    scalar multiply        A + 2          scalar add
        transpose(A) | t(A)
        rowsum(e) colsum(e) sum(e) trace(e) vec(e)
        rowmax/rowmin/colmax/colmin/rowcount/rowavg/colcount/colavg(e)
        max/min/count/avg(e)                       global aggregates
        diagsum/diagmax/diagmin/diagcount/diagavg(e)   diagonal aggregates
        power(e, p)  norm(e [, "fro"|"l1"|"max"])
        rankone(a, u, v)   A + u·vᵀ (optimizer pushes through multiplies)
        select(e, "v > 0" [, fill])     σ on entry values
        selectrows(e, "i % 2 == 0")     σ on row index
        selectcols(e, "j < 4")          σ on col index
        selectblocks(e, "bi == bj", block_size)   σ on block index
        joinindex(a, b, "x * y")        ⋈ on index with merge expr
        joinrows(a, b, "x + y")         ⋈ on row index (pairwise cols)
        joincols(a, b, "x - y")         ⋈ on col index (pairwise rows)
            — index-join merges also accept the structured keywords
            ("left"/"right"/"add"/"mul"), which let the planner infer
            output dtypes
        joinvalue(a, b, <merge>, <pred>)   ⋈ on values; merge/pred are
            either structured keywords ("left"/"right"/"add"/"mul" and
            "eq"/"lt"/"le"/"gt"/"ge" — these stream under aggregates)
            or expression strings over (x, y)

Predicate / merge strings are tiny lambdas over (v) / (i) / (j) /
(bi, bj) / (x, y), parsed with the same restricted-ast machinery and
evaluated on torch tensors: ``%`` is floor modulo and ``/`` true
division, as in the JAX package; ``not``/``and``/``or`` are
``torch.logical_not``/``logical_and``/``logical_or``.
``A .* B`` is lexed (quote-aware) to ``A % B`` before parsing.
Malformed input of any kind raises SqlError.
"""

from __future__ import annotations

import ast
import hashlib
from typing import Any, Callable, Dict

import torch

from matrel_tpu_torch.ir import expr as E

_BINOPS = {
    ast.Add: "add", ast.Sub: "sub", ast.Div: "div",
}

_AGG_FNS = {
    "rowsum": ("sum", "row"), "colsum": ("sum", "col"),
    "sum": ("sum", "all"), "trace": ("sum", "diag"),
    "rowmax": ("max", "row"), "rowmin": ("min", "row"),
    "colmax": ("max", "col"), "colmin": ("min", "col"),
    "rowcount": ("count", "row"), "colcount": ("count", "col"),
    "rowavg": ("avg", "row"), "colavg": ("avg", "col"),
    # global + diagonal spellings: every executor kind×axis is reachable
    "max": ("max", "all"), "min": ("min", "all"),
    "count": ("count", "all"), "avg": ("avg", "all"),
    "diagsum": ("sum", "diag"),
    "diagmax": ("max", "diag"), "diagmin": ("min", "diag"),
    "diagcount": ("count", "diag"), "diagavg": ("avg", "diag"),
}


class SqlError(ValueError):
    pass


def _parse_eval(src: str, what: str) -> ast.Expression:
    """ast.parse(mode='eval') with SyntaxError mapped into SqlError."""
    try:
        return ast.parse(src, mode="eval")
    except SyntaxError as e:
        raise SqlError(f"malformed {what}: {src!r} ({e.msg})") from e


def _compile_lambda(src: str, argnames: tuple) -> Callable:
    """Compile a restricted arithmetic/comparison expression into a fn over
    torch tensors. Only names in ``argnames``, literals, arithmetic,
    comparisons, and boolean ops are allowed."""
    tree = _parse_eval(src, "predicate/merge expression")

    allowed = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Compare,
               ast.BoolOp, ast.Name, ast.Constant, ast.Load,
               ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
               ast.USub, ast.UAdd, ast.Not,
               ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
               ast.And, ast.Or)
    for node in ast.walk(tree):
        if not isinstance(node, allowed):
            raise SqlError(f"disallowed syntax in predicate: "
                           f"{type(node).__name__} in {src!r}")
        if isinstance(node, ast.Name) and node.id not in argnames:
            raise SqlError(f"unknown name {node.id!r} in predicate {src!r}; "
                           f"allowed: {argnames}")

    def fn(*args):
        env = dict(zip(argnames, args))

        def ev(n):
            if isinstance(n, ast.Expression):
                return ev(n.body)
            if isinstance(n, ast.Constant):
                return n.value
            if isinstance(n, ast.Name):
                return env[n.id]
            if isinstance(n, ast.UnaryOp):
                v = ev(n.operand)
                if isinstance(n.op, ast.USub):
                    return -v
                if isinstance(n.op, ast.UAdd):
                    return +v
                return torch.logical_not(torch.as_tensor(v))
            if isinstance(n, ast.BinOp):
                l, r = ev(n.left), ev(n.right)
                return {ast.Add: lambda: l + r, ast.Sub: lambda: l - r,
                        ast.Mult: lambda: l * r, ast.Div: lambda: l / r,
                        ast.Mod: lambda: l % r, ast.Pow: lambda: l ** r,
                        }[type(n.op)]()
            if isinstance(n, ast.Compare):
                l = ev(n.left)
                out = None
                for op, cmp in zip(n.ops, n.comparators):
                    r = ev(cmp)
                    res = {ast.Eq: lambda: l == r, ast.NotEq: lambda: l != r,
                           ast.Lt: lambda: l < r, ast.LtE: lambda: l <= r,
                           ast.Gt: lambda: l > r, ast.GtE: lambda: l >= r,
                           }[type(op)]()
                    out = res if out is None else torch.logical_and(
                        torch.as_tensor(out), torch.as_tensor(res))
                    l = r
                return out
            if isinstance(n, ast.BoolOp):
                vals = [ev(v) for v in n.values]
                acc = vals[0]
                for v in vals[1:]:
                    acc = (torch.logical_and(torch.as_tensor(acc),
                                             torch.as_tensor(v))
                           if isinstance(n.op, ast.And)
                           else torch.logical_or(torch.as_tensor(acc),
                                                 torch.as_tensor(v)))
                return acc
            raise SqlError(f"unhandled node {type(n).__name__}")

        return ev(tree)

    # the session plan cache keys callables by this tag: identical query
    # text compiles to a fresh fn each parse, but must HIT the cache,
    # while different predicate text must MISS it
    fn.__matrel_key__ = f"sql({','.join(argnames)}):{src}"
    return fn


class _Compiler(ast.NodeVisitor):
    def __init__(self, catalog: Dict[str, Any]):
        self.catalog = catalog

    def compile(self, src: str) -> E.MatExpr:
        tree = _parse_eval(src, "query expression")
        return self._expr(tree.body)

    def _expr(self, n: ast.AST):
        if isinstance(n, ast.Name):
            if n.id not in self.catalog:
                raise SqlError(f"unknown table {n.id!r}")
            return E.as_expr(self.catalog[n.id])
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return float(n.value)
        if isinstance(n, ast.BinOp):
            return self._binop(n)
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            v = self._expr(n.operand)
            if isinstance(v, float):
                return -v
            return v.multiply_scalar(-1.0)
        if isinstance(n, ast.Call):
            return self._call(n)
        raise SqlError(f"unsupported syntax: {type(n).__name__}")

    def _binop(self, n: ast.BinOp):
        l, r = self._expr(n.left), self._expr(n.right)
        scalar_l, scalar_r = isinstance(l, float), isinstance(r, float)
        if isinstance(n.op, ast.Mult):
            if scalar_l and scalar_r:
                return l * r
            if scalar_l:
                return r.multiply_scalar(l)
            if scalar_r:
                return l.multiply_scalar(r)
            return l.multiply(r)          # '*' between matrices = matmul
        if isinstance(n.op, ast.MatMult):
            return l.multiply(r)
        if isinstance(n.op, ast.Mod):
            # 'A .* B' lexes to 'A % B': element-wise multiply
            if scalar_l or scalar_r:
                raise SqlError(".* / % is matrix element-multiply; use "
                               "* for scalar multiply")
            return l.elem_multiply(r)
        if type(n.op) in _BINOPS:
            op = _BINOPS[type(n.op)]
            if scalar_r and op == "add":
                return l.add_scalar(r)
            if scalar_r and op == "sub":
                return l.add_scalar(-r)
            if scalar_r and op == "div":
                return l.multiply_scalar(1.0 / r)
            if scalar_l:
                raise SqlError("scalar on the left only supported for *")
            return E.elemwise(op, l, r)
        raise SqlError(f"unsupported operator {type(n.op).__name__}")

    def _call(self, n: ast.Call):
        name = n.func.id.lower() if isinstance(n.func, ast.Name) else None
        args = n.args
        if name in ("transpose", "t"):
            return self._expr(args[0]).t()
        if name in ("elemmult", "elemmul"):
            return self._expr(args[0]).elem_multiply(self._expr(args[1]))
        if name == "elemmin":
            return self._expr(args[0]).elem_min(self._expr(args[1]))
        if name == "elemmax":
            return self._expr(args[0]).elem_max(self._expr(args[1]))
        if name == "multiply":
            return self._expr(args[0]).multiply(self._expr(args[1]))
        if name == "add":
            return self._expr(args[0]).add(self._expr(args[1]))
        if name == "power":
            return self._expr(args[0]).power(self._lit(args[1]))
        if name == "vec":
            return self._expr(args[0]).vec()
        if name == "norm":
            kind = (self._str(args[1]) if len(args) > 1 else "fro")
            return self._expr(args[0]).norm(kind)
        if name in ("inverse", "inv"):
            return self._expr(args[0]).inverse()
        if name in ("rankone", "rankoneupdate"):
            return self._expr(args[0]).rank_one_update(
                self._expr(args[1]), self._expr(args[2]))
        if name == "solve":
            return self._expr(args[0]).solve(self._expr(args[1]))
        if name in _AGG_FNS:
            kind, axis = _AGG_FNS[name]
            return E.agg(self._expr(args[0]), kind, axis)
        if name == "select":
            pred = _compile_lambda(self._str(args[1]), ("v",))
            fill = self._lit(args[2]) if len(args) > 2 else 0.0
            return self._expr(args[0]).select_value(pred, fill=fill)
        if name == "selectrows":
            pred = _compile_lambda(self._str(args[1]), ("i",))
            return self._expr(args[0]).select_index(rows=pred)
        if name == "selectcols":
            pred = _compile_lambda(self._str(args[1]), ("j",))
            return self._expr(args[0]).select_index(cols=pred)
        if name == "joinindex":
            merge = self._merge_or_pred(args[2], E.JOIN_MERGES)
            return self._expr(args[0]).join_on_index(self._expr(args[1]), merge)
        if name in ("joinrows", "joincols"):
            from matrel_tpu_torch.relational import ops as R
            merge = self._merge_or_pred(args[2], E.JOIN_MERGES)
            join = (R.join_on_rows if name == "joinrows"
                    else R.join_on_cols)
            return join(self._expr(args[0]), self._expr(args[1]), merge)
        if name == "joinvalue":
            merge = self._merge_or_pred(args[2], E.JOIN_MERGES)
            pred = (self._merge_or_pred(args[3], E.JOIN_PREDS)
                    if len(args) > 3 else None)
            return self._expr(args[0]).join_on_value(
                self._expr(args[1]), merge, pred)
        if name == "selectblocks":
            from matrel_tpu_torch.relational import ops as R
            pred = _compile_lambda(self._str(args[1]), ("bi", "bj"))
            bs = int(self._lit(args[2])) if len(args) > 2 else None
            return R.select_blocks(self._expr(args[0]), pred,
                                   block_size=bs)
        raise SqlError(f"unknown function {name!r}")

    def _merge_or_pred(self, node, keywords):
        """Merge/predicate argument of ANY join function (joinvalue's
        merge+pred, and the merges of joinindex/joinrows/joincols): a
        structured keyword string (streams under aggregates; gives the
        planner dtype inference) or an (x, y) expression string."""
        s = self._str(node)
        if s in keywords:
            return s
        return _compile_lambda(s, ("x", "y"))

    @staticmethod
    def _str(node) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        raise SqlError("expected a string literal")

    @staticmethod
    def _lit(node) -> float:
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return float(node.value)
        if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
                and isinstance(node.operand, ast.Constant)):
            return -float(node.operand.value)
        raise SqlError("expected a numeric literal")


def _float_dot(q: str, i: int) -> bool:
    """Is the dot at q[i] part of a float literal (``2.*A`` = 2.0 * A)?
    Only when the preceding digit run is a NUMBER, not the tail of an
    identifier: ``t1.*t2`` is table t1 elem-multiplied by t2."""
    j = i
    while j > 0 and q[j - 1].isdigit():
        j -= 1
    if j == i:            # no digits before the dot
        return False
    return j == 0 or not (q[j - 1].isalpha() or q[j - 1] == "_")


def _lex_elemmul(q: str) -> str:
    """Replace the documented ``.*`` element-multiply token with ``%``
    outside string literals (quote-aware; string predicates keep their
    characters untouched)."""
    out = []
    quote = None
    i = 0
    while i < len(q):
        ch = q[i]
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            out.append(ch)
        elif (ch == "." and i + 1 < len(q) and q[i + 1] == "*"
                and not _float_dot(q, i)):
            out.append(" % ")
            i += 1
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def _find_keyword(q: str, kw: str) -> int:
    """Start index of a word-boundary keyword OUTSIDE string literals,
    or -1. Quoted predicates containing the word are skipped."""
    quote = None
    n, k = len(q), len(kw)
    for i, ch in enumerate(q):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
            continue
        if (q[i:i + k].lower() == kw
                and (i == 0 or not (q[i - 1].isalnum()
                                    or q[i - 1] == "_"))
                and (i + k >= n or not (q[i + k].isalnum()
                                        or q[i + k] == "_"))):
            return i
    return -1


def parse_sql(query: str, session) -> E.MatExpr:
    """Compile a SQL-ish query against the session catalog into a
    MatExpr. FROM names are validated against the catalog AND restrict
    the tables visible to the body; WHERE is sugar for a value
    selection on the result."""
    q = query.strip()
    while q.endswith(";"):
        q = q[:-1].rstrip()
    # the SELECT keyword needs trailing whitespace — 'select(...)' (no
    # space) is the σ FUNCTION, not the keyword
    if q[:6].lower() == "select" and len(q) > 6 and q[6].isspace():
        q = q[6:].strip()
    q = _lex_elemmul(q)
    # trailing PRECISION '<sla>' clause — the SQL face of the per-query
    # accuracy SLA (compute's precision= argument): stripped FIRST since
    # it follows WHERE in the statement. Quoted or bare spellings both
    # accepted.
    prec_sla = None
    pi = _find_keyword(q, "precision")
    if pi >= 0:
        prec_src = q[pi + len("precision"):].strip()
        if prec_src[:1] in "'\"" and prec_src[:1] == prec_src[-1:] \
                and len(prec_src) >= 2:
            prec_src = prec_src[1:-1].strip()
        if not prec_src:
            raise SqlError("PRECISION requires an SLA value "
                           "('exact'/'high'/'fast'/explicit dtype)")
        from matrel_tpu_torch.config import normalize_sla
        try:
            prec_sla = normalize_sla(prec_src)
        except ValueError as ex:
            raise SqlError(str(ex)) from ex
        q = q[:pi]
    where_src = None
    wi = _find_keyword(q, "where")
    if wi >= 0:
        where_src = q[wi + 5:].strip()
        if not where_src:
            raise SqlError("WHERE requires a predicate over v")
        q = q[:wi]
    fi = _find_keyword(q, "from")
    catalog = dict(session.catalog)
    if fi >= 0:
        names = [t.strip() for t in q[fi + 4:].split(",") if t.strip()]
        q = q[:fi]
        if not names:
            raise SqlError("FROM requires at least one table name")
        for t in names:
            if not t.isidentifier():
                raise SqlError(f"bad table name in FROM: {t!r}")
        unknown = sorted(t for t in names if t not in catalog)
        if unknown:
            raise SqlError(
                f"unknown table(s) in FROM: {unknown}; the session "
                f"catalog has {sorted(catalog)}")
        catalog = {t: catalog[t] for t in names}
    expr = _Compiler(catalog).compile(q.strip())
    if where_src is not None:
        expr = expr.select_value(_compile_lambda(where_src, ("v",)))
    # stamp the query-text fingerprint out of band (an attrs entry would
    # flow into the plan-cache key and split the cache between SQL- and
    # DSL-built identical plans). Scalar-only queries ("2 * 3") compile
    # to a plain number: nothing to stamp there.
    if isinstance(expr, E.MatExpr):
        object.__setattr__(
            expr, "_sql_hash",
            hashlib.sha1(query.strip().encode()).hexdigest()[:16])
        if prec_sla is not None:
            # out-of-band like _sql_hash: session._resolve_sla reads it
            # (an explicit compute(precision=...) argument still wins)
            # and applies the tier-isolating cache prefix
            object.__setattr__(expr, "_sql_precision", prec_sla)
    return expr
