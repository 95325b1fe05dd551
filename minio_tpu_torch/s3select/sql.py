"""SQL parser + evaluator for S3 Select (pkg/s3select/sql/ in the
reference - participle grammar + evaluator; here a recursive-descent
parser over the same language subset).

Supported: SELECT projections (*, columns, expressions, aggregates,
aliases), FROM S3Object [alias], WHERE, LIMIT; operators AND OR NOT,
comparisons, BETWEEN, IN, LIKE, IS [NOT] NULL/MISSING; arithmetic
+ - * / %; functions CAST, COUNT, SUM, MIN, MAX, AVG, COALESCE, NULLIF,
LOWER, UPPER, CHAR_LENGTH/CHARACTER_LENGTH, TRIM, SUBSTRING,
UTCNOW is intentionally absent (no wall-clock inside the evaluator).

Values are dynamically typed: str | int | float | bool | None, with
``MISSING`` as a distinct sentinel (absent column vs SQL NULL), matching
the reference's value system (pkg/s3select/sql/value.go).
"""

from __future__ import annotations

import re


class SQLError(Exception):
    """Parse or evaluation failure; carries an S3 error code."""

    def __init__(self, message: str, code: str = "ParseSelectFailure"):
        super().__init__(message)
        self.code = code


class _Missing:
    __slots__ = ()

    def __repr__(self):
        return "MISSING"

    def __bool__(self):
        return False


MISSING = _Missing()

# -- lexer ---------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><>|!=|<=|>=|\|\||[=<>\(\)\*,\.\+\-/%])
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "limit", "as", "and", "or", "not",
    "between", "in", "like", "escape", "is", "null", "missing", "true",
    "false", "cast",
}


class _Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value):
        self.kind = kind  # number|string|ident|qident|op|kw|eof
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


def _lex(text: str) -> "list[_Token]":
    out: list[_Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SQLError(f"bad character {text[pos]!r} at {pos}", "LexerInvalidChar")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "number":
            out.append(
                _Token("number", float(val) if "." in val or "e" in val
                       or "E" in val else int(val))
            )
        elif kind == "string":
            out.append(_Token("string", val[1:-1].replace("''", "'")))
        elif kind == "qident":
            out.append(_Token("qident", val[1:-1].replace('""', '"')))
        elif kind == "ident":
            low = val.lower()
            if low in _KEYWORDS:
                out.append(_Token("kw", low))
            else:
                out.append(_Token("ident", val))
        else:
            out.append(_Token("op", val))
    out.append(_Token("eof", None))
    return out


# -- AST -----------------------------------------------------------------


class Expr:
    def eval(self, row: dict):  # noqa: D102
        raise NotImplementedError

    def walk(self):
        yield self


class Literal(Expr):
    def __init__(self, value):
        self.value = value

    def eval(self, row):
        return self.value


class Column(Expr):
    """Column reference: name, _N positional, or * (in COUNT)."""

    def __init__(self, name: str):
        self.name = name

    def eval(self, row):
        if self.name in row:
            return row[self.name]
        # case-insensitive fallback (CSV headers are case-preserving
        # but references are case-insensitive in the reference's sql)
        low = self.name.lower()
        for k, v in row.items():
            if k.lower() == low:
                return v
        return MISSING


def _num(v):
    """Coerce to a number for arithmetic/comparison, or None."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                return None
    return None


def _is_null(v) -> bool:
    return v is None or v is MISSING


class Arith(Expr):
    def __init__(self, op, left, right):
        self.op, self.left, self.right = op, left, right

    def eval(self, row):
        a, b = self.left.eval(row), self.right.eval(row)
        if _is_null(a) or _is_null(b):
            return None
        if self.op == "||":
            return _to_str(a) + _to_str(b)
        na, nb = _num(a), _num(b)
        if na is None or nb is None:
            raise SQLError(
                f"non-numeric operand for {self.op}", "InvalidDataType"
            )
        if self.op == "+":
            return na + nb
        if self.op == "-":
            return na - nb
        if self.op == "*":
            return na * nb
        if self.op == "/":
            if nb == 0:
                raise SQLError("division by zero", "InvalidDataType")
            r = na / nb
            return r
        if self.op == "%":
            if nb == 0:
                raise SQLError("modulo by zero", "InvalidDataType")
            return na % nb
        raise SQLError(f"unknown operator {self.op}", "ParseUnknownOperator")

    def walk(self):
        yield self
        yield from self.left.walk()
        yield from self.right.walk()


def _compare(op: str, a, b):
    if _is_null(a) or _is_null(b):
        return None  # SQL three-valued logic
    # numeric comparison when both sides coerce; else string compare
    na, nb = _num(a), _num(b)
    if na is not None and nb is not None and not (
        isinstance(a, str) and isinstance(b, str)
    ):
        a, b = na, nb
    else:
        a, b = _to_str(a), _to_str(b)
    try:
        if op == "=":
            return a == b
        if op in ("!=", "<>"):
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    except TypeError:
        return False
    raise SQLError(f"unknown comparison {op}", "ParseUnknownOperator")


class Compare(Expr):
    def __init__(self, op, left, right):
        self.op, self.left, self.right = op, left, right

    def eval(self, row):
        return _compare(self.op, self.left.eval(row), self.right.eval(row))

    def walk(self):
        yield self
        yield from self.left.walk()
        yield from self.right.walk()


class Between(Expr):
    def __init__(self, expr, lo, hi, negate):
        self.expr, self.lo, self.hi, self.negate = expr, lo, hi, negate

    def eval(self, row):
        v = self.expr.eval(row)
        lo = _compare(">=", v, self.lo.eval(row))
        hi = _compare("<=", v, self.hi.eval(row))
        if lo is None or hi is None:
            return None
        r = lo and hi
        return (not r) if self.negate else r

    def walk(self):
        yield self
        for e in (self.expr, self.lo, self.hi):
            yield from e.walk()


class In(Expr):
    def __init__(self, expr, options, negate):
        self.expr, self.options, self.negate = expr, options, negate

    def eval(self, row):
        v = self.expr.eval(row)
        if _is_null(v):
            return None
        hit = any(
            _compare("=", v, o.eval(row)) is True for o in self.options
        )
        return (not hit) if self.negate else hit

    def walk(self):
        yield self
        yield from self.expr.walk()
        for o in self.options:
            yield from o.walk()


class Like(Expr):
    def __init__(self, expr, pattern, escape, negate):
        self.expr, self.pattern = expr, pattern
        self.escape, self.negate = escape, negate
        # literal pattern/escape (the common case): compile ONCE, not
        # per row on the scan hot path
        self._compiled = None
        if isinstance(pattern, Literal) and (
            escape is None or isinstance(escape, Literal)
        ):
            esc = None
            if escape is not None and not _is_null(escape.value):
                esc = _to_str(escape.value)
            if not _is_null(pattern.value):
                self._compiled = self._regex(_to_str(pattern.value), esc)

    def _regex(self, pat: str, esc: "str | None"):
        out = []
        i = 0
        while i < len(pat):
            c = pat[i]
            if esc and c == esc and i + 1 < len(pat):
                out.append(re.escape(pat[i + 1]))
                i += 2
                continue
            if c == "%":
                out.append(".*")
            elif c == "_":
                out.append(".")
            else:
                out.append(re.escape(c))
            i += 1
        return re.compile("^" + "".join(out) + "$", re.DOTALL)

    def eval(self, row):
        v = self.expr.eval(row)
        if _is_null(v):
            return None
        if self._compiled is not None:
            rx = self._compiled
        else:
            p = self.pattern.eval(row)
            if _is_null(p):
                return None
            esc = None
            if self.escape is not None:
                e = self.escape.eval(row)
                if not _is_null(e):
                    esc = _to_str(e)
            rx = self._regex(_to_str(p), esc)
        hit = bool(rx.match(_to_str(v)))
        return (not hit) if self.negate else hit

    def walk(self):
        yield self
        yield from self.expr.walk()
        yield from self.pattern.walk()


class IsNull(Expr):
    def __init__(self, expr, negate, missing_only=False):
        self.expr, self.negate = expr, negate
        self.missing_only = missing_only

    def eval(self, row):
        v = self.expr.eval(row)
        hit = v is MISSING if self.missing_only else _is_null(v)
        return (not hit) if self.negate else hit

    def walk(self):
        yield self
        yield from self.expr.walk()


class Logical(Expr):
    def __init__(self, op, left, right=None):
        self.op, self.left, self.right = op, left, right

    def eval(self, row):
        if self.op == "not":
            v = self.left.eval(row)
            return None if v is None else not _truthy(v)
        a = self.left.eval(row)
        if self.op == "and":
            if a is not None and not _truthy(a):
                return False
            b = self.right.eval(row)
            if b is not None and not _truthy(b):
                return False
            return None if (a is None or b is None) else True
        if self.op == "or":
            if a is not None and _truthy(a):
                return True
            b = self.right.eval(row)
            if b is not None and _truthy(b):
                return True
            return None if (a is None or b is None) else False
        raise SQLError(f"unknown logical {self.op}", "ParseUnknownOperator")

    def walk(self):
        yield self
        yield from self.left.walk()
        if self.right is not None:
            yield from self.right.walk()


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.lower() == "true"
    return bool(v)


def _to_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None or v is MISSING:
        return ""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


_AGGREGATES = {"count", "sum", "min", "max", "avg"}

_SCALAR_FUNCS = {
    "lower", "upper", "char_length", "character_length", "trim",
    "substring", "coalesce", "nullif", "abs", "float", "integer",
    "string", "to_string",
}


class Call(Expr):
    """Scalar function call."""

    def __init__(self, name: str, args: "list[Expr]"):
        self.name, self.args = name.lower(), args

    def eval(self, row):
        n = self.name
        args = self.args
        if n == "coalesce":
            for a in args:
                v = a.eval(row)
                if not _is_null(v):
                    return v
            return None
        if n == "nullif":
            a, b = args[0].eval(row), args[1].eval(row)
            return None if _compare("=", a, b) is True else a
        vals = [a.eval(row) for a in args]
        if any(_is_null(v) for v in vals):
            return None
        if n == "lower":
            return _to_str(vals[0]).lower()
        if n == "upper":
            return _to_str(vals[0]).upper()
        if n in ("char_length", "character_length"):
            return len(_to_str(vals[0]))
        if n == "trim":
            return _to_str(vals[0]).strip()
        if n == "abs":
            x = _num(vals[0])
            if x is None:
                raise SQLError("ABS needs a number", "InvalidDataType")
            return abs(x)
        if n == "substring":
            s = _to_str(vals[0])
            start = int(_num(vals[1]) or 1)
            # SQL is 1-based; negative/zero clamp like the reference
            begin = max(start - 1, 0)
            if len(vals) > 2:
                length = int(_num(vals[2]) or 0)
                end = max(start - 1 + length, begin)
                return s[begin:end]
            return s[begin:]
        raise SQLError(f"unsupported function {n}", "UnsupportedFunction")

    def walk(self):
        yield self
        for a in self.args:
            yield from a.walk()


class Cast(Expr):
    def __init__(self, expr, type_name: str):
        self.expr, self.type_name = expr, type_name.lower()

    def eval(self, row):
        v = self.expr.eval(row)
        if _is_null(v):
            return None
        t = self.type_name
        try:
            if t in ("int", "integer", "bigint", "smallint"):
                return int(float(v)) if not isinstance(v, bool) else int(v)
            if t in ("float", "double", "decimal", "numeric", "real"):
                return float(v)
            if t in ("string", "varchar", "char", "text"):
                return _to_str(v)
            if t in ("bool", "boolean"):
                if isinstance(v, str):
                    return v.lower() == "true"
                return bool(v)
        except (ValueError, TypeError):
            raise SQLError(
                f"cannot cast {v!r} to {t}", "InvalidDataType"
            ) from None
        raise SQLError(f"unknown CAST type {t}", "UnsupportedFunction")

    def walk(self):
        yield self
        yield from self.expr.walk()


class Aggregate(Expr):
    """COUNT/SUM/MIN/MAX/AVG accumulator node.  ``eval`` accumulates
    per-row; ``result`` reads the final value."""

    def __init__(self, func: str, arg: "Expr | None"):
        self.func = func
        self.arg = arg  # None for COUNT(*)
        self.count = 0
        self.acc = None

    def eval(self, row):
        if self.func == "count":
            if self.arg is None or not _is_null(self.arg.eval(row)):
                self.count += 1
            return None
        v = self.arg.eval(row)
        if _is_null(v):
            return None
        n = _num(v)
        if n is None:
            raise SQLError(
                f"{self.func.upper()} over non-numeric value",
                "InvalidDataType",
            )
        self.count += 1
        if self.acc is None:
            self.acc = n
        elif self.func == "sum" or self.func == "avg":
            self.acc += n
        elif self.func == "min":
            self.acc = min(self.acc, n)
        elif self.func == "max":
            self.acc = max(self.acc, n)
        return None

    def result(self):
        if self.func == "count":
            return self.count
        if self.acc is None:
            return None
        if self.func == "avg":
            return self.acc / self.count
        return self.acc

    def walk(self):
        yield self
        if self.arg is not None:
            yield from self.arg.walk()


# -- parser --------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: "list[_Token]"):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> _Token:
        return self.toks[self.pos]

    def next(self) -> _Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect_kw(self, kw: str):
        t = self.next()
        if t.kind != "kw" or t.value != kw:
            raise SQLError(f"expected {kw.upper()}, got {t.value!r}", "ParseExpectedKeyword")

    def accept_kw(self, kw: str) -> bool:
        t = self.peek()
        if t.kind == "kw" and t.value == kw:
            self.pos += 1
            return True
        return False

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == op:
            self.pos += 1
            return True
        return False

    # expression grammar: or_expr
    def parse_expr(self) -> Expr:
        return self._or()

    def _or(self) -> Expr:
        left = self._and()
        while self.accept_kw("or"):
            left = Logical("or", left, self._and())
        return left

    def _and(self) -> Expr:
        left = self._not()
        while self.accept_kw("and"):
            left = Logical("and", left, self._not())
        return left

    def _not(self) -> Expr:
        if self.accept_kw("not"):
            return Logical("not", self._not())
        return self._predicate()

    def _predicate(self) -> Expr:
        left = self._additive()
        t = self.peek()
        negate = False
        if t.kind == "kw" and t.value == "not":
            nxt = self.toks[self.pos + 1]
            if nxt.kind == "kw" and nxt.value in ("between", "in", "like"):
                self.pos += 1
                negate = True
                t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.pos += 1
            return Compare(t.value, left, self._additive())
        if t.kind == "kw" and t.value == "between":
            self.pos += 1
            lo = self._additive()
            self.expect_kw("and")
            return Between(left, lo, self._additive(), negate)
        if t.kind == "kw" and t.value == "in":
            self.pos += 1
            if not self.accept_op("("):
                raise SQLError("expected ( after IN", "ParseExpectedTokenType")
            opts = [self.parse_expr()]
            while self.accept_op(","):
                opts.append(self.parse_expr())
            if not self.accept_op(")"):
                raise SQLError("expected ) after IN list", "ParseExpectedTokenType")
            return In(left, opts, negate)
        if t.kind == "kw" and t.value == "like":
            self.pos += 1
            pattern = self._additive()
            escape = None
            if self.accept_kw("escape"):
                escape = self._additive()
            return Like(left, pattern, escape, negate)
        if t.kind == "kw" and t.value == "is":
            self.pos += 1
            neg = self.accept_kw("not")
            if self.accept_kw("null"):
                return IsNull(left, neg)
            if self.accept_kw("missing"):
                return IsNull(left, neg, missing_only=True)
            raise SQLError("expected NULL or MISSING after IS", "ParseExpectedKeyword")
        return left

    def _additive(self) -> Expr:
        left = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.pos += 1
                left = Arith(t.value, left, self._multiplicative())
            else:
                return left

    def _multiplicative(self) -> Expr:
        left = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.pos += 1
                left = Arith(t.value, left, self._unary())
            else:
                return left

    def _unary(self) -> Expr:
        if self.accept_op("-"):
            return Arith("-", Literal(0), self._unary())
        if self.accept_op("+"):
            return self._unary()
        return self._primary()

    def _primary(self) -> Expr:
        t = self.next()
        if t.kind == "number":
            return Literal(t.value)
        if t.kind == "string":
            return Literal(t.value)
        if t.kind == "kw" and t.value == "true":
            return Literal(True)
        if t.kind == "kw" and t.value == "false":
            return Literal(False)
        if t.kind == "kw" and t.value == "null":
            return Literal(None)
        if t.kind == "kw" and t.value == "cast":
            if not self.accept_op("("):
                raise SQLError("expected ( after CAST", "ParseExpectedLeftParenAfterCast")
            e = self.parse_expr()
            self.expect_kw("as")
            tt = self.next()
            if tt.kind not in ("ident", "kw"):
                raise SQLError("expected type name in CAST", "ParseExpectedTypeName")
            if not self.accept_op(")"):
                raise SQLError("expected ) after CAST", "ParseCastArity")
            return Cast(e, str(tt.value))
        if t.kind == "op" and t.value == "(":
            e = self.parse_expr()
            if not self.accept_op(")"):
                raise SQLError("missing )", "ParseExpectedTokenType")
            return e
        if t.kind in ("ident", "qident"):
            name = t.value
            low = name.lower() if t.kind == "ident" else None
            # function call?
            if self.peek().kind == "op" and self.peek().value == "(":
                self.pos += 1
                if low in _AGGREGATES:
                    if self.accept_op("*"):
                        arg = None
                    else:
                        arg = self.parse_expr()
                    if not self.accept_op(")"):
                        raise SQLError("missing ) in aggregate", "ParseExpectedTokenType")
                    if low != "count" and arg is None:
                        raise SQLError(f"{low.upper()} needs an argument", "EvaluatorInvalidArguments")
                    return Aggregate(low, arg)
                args: list[Expr] = []
                if not self.accept_op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                    if not self.accept_op(")"):
                        raise SQLError("missing ) in call", "ParseExpectedTokenType")
                if low not in _SCALAR_FUNCS:
                    raise SQLError(
                        f"unsupported function {name}",
                        "UnsupportedFunction",
                    )
                return Call(low, args)
            # column path: alias.column / alias."column" / _N
            parts = [name]
            while self.accept_op("."):
                nt = self.next()
                if nt.kind not in ("ident", "qident"):
                    raise SQLError("bad column path", "InvalidKeyPath")
                parts.append(nt.value)
            return Column(".".join(parts))
        raise SQLError(f"unexpected token {t.value!r}", "ParseUnexpectedToken")


class Projection:
    def __init__(self, expr: Expr, alias: str):
        self.expr = expr
        self.alias = alias


class SelectStatement:
    """Parsed SELECT, ready to stream rows through."""

    def __init__(
        self,
        projections: "list[Projection] | None",  # None = SELECT *
        where: "Expr | None",
        limit: "int | None",
        table_alias: str,
    ):
        self.projections = projections
        self.where = where
        self.limit = limit
        self.table_alias = table_alias
        self.aggregates: list[Aggregate] = []
        if projections:
            for p in projections:
                self.aggregates.extend(
                    n for n in p.expr.walk() if isinstance(n, Aggregate)
                )
            if self.aggregates and any(
                not any(isinstance(n, Aggregate) for n in p.expr.walk())
                for p in projections
            ):
                raise SQLError(
                    "cannot mix aggregate and row projections",
                    "UnsupportedSqlStructure",
                )

    @property
    def is_aggregate(self) -> bool:
        return bool(self.aggregates)

    def normalize_column(self, name: str) -> str:
        """Strip the table alias prefix from a column path."""
        alias = self.table_alias
        if alias and name.lower().startswith(alias.lower() + "."):
            return name[len(alias) + 1:]
        if name.lower().startswith("s3object."):
            return name[len("s3object."):]
        return name

    def bind(self) -> None:
        """Rewrite Column names to strip table aliases (done once)."""
        nodes = []
        if self.projections:
            for p in self.projections:
                nodes.extend(p.expr.walk())
        if self.where is not None:
            nodes.extend(self.where.walk())
        for n in nodes:
            if isinstance(n, Column):
                n.name = self.normalize_column(n.name)

    # -- row pipeline --------------------------------------------------

    def matches(self, row: dict) -> bool:
        if self.where is None:
            return True
        v = self.where.eval(row)
        return v is True or (not isinstance(v, (bool, type(None))) and _truthy(v))

    def project(self, row: dict) -> "dict | None":
        """Output record for a matching row (non-aggregate queries)."""
        if self.projections is None:
            return row
        out = {}
        for i, p in enumerate(self.projections):
            out[p.alias or f"_{i + 1}"] = p.expr.eval(row)
        return out

    def accumulate(self, row: dict) -> None:
        for p in self.projections or []:
            p.expr.eval(row)

    def aggregate_result(self) -> dict:
        out = {}
        for i, p in enumerate(self.projections or []):
            # replace every Aggregate node with its final value, then
            # evaluate whatever expression wraps it (CAST, COALESCE,
            # arithmetic over aggregates, ...)
            out[p.alias or f"_{i + 1}"] = _resolve_aggregates(
                p.expr
            ).eval({})
        return out


def _resolve_aggregates(node: Expr) -> Expr:
    """Rewrite Aggregate nodes into Literals of their final results so
    the surrounding expression evaluates normally.  Runs once, after
    the scan, so mutating the tree in place is safe."""
    if isinstance(node, Aggregate):
        return Literal(node.result())
    for attr in ("left", "right", "expr", "lo", "hi", "pattern", "escape"):
        child = getattr(node, attr, None)
        if isinstance(child, Expr):
            setattr(node, attr, _resolve_aggregates(child))
    if isinstance(node, Call):
        node.args = [_resolve_aggregates(a) for a in node.args]
    if isinstance(node, In):
        node.options = [_resolve_aggregates(o) for o in node.options]
    return node


def parse(expression: str) -> SelectStatement:
    """Parse a full S3 Select statement."""
    toks = _lex(expression)
    p = _Parser(toks)
    p.expect_kw("select")
    projections: "list[Projection] | None"
    if p.accept_op("*"):
        projections = None
    else:
        projections = []
        while True:
            e = p.parse_expr()
            alias = ""
            if p.accept_kw("as"):
                t = p.next()
                if t.kind not in ("ident", "qident"):
                    raise SQLError("bad alias", "ParseExpectedIdentForAlias")
                alias = t.value
            elif p.peek().kind in ("ident", "qident"):
                alias = p.next().value
            if not alias and isinstance(e, Column):
                alias = e.name.rpartition(".")[2]
            projections.append(Projection(e, alias))
            if not p.accept_op(","):
                break
    p.expect_kw("from")
    # FROM S3Object[.path] [[AS] alias]
    t = p.next()
    if t.kind not in ("ident", "qident") or t.value.lower() not in (
        "s3object",
    ):
        raise SQLError(
            "FROM must name S3Object", "InvalidDataSource"
        )
    while p.accept_op("."):
        step = p.next()  # json path steps on the table: accepted, ignored
        if step.kind not in ("ident", "qident"):
            raise SQLError("bad table path after FROM S3Object.", "InvalidKeyPath")
    table_alias = ""
    if p.accept_kw("as"):
        at = p.next()
        if at.kind not in ("ident", "qident"):
            raise SQLError("bad table alias", "InvalidTableAlias")
        table_alias = at.value
    elif p.peek().kind == "ident":
        table_alias = p.next().value
    where = None
    if p.accept_kw("where"):
        where = p.parse_expr()
    limit = None
    if p.accept_kw("limit"):
        lt = p.next()
        if lt.kind != "number" or not isinstance(lt.value, int):
            raise SQLError("LIMIT needs an integer", "ParseExpectedNumber")
        limit = lt.value
    if p.peek().kind != "eof":
        raise SQLError(f"trailing tokens at {p.peek().value!r}", "ParseUnexpectedToken")
    stmt = SelectStatement(projections, where, limit, table_alias)
    stmt.bind()
    return stmt


def to_output(v) -> str:
    """Serialize one value for CSV output."""
    return _to_str(v)


def to_json_value(v):
    if v is MISSING:
        return None
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v
