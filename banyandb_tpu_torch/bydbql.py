"""BydbQL: the SQL-ish query language (pkg/bydbql analog).

Grammar (subset matching what the engines support; reference grammar at
pkg/bydbql/grammar.go, parser.go:67):

    SELECT <projection> FROM MEASURE <name> IN <group>
        [ TIME > <millis> AND TIME < <millis> | TIME BETWEEN a AND b ]
        [ WHERE <cond> (AND <cond>)* ]
        [ GROUP BY tag (, tag)* ]
        [ TOP <n> BY <field> [ASC|DESC] ]
        [ ORDER BY TIME [ASC|DESC] ]
        [ LIMIT <n> ] [ OFFSET <n> ]

    projection := * | item (, item)*
    item       := tag | field | fn '(' field ')' | PERCENTILE(field, q, ...)
    fn         := SUM | COUNT | MIN | MAX | MEAN | AVG
    cond       := name op literal | name IN (lit, ...) | name NOT IN (...)
    op         := = | != | < | <= | > | >=
    literal    := number | 'string' | $N   ($N binds params[N-1] —
                  prepared statements)

Hand-written tokenizer + recursive descent -> api.model.QueryRequest.
"""

from __future__ import annotations

import re
from typing import Optional

from banyandb_tpu_torch.api.model import (
    Aggregation,
    Condition,
    GroupBy,
    LogicalExpression,
    QueryRequest,
    TimeRange,
    Top,
)

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<num>-?\d+(?:\.\d+)?)
      | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
      | (?P<param>\$\d+)
      | (?P<op><=|>=|!=|=|<|>|\(|\)|,|\*)
      | (?P<word>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)

_AGG_FNS = {"sum", "count", "min", "max", "mean", "avg", "percentile"}


_DUR_UNITS = {
    "ms": 1,
    "s": 1000,
    "m": 60_000,
    "h": 3_600_000,
    "d": 86_400_000,
    "w": 604_800_000,
}
_DUR_PIECE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w)")


def _time_millis(v) -> int:
    """TIME bound literal -> epoch millis.

    Mirrors the reference transformer (pkg/bydbql/transformer.go:1362):
    int millis pass through; then RFC3339 absolute timestamps; then
    'now' and signed compound durations relative to now ('-2h',
    '-1h30m', '15m') per str2duration.
    """
    import datetime
    import time as _time

    try:
        return int(v)
    except (TypeError, ValueError):
        pass
    s = str(v).strip()
    low = s.lower()
    if low == "now":
        return int(_time.time() * 1000)
    sign, body = 1, s
    if s[:1] in "+-":
        sign, body = (-1 if s[0] == "-" else 1), s[1:]
    pieces = _DUR_PIECE.findall(body)
    if pieces and "".join(n + u for n, u in pieces) == body:
        delta = sum(float(n) * _DUR_UNITS[u] for n, u in pieces)
        return int(_time.time() * 1000) + sign * int(delta)
    try:
        dt = datetime.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError:
        raise QLError(
            f"bad time literal {s!r} (millis, RFC3339, 'now', or "
            "signed duration like '-1h30m')"
        ) from None
    if dt.tzinfo is None:
        # RFC3339 requires an offset; a naive literal would silently
        # bind to the server's local zone and differ per node
        raise QLError(f"time literal {s!r} needs a UTC offset (RFC3339)")
    return int(dt.timestamp() * 1000)


class QLError(ValueError):
    pass


def _tokenize(text: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise QLError(f"bad token at: {text[pos:pos+20]!r}")
            break
        pos = m.end()
        for kind in ("num", "str", "param", "op", "word"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens, params=()):
        self.toks = tokens
        self.i = 0
        self.params = list(params)

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        # bdlint: disable=wp-shared-state -- a _Parser is constructed per
        # parse() call and never escapes the call stack; every thread
        # cursors its own instance (declaration-based identity merges them)
        self.i += 1
        return t

    def expect_word(self, *words) -> str:
        kind, v = self.next()
        if kind != "word" or v.lower() not in words:
            raise QLError(f"expected {'/'.join(words).upper()}, got {v!r}")
        return v.lower()

    def accept_word(self, *words) -> Optional[str]:
        kind, v = self.peek()
        if kind == "word" and v.lower() in words:
            self.next()
            return v.lower()
        return None

    def expect_op(self, op: str):
        kind, v = self.next()
        if kind != "op" or v != op:
            raise QLError(f"expected {op!r}, got {v!r}")

    def literal(self):
        kind, v = self.next()
        if kind == "num":
            return float(v) if "." in v else int(v)
        if kind == "str":
            return v[1:-1].replace("\\'", "'").replace('\\"', '"')
        if kind == "param":
            # prepared-statement placeholder: $1-based index into params
            # (bydbql/v1 QueryRequest.params analog)
            idx = int(v[1:]) - 1
            if not (0 <= idx < len(self.params)):
                raise QLError(f"parameter {v} not bound ({len(self.params)} given)")
            return self.params[idx]
        if kind == "word":
            return v  # bare identifier treated as string literal
        raise QLError(f"expected literal, got {v!r}")


def parse(text: str, params=()) -> QueryRequest:
    return parse_with_catalog(text, params)[1]


def parse_with_catalog(text: str, params=()) -> tuple[str, QueryRequest]:
    """-> (catalog, request); catalog is measure|stream|trace|property.
    `params` bind $1..$n prepared-statement placeholders in literal
    positions (pkg/bydbql prepared statements analog)."""
    p = _Parser(_tokenize(text), params)
    p.expect_word("select")

    # ---- projection ----
    projections: list = []
    agg: Optional[Aggregation] = None
    if p.peek() == ("op", "*"):
        p.next()
    else:
        while True:
            kind, v = p.next()
            if kind != "word":
                raise QLError(f"bad projection item {v!r}")
            name = v
            if p.peek() == ("op", "(") and name.lower() in _AGG_FNS:
                p.next()
                field = p.next()[1]
                fn = "mean" if name.lower() == "avg" else name.lower()
                qs: list[float] = []
                while p.peek() == ("op", ","):
                    p.next()
                    qs.append(float(p.next()[1]))
                p.expect_op(")")
                if agg is not None:
                    raise QLError("only one aggregate per query")
                agg = Aggregation(fn, field, tuple(qs))
            else:
                projections.append(name)
            if p.peek() == ("op", ","):
                p.next()
                continue
            break

    p.expect_word("from")
    catalog = p.expect_word("measure", "stream", "trace", "property")
    name = p.next()[1]
    p.expect_word("in")
    group = p.next()[1]

    begin, end = 0, 2**62
    criteria = None
    group_by = None
    top = None
    limit, offset = 100, 0
    order_by_ts = ""
    order_by_tag, order_by_dir = "", "asc"

    def add_cond(c: Condition):
        nonlocal criteria
        criteria = c if criteria is None else LogicalExpression("and", criteria, c)

    while True:
        kw = p.accept_word(
            "time", "where", "group", "top", "order", "limit", "offset"
        )
        if kw is None:
            kind, v = p.peek()
            if kind == "eof":
                break
            raise QLError(f"unexpected {v!r}")
        if kw == "time":
            kind, op = p.next()
            if kind == "word" and op.lower() == "between":
                begin = _time_millis(p.literal())
                p.expect_word("and")
                end = _time_millis(p.literal()) + 1
            elif op in (">", ">="):
                begin = _time_millis(p.literal()) + (1 if op == ">" else 0)
                if p.accept_word("and"):
                    p.expect_word("time")
                    _, op2 = p.next()
                    if op2 not in ("<", "<="):
                        raise QLError("expected TIME < upper bound")
                    end = _time_millis(p.literal()) + (1 if op2 == "<=" else 0)
            elif op in ("<", "<="):
                end = _time_millis(p.literal()) + (1 if op == "<=" else 0)
            else:
                raise QLError(f"bad TIME operator {op!r}")
        elif kw == "where":
            # full boolean grammar: OR < AND < ( ... ) < condition
            def parse_cond():
                if p.peek() == ("op", "("):
                    p.next()
                    e = parse_or()
                    p.expect_op(")")
                    return e
                tag = p.next()[1]
                neg = p.accept_word("not")
                if neg and not (p.peek()[0] == "word" and p.peek()[1].lower() == "in"):
                    raise QLError("NOT must be followed by IN")
                if p.accept_word("in"):
                    p.expect_op("(")
                    vals = [p.literal()]
                    while p.peek() == ("op", ","):
                        p.next()
                        vals.append(p.literal())
                    p.expect_op(")")
                    return Condition(tag, "not_in" if neg else "in", vals)
                kind, op = p.next()
                opmap = {"=": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}
                if op not in opmap:
                    raise QLError(f"bad operator {op!r}")
                return Condition(tag, opmap[op], p.literal())

            def parse_and():
                left = parse_cond()
                while p.accept_word("and"):
                    left = LogicalExpression("and", left, parse_cond())
                return left

            def parse_or():
                left = parse_and()
                while p.accept_word("or"):
                    left = LogicalExpression("or", left, parse_and())
                return left

            add_cond(parse_or())
        elif kw == "group":
            p.expect_word("by")
            tags = [p.next()[1]]
            while p.peek() == ("op", ","):
                p.next()
                tags.append(p.next()[1])
            group_by = GroupBy(tuple(tags))
        elif kw == "top":
            n = int(p.next()[1])
            p.expect_word("by")
            field = p.next()[1]
            sort = p.accept_word("asc", "desc") or "desc"
            top = Top(n, field, sort)
        elif kw == "order":
            p.expect_word("by")
            target = p.next()[1]
            direction = p.accept_word("asc", "desc") or "asc"
            if target.lower() == "time":
                order_by_ts = direction
            else:  # order-by-index: sort rows by this tag's value
                order_by_tag = target
                order_by_dir = direction
        elif kw == "limit":
            limit = int(p.next()[1])
        elif kw == "offset":
            offset = int(p.next()[1])

    return catalog, QueryRequest(
        groups=(group,),
        name=name,
        time_range=TimeRange(begin, end),
        criteria=criteria,
        tag_projection=tuple(projections),
        field_projection=tuple(projections),
        group_by=group_by,
        agg=agg,
        top=top,
        limit=limit,
        offset=offset,
        order_by_ts=order_by_ts,
        order_by_tag=order_by_tag,
        order_by_dir=order_by_dir,
    )
