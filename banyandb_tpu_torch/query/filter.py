"""Shared host-side predicate evaluation over dictionary-coded sources.

One implementation of the tag-predicate semantics used by every raw
(row-retrieval) path — measure._raw_rows, stream scans — so the code
conventions (-1 = literal not in dictionary, -2 = column absent from the
source) cannot drift between engines.  The device aggregate path encodes
the same semantics in measure_exec's kernel lowering.
"""

from __future__ import annotations

import numpy as np

from banyandb_tpu_torch.api.model import Condition
from banyandb_tpu_torch.api.schema import TagType
from banyandb_tpu_torch.storage.part import ColumnData


def tag_value_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, int):
        return v.to_bytes(8, "little", signed=True)
    raise TypeError(f"unsupported tag literal {type(v)}")


def decode_tag_value(raw: bytes, tag_type: TagType):
    if tag_type == TagType.INT:
        return int.from_bytes(raw, "little", signed=True) if raw else 0
    if tag_type == TagType.STRING:
        return raw.decode(errors="replace")
    return raw


_RANGE_OPS = {"lt", "le", "gt", "ge"}

_WORD_RE = __import__("re").compile(r"[0-9A-Za-z]+")


def analyze(analyzer: str, text: str) -> set[str]:
    """Tokenize per the reference's index-rule analyzers (bluge analogs,
    pkg/index/analyzer): url/simple/standard split on non-alphanumerics
    and lowercase; keyword keeps the whole string as one term."""
    if analyzer == "keyword":
        return {text}
    return {t.lower() for t in _WORD_RE.findall(text)}


def range_lut(op: str, literal, values: list, tag_type=None) -> np.ndarray:
    """bool LUT over DISTINCT dictionary values for a range predicate:
    numeric compare for int literals (INT tags store int64 LE; a numeric
    literal against a non-INT tag is a schema error), bytes-lexicographic
    for strings.  Shared by the host row path and the device kernel's
    LUT lowering so the two cannot drift."""
    import operator

    opf = {
        "lt": operator.lt, "le": operator.le,
        "gt": operator.gt, "ge": operator.ge,
    }[op]
    if isinstance(literal, int) and not isinstance(literal, bool):
        if tag_type is not None and tag_type != TagType.INT:
            raise TypeError(f"numeric range op {op} on non-INT tag")
        dec: list = [
            int.from_bytes(v, "little", signed=True) if v else 0
            for v in values
        ]
        lit = literal
    else:
        dec = values
        lit = tag_value_bytes(literal)
    return np.fromiter(
        (opf(x, lit) for x in dec), dtype=bool, count=len(dec)
    )


def match_lut(c: Condition, analyzers, values: list) -> np.ndarray:
    """bool LUT over DISTINCT dictionary values for a MATCH predicate.

    An index rule with an analyzer is mandatory (ref
    pkg/index/inverted/query.go:371); match_option.analyzer only
    OVERRIDES the rule's analyzer, it cannot substitute for the rule."""
    if not isinstance(c.value, str):
        raise TypeError("MATCH requires a string literal")
    rule_analyzer = (analyzers or {}).get(c.name)
    if rule_analyzer is None:
        raise ValueError(
            f"an index rule with an analyzer is mandatory for MATCH on "
            f"tag {c.name!r}"
        )
    analyzer = getattr(c, "match_analyzer", "") or rule_analyzer
    q = analyze(analyzer, c.value)
    want_all = getattr(c, "match_op", "or") == "and"
    return np.fromiter(
        (
            (
                q <= analyze(analyzer, v.decode(errors="replace"))
                if want_all
                else bool(q & analyze(analyzer, v.decode(errors="replace")))
            )
            for v in values
        ),
        dtype=bool,
        count=len(values),
    )


def _code_lut_mask(col: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """bool mask from a per-dict-code LUT; sentinel codes (-1/-2) miss."""
    n = len(lut)
    if n == 0:
        return np.zeros(col.shape, dtype=bool)
    ok = (col >= 0) & (col < n)
    return np.where(ok, lut[np.clip(col, 0, n - 1)], False)


def _cond_mask(
    src: ColumnData, c: Condition, analyzers=None, tag_types=None
) -> np.ndarray:
    """bool[n] mask for one condition over dictionary codes.

    `analyzers`: tag -> analyzer name from the measure's bound index
    rules — mandatory context for MATCH (the reference errors on MATCH
    without an index rule, pkg/index/inverted/query.go:371).
    `tag_types`: tag -> TagType for schema checks on range literals."""
    col = src.tags.get(c.name)
    if col is None:
        # Source predates the tag: the "absent" sentinel (-2) misses
        # both real codes and the -1 "literal unknown" code.
        col = np.full(src.ts.shape, -2, dtype=np.int32)
    d = src.dicts.get(c.name, [])
    lut = {v: i for i, v in enumerate(d)}
    if c.op == "eq":
        return col == lut.get(tag_value_bytes(c.value), -1)
    if c.op == "ne":
        return col != lut.get(tag_value_bytes(c.value), -1)
    if c.op in ("in", "not_in"):
        codes = {lut.get(tag_value_bytes(v), -1) for v in c.value}
        inmask = np.isin(col, list(codes))
        return inmask if c.op == "in" else ~inmask
    if c.op in _RANGE_OPS:
        return _code_lut_mask(
            col,
            range_lut(c.op, c.value, list(d), (tag_types or {}).get(c.name)),
        )
    if c.op == "match":
        return _code_lut_mask(col, match_lut(c, analyzers, list(d)))
    raise NotImplementedError(f"raw-path op {c.op}")


def row_mask(
    src: ColumnData,
    conds: list[Condition],
    begin_millis: int,
    end_millis: int,
    analyzers=None,
    tag_types=None,
) -> np.ndarray:
    """bool[n] time-range + AND'ed tag-predicate mask over one source."""
    mask = (src.ts >= begin_millis) & (src.ts < end_millis)
    for c in conds:
        mask &= _cond_mask(src, c, analyzers, tag_types)
    return mask


def criteria_mask(
    src: ColumnData,
    criteria,
    begin_millis: int,
    end_millis: int,
    analyzers=None,
    tag_types=None,
) -> np.ndarray:
    """bool[n] time-range + FULL criteria-tree mask (AND/OR) — the host
    twin of the device expr lowering (measure_exec._lower_criteria)."""
    from banyandb_tpu_torch.api.model import LogicalExpression

    mask = (src.ts >= begin_millis) & (src.ts < end_millis)
    if criteria is None:
        return mask

    def walk(node) -> np.ndarray:
        if isinstance(node, Condition):
            return _cond_mask(src, node, analyzers, tag_types)
        assert isinstance(node, LogicalExpression), node
        left, right = walk(node.left), walk(node.right)
        return (left & right) if node.op == "and" else (left | right)

    return mask & walk(criteria)
