"""Plan precompile registry: warm query kernels before queries arrive.

The counterpart of banyandb_tpu/query/precompile.py.  Three cooperating
pieces close the cold-start gap:

1. **Recording**: the measure/stream executors call ``record()`` every
   time they resolve a plan signature (``PlanSpec`` / ``FusedSpec`` /
   ``_MaskSpec``), so the registry always knows the live plan
   population of this process.
2. **Persistence**: when a server attaches a store file
   (``<root>/plan-registry.json``), newly seen signatures are saved (top
   ``MAX_STORED`` by use count) and reloaded on the next boot — the
   process remembers WHICH plans matter across restarts, while
   ``utils/compile_cache`` keeps the built kernel library.  The JSON is
   the reference's, so a store written by either package loads in the
   other.
3. **Warming**: ``warm_async()`` (server start = schema load, and once
   after the first flush via ``note_flush``) warms the stored
   signatures plus the builtin dashboard matrix on a background daemon
   thread.  PyTorch runs eagerly and the per-chunk functions are
   closures, so there is no jit cache to fill: warming builds and loads
   the kernel library (through the build cache), runs each signature's
   per-chunk function once on zero tensors of the production shapes
   and dtypes — in each ship form, dense and ``BYDB_DEVICE_DECODE``
   compressed — on the registry's device, and synchronizes.  That pays
   the context, allocator and kernel set-up a cold process would
   otherwise pay inside its first query.  Zero inputs put every row in
   group 0, so a warm's kernel time is not a query's.

``builtin_plans()``/``builtin_fused()``/``builtin_masks()`` are the
checked-in dashboard signature matrix.  The plan auditor
(``lint/whole_program/plan_audit.py``) shape-audits EXACTLY this list —
a test pins the agreement.

The registry's device is explicit and resolved at warm time, never at
import or in ``record()``: the default is the CUDA device
(``backend.resolve_device``), which raises without one; the CPU is used
only when asked.  A failed warm is counted (``errors``, ``last_error``)
and never takes a server down.

``BYDB_PRECOMPILE=0`` disables recording and warming (tests that need a
deterministic population set this).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

MAX_STORED = 64


def enabled() -> bool:
    from banyandb_tpu_torch.utils.envflag import env_flag

    return env_flag("BYDB_PRECOMPILE", default=True)


# -- the builtin dashboard matrix (single source for warm + plan audit) ------


def builtin_plans():
    """(name, PlanSpec) pairs: the dashboard plan population.

    Mirrors the shapes real consoles issue: flat count tiles, grouped
    eq+LUT filters with scan-order tracking, the two-pass percentile
    histogram, OR criteria trees, and the TopN ranking shape (grouped
    mean/minmax + representative tracking at a scan-chunk bucket)."""
    from banyandb_tpu_torch.query.measure_exec import PlanSpec, _PredSpec

    flat = PlanSpec(
        tags_code=(),
        fields=("v",),
        preds=(),
        group_tags=(),
        radices=(),
        num_groups=1,
        want_minmax=True,
        nrows=8192,
    )
    grouped = PlanSpec(
        tags_code=("region", "svc"),
        fields=("v",),
        preds=(
            _PredSpec("code", "svc", "eq"),
            _PredSpec("lut", "region", "le", nvals=4),
        ),
        group_tags=("svc", "region"),
        radices=(8, 4),
        num_groups=32,
        want_minmax=True,
        nrows=8192,
        want_rep=True,
    )
    pct = PlanSpec(
        tags_code=("svc",),
        fields=("lat",),
        preds=(),
        group_tags=("svc",),
        radices=(16,),
        num_groups=16,
        want_minmax=True,
        hist_field="lat",
        nrows=65536,
    )
    orplan = PlanSpec(
        tags_code=("svc",),
        fields=("v",),
        preds=(
            _PredSpec("code", "svc", "in", nvals=4),
            _PredSpec("code", "svc", "eq"),
        ),
        group_tags=(),
        radices=(),
        num_groups=1,
        want_minmax=False,
        nrows=8192,
        expr=("or", ("p", 0), ("p", 1)),
    )
    topn = PlanSpec(
        tags_code=("region", "svc"),
        fields=("value",),
        preds=(_PredSpec("code", "region", "ne"),),
        group_tags=("svc",),
        radices=(1024,),
        num_groups=1024,
        want_minmax=True,
        nrows=65536,
        want_rep=True,
    )
    return (
        ("measure/flat-count", flat),
        ("measure/group-eq-lut", grouped),
        ("measure/percentile-hist", pct),
        ("measure/or-expr", orplan),
        ("measure/topn-dashboard", topn),
    )


def builtin_masks():
    """(name, _MaskSpec) pairs for the stream retrieval mask."""
    from banyandb_tpu_torch.query.stream_exec import _MaskSpec

    return (
        ("stream/mask-eq-in", _MaskSpec(preds=(("eq", 1), ("in", 4)), nrows=32768)),
    )


def builtin_fused():
    """(name, FusedSpec) pairs: the fused whole-plan twins of the builtin
    measure matrix (query/fused_exec).  One-chunk buckets — the shape a
    dashboard part-batch resolves — warmed, plan-audited and budget-
    ratcheted alongside their staged counterparts."""
    from banyandb_tpu_torch.query.fused_exec import FusedSpec

    return tuple(
        (name.replace("measure/", "fused/"), FusedSpec(plan=spec, num_chunks=1))
        for name, spec in builtin_plans()
    )


def builtin_fused_decode():
    """(name, FusedSpec) pairs for the ``fused+decode/*`` audit rows —
    the SAME FusedSpecs as builtin_fused() (the ship form is not part of
    the plan signature), paired by the kernel audit with the compressed
    chunk structs from fused_decode_chunk_struct."""
    return tuple(
        (name.replace("fused/", "fused+decode/"), fspec)
        for name, fspec in builtin_fused()
    )


# -- shape/dtype argument builders (shared with the plan auditor) ------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one argument tensor (jax.ShapeDtypeStruct's
    role): the warm builds zeros of it, the audits fake tensors."""

    shape: tuple
    dtype: torch.dtype


def tree_map(fn, tree):
    """Map over the leaves of nested dicts/tuples/lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def zeros(tree, device):
    """Zero tensors of a TensorSpec tree on `device`."""
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), tree
    )


def chunk_struct(spec) -> dict:
    """TensorSpec tree matching measure_exec._device_chunk's dense form."""
    S = TensorSpec
    n = spec.nrows
    return {
        "ts": S((n,), torch.int32),
        "series": S((n,), torch.int32),
        "valid": S((n,), torch.bool),
        "row": S((n,), torch.int32),
        "tags_code": {t: S((n,), torch.int32) for t in spec.tags_code},
        "fields": {f: S((n,), torch.float32) for f in spec.fields},
    }


def pred_struct(spec) -> dict:
    """TensorSpec map matching compute_partials' pred_vals."""
    S = TensorSpec
    out = {}
    for i, p in enumerate(spec.preds):
        if p.kind == "lut":
            out[f"p{i}"] = S((p.nvals,), torch.bool)
        elif p.op in ("in", "not_in"):
            out[f"p{i}"] = S((p.nvals,), torch.int32)
        else:
            out[f"p{i}"] = S((), torch.int32)
    return out


def scalar_struct() -> tuple:
    """The (hist_lo, hist_span) f32 scalars every measure function takes."""
    return (TensorSpec((), torch.float32), TensorSpec((), torch.float32))


def mask_structs(mspec) -> tuple:
    """(cols, pred_vals) TensorSpecs matching device_tag_mask."""
    S = TensorSpec
    cols = tuple(S((mspec.nrows,), torch.int32) for _ in mspec.preds)
    vals = tuple(
        S((nv,), torch.int32) if op in ("in", "not_in") else S((), torch.int32)
        for op, nv in mspec.preds
    )
    return cols, vals


def _warm_scalars(device) -> tuple:
    return (
        torch.zeros((), dtype=torch.float32, device=device),
        torch.ones((), dtype=torch.float32, device=device),
    )


def measure_warm_args(spec, device) -> tuple:
    """Zero-filled production-shaped args for one measure plan."""
    return (
        zeros(chunk_struct(spec), device),
        zeros(pred_struct(spec), device),
        *_warm_scalars(device),
    )


def measure_decode_warm_args(spec, device) -> tuple:
    """Warm args for the COMPRESSED staged ship form (the production
    default under ``BYDB_DEVICE_DECODE=1``) at the canonical widths."""
    return (
        zeros(decode_chunk_struct(spec), device),
        zeros(pred_struct(spec), device),
        *_warm_scalars(device),
    )


def mask_warm_args(mspec, device) -> tuple:
    cols, vals = mask_structs(mspec)
    return (zeros(cols, device), zeros(vals, device))


def fused_chunk_struct(fspec) -> dict:
    """TensorSpec tree matching fused_exec._stacked_chunks' dense form."""
    c = fspec.num_chunks
    return tree_map(
        lambda s: TensorSpec((c,) + s.shape, s.dtype), chunk_struct(fspec.plan)
    )


def _decode_lut_len(spec, t: str) -> int:
    for tag, radix in zip(spec.group_tags, spec.radices):
        if tag == t:
            return 1 << max(int(radix) - 1, 1).bit_length()
    return 16


def _decode_code_dtype(spec, t: str) -> torch.dtype:
    """Canonical narrow code width per tag: from the group radix where
    the signature pins one, i8 otherwise (the dashboard population's
    dictionaries are small).  Production widths are data-dependent."""
    from banyandb_tpu_torch.storage import encoded as enc_mod

    for tag, radix in zip(spec.group_tags, spec.radices):
        if tag == t:
            return _TORCH_DTYPES[np.dtype(enc_mod.code_dtype(int(radix)))]
    return torch.int8


_TORCH_DTYPES = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
}


def decode_chunk_struct(spec) -> dict:
    """TensorSpec tree for the COMPRESSED ship form of one STAGED chunk
    (measure_exec._device_chunk's compressed branch) at the canonical
    single-source shape of fused_decode_chunk_struct; the staged form
    never carries a ``tags_code`` key (the fused stacker keeps an empty
    one)."""
    S = TensorSpec
    n = spec.nrows
    out = {
        "ts": S((n,), torch.int32),
        "series": S((n,), torch.int32),
        "valid": S((n,), torch.bool),
        "row": S((n,), torch.int32),
        "fields": {
            f: S((n,), torch.float32)
            for f in spec.fields
            if f == spec.hist_field
        },
    }
    if spec.tags_code:
        out["tags_enc"] = {
            t: S((n,), _decode_code_dtype(spec, t)) for t in spec.tags_code
        }
        out["tags_lut"] = {
            t: S((1, _decode_lut_len(spec, t)), torch.int32)
            for t in spec.tags_code
        }
        out["src_ord"] = S((n,), torch.int16)
    enc = {
        f: S((n,), torch.int16)
        for f in spec.fields
        if f != spec.hist_field
    }
    if enc:
        out["fields_enc"] = enc
    return out


def fused_decode_chunk_struct(fspec) -> dict:
    """TensorSpec tree for the COMPRESSED ship form of a fused
    part-batch (``BYDB_DEVICE_DECODE``, fused_exec._stacked_chunks'
    compressed branch), at a canonical single-source shape:

    - tag columns as narrow local codes (width from the group radix, i8
      otherwise) plus a ``[1, L]`` remap LUT with L the power-of-two
      bucket of the tag's radix (group tags) or 16;
    - one i16 source-ordinal column;
    - fields as i16 exact-int columns, except the histogram field
      (percentile inputs are real-valued) which stays dense f32."""
    S = TensorSpec
    spec = fspec.plan
    c, n = fspec.num_chunks, spec.nrows
    out = {
        "ts": S((c, n), torch.int32),
        "series": S((c, n), torch.int32),
        "valid": S((c, n), torch.bool),
        "row": S((c, n), torch.int32),
        "tags_code": {},
        "fields": {
            f: S((c, n), torch.float32)
            for f in spec.fields
            if f == spec.hist_field
        },
    }
    if spec.tags_code:
        out["tags_enc"] = {
            t: S((c, n), _decode_code_dtype(spec, t)) for t in spec.tags_code
        }
        out["tags_lut"] = {
            t: S((1, _decode_lut_len(spec, t)), torch.int32)
            for t in spec.tags_code
        }
        out["src_ord"] = S((c, n), torch.int16)
    enc = {
        f: S((c, n), torch.int16)
        for f in spec.fields
        if f != spec.hist_field
    }
    if enc:
        out["fields_enc"] = enc
    return out


def fused_warm_args(fspec, device) -> tuple:
    """Zero-filled production-shaped args for one fused part-batch."""
    return (
        zeros(fused_chunk_struct(fspec), device),
        zeros(pred_struct(fspec.plan), device),
        *_warm_scalars(device),
    )


def fused_decode_warm_args(fspec, device) -> tuple:
    """Warm args for the COMPRESSED fused ship form (the production
    default under ``BYDB_DEVICE_DECODE=1``) at the canonical widths."""
    return (
        zeros(fused_decode_chunk_struct(fspec), device),
        zeros(pred_struct(fspec.plan), device),
        *_warm_scalars(device),
    )


def signature_function(kind: str, spec):
    """-> the per-chunk (or per-batch) function of one signature, from
    the executor's memo the query path reads too, or None for an
    unknown kind."""
    from banyandb_tpu_torch.query import fused_exec, measure_exec, stream_exec

    mod = {
        "measure": measure_exec,
        "fused": fused_exec,
        "stream_mask": stream_exec,
    }.get(kind)
    return None if mod is None else mod.kernel_for(spec)


def warm_args(kind: str, spec, device, decode: bool) -> list[tuple]:
    """The argument sets one warm of a signature runs: the dense ship
    form, plus the compressed one when ``decode`` (measure/fused)."""
    if kind == "measure":
        out = [measure_warm_args(spec, device)]
        if decode:
            out.append(measure_decode_warm_args(spec, device))
        return out
    if kind == "fused":
        out = [fused_warm_args(spec, device)]
        if decode:
            out.append(fused_decode_warm_args(spec, device))
        return out
    if kind == "stream_mask":
        return [mask_warm_args(spec, device)]
    return []


# -- signature (de)serialization ---------------------------------------------


def spec_to_json(kind: str, spec) -> dict:
    d = dataclasses.asdict(spec)
    d["kind"] = kind
    return d


def _tuplify(node):
    """JSON lists -> tuples, recursively (expr trees, pred tuples)."""
    if isinstance(node, list):
        return tuple(_tuplify(v) for v in node)
    return node


def spec_from_json(d: dict):
    kind = d["kind"]
    if kind == "fused":
        from banyandb_tpu_torch.query.fused_exec import FusedSpec

        _, plan = spec_from_json({**d["plan"], "kind": "measure"})
        return kind, FusedSpec(plan=plan, num_chunks=int(d["num_chunks"]))
    if kind == "measure":
        from banyandb_tpu_torch.query.measure_exec import PlanSpec, _PredSpec

        return kind, PlanSpec(
            tags_code=tuple(d["tags_code"]),
            fields=tuple(d["fields"]),
            preds=tuple(_PredSpec(**p) for p in d["preds"]),
            group_tags=tuple(d["group_tags"]),
            radices=tuple(d["radices"]),
            num_groups=int(d["num_groups"]),
            want_minmax=bool(d["want_minmax"]),
            hist_field=d.get("hist_field", ""),
            nrows=int(d["nrows"]),
            group_method=d.get("group_method", "auto"),
            want_rep=bool(d.get("want_rep", False)),
            rep_desc=bool(d.get("rep_desc", False)),
            expr=_tuplify(d.get("expr", [])),
        )
    if kind == "stream_mask":
        from banyandb_tpu_torch.query.stream_exec import _MaskSpec

        return kind, _MaskSpec(
            preds=_tuplify(d["preds"]), nrows=int(d["nrows"])
        )
    raise ValueError(f"unknown plan signature kind {kind!r}")


# -- the registry ------------------------------------------------------------


class PrecompileRegistry:
    """Thread-safe record of live plan signatures + background warming.

    ``device`` (``backend.resolve_device``, resolved at warm time): the
    device a warm runs on; None is the CUDA device."""

    def __init__(self, device=None):
        self.device = device
        self._lock = threading.Lock()
        # (kind, spec) -> use count; insertion order = first-seen order
        self._recorded: dict[tuple, int] = {}
        # (kind, spec) -> epoch-ms of the latest record() — persisted so
        # warming (and the autoreg miner) can rank by freshness too
        self._last_hit: dict[tuple, int] = {}
        # (kind, spec) -> (group, measure) the executor resolved the
        # plan for: the context that turns an anonymous PlanSpec into a
        # registrable streamagg signature (query/planner mining)
        self._contexts: dict[tuple, tuple] = {}
        self._store_path: Optional[Path] = None
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_pending = False
        self._cancel = threading.Event()
        self._save_timer: Optional[threading.Timer] = None
        self._flush_warmed = False
        self.compiled = 0
        self.errors = 0
        self.last_error: Optional[str] = None

    # -- recording / persistence --------------------------------------------
    def record(self, kind: str, spec, context: Optional[tuple] = None) -> None:
        """Called by executors on every plan resolution.  Never blocks
        the query hot path: a dict update, and a first-seen signature
        schedules a debounced background save instead of rewriting the
        store inline.

        ``context`` ((group, measure), measure plans only) attaches the
        schema identity the plan resolved against — the evidence the
        auto-registration miner needs to turn a hot PlanSpec into a
        streamagg registration."""
        if not enabled():
            return
        import time as _time

        now_ms = int(_time.time() * 1000)
        with self._lock:
            key = (kind, spec)
            n = self._recorded.get(key)
            self._recorded[key] = (n or 0) + 1
            self._last_hit[key] = now_ms
            if context is not None:
                self._contexts[key] = tuple(context)
            new = n is None and self._store_path is not None
        if new:
            self._schedule_save()

    def evidence(self) -> list[tuple]:
        """[(kind, spec, count, context-or-None)] for the autoreg
        miner, hottest first."""
        with self._lock:
            return [
                (k, s, count, self._contexts.get((k, s)))
                for (k, s), count in sorted(
                    self._recorded.items(),
                    key=lambda kv: (-kv[1], -self._last_hit.get(kv[0], 0)),
                )
            ]

    def _schedule_save(self, delay: float = 1.0) -> None:
        with self._lock:
            if self._save_timer is not None:
                return  # a pending save will pick this signature up too
            t = threading.Timer(delay, self._save_timer_fire)
            t.daemon = True
            t.name = "bydb-plan-save"
            self._save_timer = t
        t.start()

    def _save_timer_fire(self) -> None:
        with self._lock:
            self._save_timer = None
        self._save()

    def attach_store(self, path) -> None:
        """Bind (and load) the persistent signature store."""
        p = Path(path)
        loaded: list[tuple[tuple, int, int, Optional[tuple]]] = []
        try:
            if p.exists():
                for rec in json.loads(p.read_text()).get("signatures", []):
                    try:
                        kind, spec = spec_from_json(rec)
                        ctx = rec.get("context")
                        loaded.append((
                            (kind, spec),
                            int(rec.get("count", 1)),
                            int(rec.get("last_hit_ms", 0)),
                            tuple(ctx) if ctx else None,
                        ))
                    except Exception:  # noqa: BLE001 — skip stale entries
                        continue
        except (OSError, ValueError):
            loaded = []
        with self._lock:
            self._store_path = p
            for key, count, last_ms, ctx in loaded:
                self._recorded[key] = max(self._recorded.get(key, 0), count)
                if last_ms:
                    self._last_hit[key] = max(
                        self._last_hit.get(key, 0), last_ms
                    )
                if ctx is not None and key not in self._contexts:
                    self._contexts[key] = ctx
            have_unsaved = len(self._recorded) > len(loaded)
        if have_unsaved:
            # signatures recorded before the store was bound (embedded
            # engines, bench) persist now, not on the next new plan
            self._save()

    def _save(self) -> None:
        with self._lock:
            p = self._store_path
            if p is None:
                return
            # frequency-weighted persistence, recency as the tiebreak:
            # the top-MAX_STORED ACTUALLY-HOT signatures survive a
            # restart (and warm first), not the most recently seen ones
            top = sorted(
                self._recorded.items(),
                key=lambda kv: (-kv[1], -self._last_hit.get(kv[0], 0)),
            )[:MAX_STORED]
            doc = {
                "signatures": [
                    {
                        **spec_to_json(kind, spec),
                        "count": count,
                        "last_hit_ms": self._last_hit.get((kind, spec), 0),
                        **(
                            {"context": list(self._contexts[(kind, spec)])}
                            if (kind, spec) in self._contexts
                            else {}
                        ),
                    }
                    for (kind, spec), count in top
                ]
            }
        try:
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_suffix(".tmp")
            tmp.write_text(json.dumps(doc, indent=1))
            os.replace(tmp, p)
        except OSError:
            pass  # persistence is an optimization, never a query failure

    def signatures(self) -> list[tuple[str, object]]:
        """Hottest first (count, then recency): warm_async warms the
        actually-hot population before the long tail."""
        with self._lock:
            return [
                (k, s)
                for (k, s), _ in sorted(
                    self._recorded.items(),
                    key=lambda kv: (-kv[1], -self._last_hit.get(kv[0], 0)),
                )
            ]

    # -- warming -------------------------------------------------------------
    def _compile_one(self, kind: str, spec) -> None:
        from banyandb_tpu_torch.backend import resolve_device
        from banyandb_tpu_torch.ops import hopper_kernels
        from banyandb_tpu_torch.storage import encoded as enc_mod

        fn = signature_function(kind, spec)
        if fn is None:
            return
        dev = resolve_device(self.device)
        on_card = dev.type == "cuda"
        if on_card:
            hopper_kernels.build()  # the build cache: load, or nvcc once
        # the compressed ship form (BYDB_DEVICE_DECODE, default on) is a
        # different input structure from the dense one — warm the
        # form(s) production queries will actually resolve
        args_list = warm_args(kind, spec, dev, enc_mod.device_decode_enabled())
        # this thread's current device and its default stream; the sync
        # below returns only when every launch of this signature is done
        with torch.cuda.device(dev) if on_card else contextlib.nullcontext():
            for args in args_list:
                fn(*args)
            if on_card:
                # bdlint: disable=host-sync -- warming runs on a
                # background thread and MUST block until the launches
                # finish; there is no result to batch
                torch.cuda.synchronize(dev)

    def warm(self, include_builtin: bool = True, sigs=None) -> int:
        """Warm signatures now (callers wanting async use warm_async)."""
        if sigs is None:
            sigs = list(self.signatures())
            if include_builtin:
                sigs += [("measure", s) for _, s in builtin_plans()]
                sigs += [("fused", s) for _, s in builtin_fused()]
                sigs += [("stream_mask", s) for _, s in builtin_masks()]
        done = 0
        seen = set()
        for kind, spec in sigs:
            if self._cancel.is_set():
                break  # shutdown: stop at a kernel boundary, never mid-launch
            if (kind, spec) in seen:
                continue
            seen.add((kind, spec))
            try:
                self._compile_one(kind, spec)
                done += 1
            except Exception as e:  # noqa: BLE001 — warm must never take a server down
                self.errors += 1
                self.last_error = f"{kind}: {type(e).__name__}: {e}"
        self.compiled += done
        return done

    def _warm_loop(self, include_builtin: bool) -> None:
        """Warm rounds until no more work was queued while running —
        a note_flush/warm_async arriving mid-round (e.g. plans recorded
        while the boot warm is still running) queues another round
        instead of being silently dropped."""
        while True:
            self.warm(include_builtin=include_builtin)
            with self._lock:
                if not self._warm_pending or self._cancel.is_set():
                    return
                self._warm_pending = False
            include_builtin = False  # follow-up rounds: recorded sigs only

    def warm_async(self, include_builtin: bool = True) -> Optional[threading.Thread]:
        """Background warm (server start / post-flush).  If a warm is
        already running, queues one more round for when it finishes."""
        if not enabled():
            return None
        with self._lock:
            if self._warm_thread is not None and self._warm_thread.is_alive():
                self._warm_pending = True
                return self._warm_thread
            t = threading.Thread(
                target=self._warm_loop,
                args=(include_builtin,),
                name="bydb-precompile",
                daemon=True,
            )
            self._warm_thread = t
        t.start()
        return t

    def note_flush(self) -> None:
        """First-flush hook: parts now exist on disk, the next query is
        the cold one — warm the recorded population once."""
        if not enabled():
            return
        with self._lock:
            if self._flush_warmed or not self._recorded:
                return
            self._flush_warmed = True
        self.warm_async(include_builtin=False)

    def wait_warm(self, timeout: float = 120.0) -> bool:
        """Block until the in-flight warm finishes (bench/tests)."""
        with self._lock:
            t = self._warm_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Server-stop hook: cancel warming at the next signature
        boundary and join, so process exit never lands inside a launch
        on the warm thread; flushes any pending store save."""
        with self._lock:
            self._warm_pending = False
            self._cancel.set()
            t = self._warm_thread
            timer = self._save_timer
            self._save_timer = None
        if timer is not None:
            timer.cancel()
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                return  # leave cancel set; the thread exits at its next check
        self._cancel.clear()
        self._save()

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": enabled(),
                "recorded": len(self._recorded),
                "stored": str(self._store_path) if self._store_path else None,
                "compiled": self.compiled,
                "errors": self.errors,
                "last_error": self.last_error,
                "device": None if self.device is None else str(self.device),
                "warming": bool(
                    self._warm_thread and self._warm_thread.is_alive()
                ),
            }


_registry = PrecompileRegistry()


def default_registry() -> PrecompileRegistry:
    return _registry
