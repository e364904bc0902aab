"""Wire-compatible protobuf modules (generated — see regen.py).

The generated tree keeps the upstream package layout (banyandb.*.v1) so
message descriptors carry the exact wire names reference clients
expect.  Each generated module imports its siblings by this package's
full path (``banyandb_tpu_torch.api.pb.banyandb.model.v1``), so nothing
joins ``sys.path`` and no top-level ``banyandb`` package is loaded: a
process that also holds another copy of the same tree keeps the two
apart.  Both register the same serialized descriptors in the default
pool, so their messages parse in each other.

    from banyandb_tpu_torch.api import pb
    pb.measure_query_pb2.QueryRequest()
"""

from __future__ import annotations

import importlib


def __getattr__(name: str):
    """Lazy aliases: pb.measure_query_pb2 ->
    banyandb_tpu_torch.api.pb.banyandb.measure.v1.query_pb2."""
    try:
        family, rest = name.split("_", 1)
        if rest.endswith("_pb2"):
            stem = rest[: -len("_pb2")]
            return importlib.import_module(
                f"{__name__}.banyandb.{family}.v1.{stem}_pb2"
            )
    except (ValueError, ImportError):
        pass
    raise AttributeError(name)
