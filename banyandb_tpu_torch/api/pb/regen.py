"""Regenerate the wire-compatible protobuf modules.

The BanyanDB wire contract is defined by the reference proto tree
(api/proto/banyandb/** of upstream
github.com/apache/skywalking-banyandb).  Wire compatibility
means identical packages, message names, and field numbers, so this
script compiles those protos directly rather than re-typing them.

The upstream tree imports three annotation-only dependencies that buf
normally fetches (google/api/annotations.proto, protoc-gen-openapiv2
options, validate/validate.proto).  None of them affect the wire format
— they carry HTTP-gateway routes, OpenAPI metadata, and server-side
validation hints — so the sanitizer strips those imports and the option
blocks that reference them before invoking protoc.  The HTTP routes
they described are re-implemented natively in api/http_gateway.py.

protoc writes each generated import as a top-level ``banyandb.*``
import; ``_repoint`` rewrites those (and the module names handed to the
builder) to this package's full path, so the tree never needs
``sys.path`` and never shares a top-level ``banyandb`` package with
another copy of it in the same process.

Usage:  python -m banyandb_tpu_torch.api.pb.regen <src_proto_root>
Output: banyandb/**/**_pb2.py next to this file (imported lazily via
this package's __init__).
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent
# the package path the generated imports are re-pointed at
PKG = "banyandb_tpu_torch.api.pb"

# proto subtrees to compile (the services this framework serves)
SUBTREES = [
    "banyandb/common/v1",
    "banyandb/model/v1",
    "banyandb/database/v1",
    "banyandb/measure/v1",
    "banyandb/stream/v1",
    "banyandb/property/v1",
    "banyandb/trace/v1",
    "banyandb/bydbql/v1",
    "banyandb/cluster/v1",
    "banyandb/schema/v1",
    "banyandb/fodc/v1",
    "banyandb/pipeline/v1",
]

_DROP_IMPORTS = (
    "google/api/annotations.proto",
    "google/api/httpbody.proto",
    "protoc-gen-openapiv2/options/annotations.proto",
    "validate/validate.proto",
)


def _strip_balanced(text: str, start: int, open_ch: str, close_ch: str) -> int:
    """Index just past the balanced group opening at text[start]."""
    depth = 0
    i = start
    while i < len(text):
        c = text[i]
        if c == open_ch:
            depth += 1
        elif c == close_ch:
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    raise ValueError("unbalanced group in proto source")


def sanitize(text: str) -> str:
    # 1. drop unsupported imports
    lines = []
    for ln in text.splitlines():
        if any(f'"{imp}"' in ln for imp in _DROP_IMPORTS) and ln.strip().startswith(
            "import"
        ):
            continue
        lines.append(ln)
    text = "\n".join(lines)

    # 2. remove extension option statements:  option (ext.path) = <value>;
    #    value may be a balanced {...} aggregate or a scalar.
    out = []
    i = 0
    pat = re.compile(r"option\s*\(")
    while True:
        m = pat.search(text, i)
        if not m:
            out.append(text[i:])
            break
        out.append(text[i : m.start()])
        j = _strip_balanced(text, text.index("(", m.start()), "(", ")")
        # skip to '=' then the value
        k = text.index("=", j) + 1
        while text[k].isspace():
            k += 1
        if text[k] == "{":
            k = _strip_balanced(text, k, "{", "}")
        # consume through the terminating ';'
        k = text.index(";", k) + 1
        i = k

    text = "".join(out)

    # 3. remove extension field options:  [(validate.rules)...] etc.
    out = []
    i = 0
    while True:
        j = text.find("[(", i)
        if j < 0:
            out.append(text[i:])
            break
        out.append(text[i:j])
        i = _strip_balanced(text, j, "[", "]")
    return "".join(out)


_IMPORT = re.compile(r"^from banyandb\.([a-z]+)\.v1 import ", re.M)
_BUILD = "BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb."


def _repoint(text: str) -> str:
    """protoc output -> imports under PKG (see the module docstring)."""
    text = _IMPORT.sub(rf"from {PKG}.banyandb.\1.v1 import ", text)
    return text.replace(
        _BUILD, f"BuildTopDescriptorsAndMessages(DESCRIPTOR, '{PKG}.banyandb."
    )


def main(src_root: pathlib.Path) -> None:
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        for sub in SUBTREES:
            for proto in sorted((src_root / sub).glob("*.proto")):
                dst = tmp / sub / proto.name
                dst.parent.mkdir(parents=True, exist_ok=True)
                dst.write_text(sanitize(proto.read_text()))
        protos = [str(p.relative_to(tmp)) for p in tmp.rglob("*.proto")]
        # wipe previous output so removed protos don't linger
        if (HERE / "banyandb").exists():
            shutil.rmtree(HERE / "banyandb")
        subprocess.run(
            ["protoc", f"-I{tmp}", f"--python_out={HERE}", *protos],
            check=True,
        )
        for gen in (HERE / "banyandb").rglob("*_pb2.py"):
            gen.write_text(_repoint(gen.read_text()))
        # packages need __init__.py on some import configurations
        for d in (HERE / "banyandb").rglob("**/"):
            (d / "__init__.py").touch()
        (HERE / "banyandb" / "__init__.py").touch()
    print(f"generated {len(protos)} proto modules under {HERE / 'banyandb'}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m banyandb_tpu_torch.api.pb.regen <src_proto_root>")
    main(pathlib.Path(sys.argv[1]))
