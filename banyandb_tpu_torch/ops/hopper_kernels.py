"""Hand-written Hopper kernels for the scan hot loop (csrc/*.cu).

The counterpart of banyandb_tpu/ops/pallas_kernels.py.  Each kernel has
here:

- a wrapper that checks device, dtype, shape and contiguity, allocates
  outputs and scratch with ``torch.empty`` and launches on the current
  stream without synchronizing.  A CUDA tensor launches the kernel or
  raises; only a CPU tensor takes the plain version;
- the plain PyTorch version of the same function (``*_plain``), used
  for CPU tensors, by the tests and as the reference the card run holds
  the kernel against;
- a launch count in ``LAUNCHES``, raised by one where the wrapper
  launches its kernel and nowhere else.

The sources are built at the first CUDA use, with ``nvcc`` for sm_90a,
into one shared library with a plain C interface under ``_build/``
(one ``nvcc -c`` per source, all started together, then one link), and
bound with ``ctypes``.  Each C entry returns ``cudaGetLastError()``.

``fused_group_multi`` replaces pallas_kernels.py::fused_group_multi,
``widen_narrow`` replaces pallas_kernels.py::widen_narrow and
``prefix_sum_narrow`` replaces pallas_kernels.py::prefix_sum_narrow;
what bounds each on the card and how the design answers it is in the
note at the top of its source (csrc/fused_group.cu, csrc/widen.cu,
csrc/prefix_sum.cu).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

TILE = 2048
# pass-1 warps per block (csrc/fused_group.cu kWarps): each keeps its own
# shared-memory copy of the [1 + F, group tile] accumulators
_WARPS = 8
# shared memory one pass-1 block may take: two blocks fit an SM
_SMEM_BUDGET = 96 << 10

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("fused_group.cu", "widen.cu", "prefix_sum.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "fused_group_multi": 0,
    "fused_group_sum": 0,
    "widen_narrow": 0,
    "prefix_sum_narrow": 0,
}

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the build that loaded (ptxas register/smem report)
build_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"libbydb_hopper-{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> str:
    """nvcc every source to an object in parallel, link one .so, and
    move it into place atomically.  -> nvcc's combined output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", o],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(SOURCES, objs)
        ]
        failed = []
        for s, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            log.append(f"== {s}\n{out}")
            if p.returncode != 0:
                failed.append(s)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *objs, "-o", tmp_so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    return "\n".join(log)


def build() -> float:
    """Build (when the sources changed) and load the kernel library.
    -> seconds spent.  Called by the first CUDA launch; raises when the
    build or the load fails."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    with _lib_lock:
        if _lib is not None:
            return 0.0
        so = _library_path()
        if not so.exists():
            build_log = _compile(so)
        lib = ctypes.CDLL(str(so))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bydb_fused_group_multi.restype = i
        lib.bydb_fused_group_multi.argtypes = [
            p, p, p, p, ll, i, i, i, p, p, p, i, p,
        ]
        lib.bydb_widen_narrow.restype = i
        lib.bydb_widen_narrow.argtypes = [p, i, ll, p, i, p]
        lib.bydb_prefix_sum_narrow.restype = i
        lib.bydb_prefix_sum_narrow.argtypes = [p, ll, p, p, i, p]
        _lib = lib
    return time.perf_counter() - t0


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# -- fused_group_multi --------------------------------------------------------


def _group_tile(num_groups: int, nf: int) -> int:
    """Group-tile width of one pass-1 block: the whole (32-padded) group
    axis, halved until the warps' accumulators fit the smem budget."""
    gt = min(2048, -(-num_groups // 32) * 32)
    while _WARPS * (1 + nf) * gt * 4 > _SMEM_BUDGET:
        if gt <= 32:
            raise ValueError(f"{nf} fields do not fit one group tile")
        gt //= 2
    return gt


def fused_group_multi_plain(codes, pred_mask, values, valid, num_groups: int):
    """Plain PyTorch version: per-TILE f32 partials by ``index_add_``,
    folded over tiles in order with Kahan-compensated f32."""
    n = codes.shape[0]
    nf = values.shape[0]
    dev = codes.device
    tiles = n // TILE
    g1 = num_groups + 1
    mask = valid & pred_mask & (codes >= 0) & (codes < num_groups)
    slot = torch.where(mask, codes, num_groups).long()
    slot += torch.arange(tiles, device=dev).repeat_interleave(TILE) * g1
    parts = torch.zeros((1 + nf, tiles * g1), dtype=torch.float32, device=dev)
    parts[0].index_add_(0, slot, mask.float())
    for k in range(nf):
        parts[k + 1].index_add_(0, slot, torch.where(mask, values[k], 0.0))
    parts = parts.view(1 + nf, tiles, g1)[:, :, :num_groups]
    s = torch.zeros((1 + nf, num_groups), dtype=torch.float32, device=dev)
    c = torch.zeros_like(s)
    for t in range(tiles):
        y = parts[:, t] - c
        u = s + y
        c = (u - s) - y
        s = u
    out = s - c
    return out[0], out[1:]


def fused_group_multi(codes, pred_mask, values, valid, *, num_groups: int):
    """Filtered per-group (count, per-field sums) in one pass.

    codes: int32 [N]; pred_mask: bool [N]; values: f32 [F, N]; valid:
    bool [N]; N a multiple of TILE.  -> (count f32 [G], sums f32 [F, G]).
    Rows whose code lies outside [0, G) count nowhere."""
    n = codes.shape[0]
    if n % TILE:
        raise ValueError(f"N={n} must be a multiple of {TILE}")
    if num_groups < 1:
        raise ValueError(f"num_groups={num_groups} must be positive")
    nf = values.shape[0] if values.dim() == 2 else -1
    dev = codes.device
    _expect(codes, "codes", torch.int32, (n,), dev)
    _expect(pred_mask, "pred_mask", torch.bool, (n,), dev)
    _expect(values, "values", torch.float32, (nf, n), dev)
    _expect(valid, "valid", torch.bool, (n,), dev)
    if dev.type != "cuda":
        return fused_group_multi_plain(codes, pred_mask, values, valid, num_groups)
    count = torch.empty(num_groups, dtype=torch.float32, device=dev)
    sums = torch.empty((nf, num_groups), dtype=torch.float32, device=dev)
    if n == 0:
        return count.zero_(), sums.zero_()
    gt = _group_tile(num_groups, nf)
    gpad = -(-num_groups // gt) * gt
    if gpad // gt > 65535:
        raise ValueError(f"num_groups={num_groups} exceeds the group grid")
    build()
    partials = torch.empty(
        (n // TILE, 1 + nf, gpad), dtype=torch.float32, device=dev
    )
    rc = _lib.bydb_fused_group_multi(
        codes.data_ptr(), pred_mask.data_ptr(), values.data_ptr(),
        valid.data_ptr(), n, nf, num_groups, gt, partials.data_ptr(),
        count.data_ptr(), sums.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_rc(rc, "fused_group_multi")
    LAUNCHES["fused_group_multi"] += 1
    return count, sums


def fused_group_sum(codes, pred_mask, values, valid, *, num_groups: int):
    """Single-field wrapper around fused_group_multi.

    values: f32 [N].  -> (count f32 [G], sum f32 [G])"""
    count, sums = fused_group_multi(
        codes, pred_mask, values.reshape(1, -1), valid, num_groups=num_groups
    )
    if codes.is_cuda and codes.shape[0]:
        LAUNCHES["fused_group_sum"] += 1
    return count, sums[0]


# -- widen_narrow -------------------------------------------------------------


def widen_narrow_plain(x):
    return x.to(torch.int32)


def widen_narrow(x):
    """Narrow i8/i16 column [N] -> i32; N a multiple of TILE."""
    if x.dim() != 1:
        raise ValueError(f"widen_narrow takes 1-D input, got {tuple(x.shape)}")
    n = x.shape[0]
    if n % TILE:
        raise ValueError(f"N={n} must be a multiple of {TILE}")
    if x.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"widen_narrow takes i8/i16, got {x.dtype}")
    _expect(x, "x", x.dtype, (n,), x.device)
    if x.device.type != "cuda":
        return widen_narrow_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("widen_narrow: input not 16-byte aligned")
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    build()
    rc = _lib.bydb_widen_narrow(
        x.data_ptr(), x.element_size(), n, out.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_rc(rc, "widen_narrow")
    LAUNCHES["widen_narrow"] += 1
    return out


# -- prefix_sum_narrow --------------------------------------------------------


def prefix_sum_narrow_plain(x):
    """Plain PyTorch version: per-TILE inclusive sums plus the carry of
    the tiles before, in i64, wrapped back to i32 (mod 2^32)."""
    tiles = x.shape[0] // TILE
    v = x.view(tiles, TILE).to(torch.int64).cumsum(1)
    carry = torch.cumsum(v[:, -1], 0) - v[:, -1]
    v = (v + carry[:, None] + 2**31).remainder(2**32) - 2**31
    return v.to(torch.int32).reshape(-1)


def prefix_sum_narrow(x):
    """Inclusive i32 prefix sum of [N] (N a multiple of TILE), wrapping
    mod 2^32.  With x[0] = first and x[1:] = deltas, the output is the
    decoded series."""
    if x.dim() != 1:
        raise ValueError(
            f"prefix_sum_narrow takes 1-D input, got {tuple(x.shape)}"
        )
    n = x.shape[0]
    if n % TILE:
        raise ValueError(f"N={n} must be a multiple of {TILE}")
    _expect(x, "x", torch.int32, (n,), x.device)
    if x.device.type != "cuda":
        return prefix_sum_narrow_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("prefix_sum_narrow: input not 16-byte aligned")
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    build()
    scratch = torch.empty(n // TILE, dtype=torch.int32, device=x.device)
    rc = _lib.bydb_prefix_sum_narrow(
        x.data_ptr(), n, scratch.data_ptr(), out.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_rc(rc, "prefix_sum_narrow")
    LAUNCHES["prefix_sum_narrow"] += 1
    return out
