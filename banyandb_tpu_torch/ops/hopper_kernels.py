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
into one shared library with a plain C interface (one ``nvcc -c`` per
source, all started together, then one link), and bound with
``ctypes``.  Each C entry returns ``cudaGetLastError()``.  The library
lives in the build cache's directory (``utils/compile_cache``: the
explicit path, ``BYDB_COMPILE_CACHE_DIR`` or the caller's default),
else under the package's ``_build/``; a library already there is
loaded, not rebuilt.

Each wrapper checks its inputs and calls its op in the ``bydb``
``torch.library`` namespace: the op's CPU implementation is the plain
version, its CUDA implementation launches the kernel, and its fake
implementation computes only the output shapes — the kernel audit
(``lint/kernel``) traces the executors on fake tensors and sees each
kernel as one op; a real tensor never takes that branch.  The ops are
bound with the low-level ``torch.library.Library`` API: the first call
of a ``torch.library.custom_op`` imports some 800 modules (about 2 s on
a CPU), which every cold query would pay.

``fused_group_multi`` replaces pallas_kernels.py::fused_group_multi:
one pass over the rows (fixed row blocks of 2048-row tiles, each
Kahan-folding its tile partials in tile order) and a float-float fold
of the blocks' pairs; ``_partition`` is the block partition and the
tests model the fold order from it.  ``widen_narrow`` replaces
pallas_kernels.py::widen_narrow and ``prefix_sum_narrow`` (one
single-pass decoupled look-back scan) replaces
pallas_kernels.py::prefix_sum_narrow.  What bounds each on the card and
how the design answers it is in the note at the top of its source
(csrc/fused_group.cu, csrc/widen.cu, csrc/prefix_sum.cu).
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
# csrc/fused_group.cu: warps of a row block, each with its own
# shared-memory copy of the [1 + F, group tile] sums; fields per launch;
# shared memory one block may take (227 KB); row blocks per launch over
# all group tiles (one per SM of an H100); chunks of the blocks' fold
_WARPS = 16
_MAX_FIELDS = 4
_SMEM_BUDGET = 232448
_BLOCKS = 132
_FOLD_CHUNKS = 16
# csrc/prefix_sum.cu: rows a scan block takes
_SCAN_TILE = 4096

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
_lib_path: Path | None = None  # where the loaded library lives
_lib_lock = threading.Lock()
# the ops' namespace; its registrations live as long as this object
_ops = torch.library.Library("bydb", "DEF")
_ops.define(
    "fused_group_multi(Tensor codes, Tensor pred_mask, Tensor values, "
    "Tensor valid, int num_groups) -> (Tensor, Tensor)"
)
_ops.define("widen_narrow(Tensor x) -> Tensor")
_ops.define("prefix_sum_narrow(Tensor x) -> Tensor")
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


def build_dir() -> Path:
    """The build cache's directory when one is enabled, else BUILD_DIR."""
    from banyandb_tpu_torch.utils import compile_cache

    d = compile_cache.active_dir()
    return Path(d) if d else BUILD_DIR


def _library_path(directory: Path | None = None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update((CSRC_DIR / src).read_bytes())
    d = build_dir() if directory is None else Path(directory)
    return d / f"libbydb_hopper-{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> str:
    """nvcc every source to an object in parallel, link one .so, and
    move it into place atomically.  -> nvcc's combined output."""
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
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
    build or the load fails.  The build cache counts a build as a miss
    and the load of a library already built as a hit."""
    global _lib, _lib_path, build_log
    if _lib is not None:
        return 0.0
    from banyandb_tpu_torch.utils import compile_cache

    t0 = time.perf_counter()
    with _lib_lock:
        if _lib is not None:
            return 0.0
        so = _library_path()
        hit = so.exists()
        if not hit:
            # bdlint: disable=wp-lock-blocking -- nvcc runs under the
            # load lock on purpose: one thread builds, the others wait
            # for the library instead of racing nvcc over the same file
            build_log = _compile(so)
            compile_cache.note_build(time.perf_counter() - t0)
        t1 = time.perf_counter()
        lib = ctypes.CDLL(str(so))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bydb_fused_group_multi.restype = i
        lib.bydb_fused_group_multi.argtypes = [
            p, p, p, p, ll, i, i, i, i, p, p, p, i, p,
        ]
        lib.bydb_widen_narrow.restype = i
        lib.bydb_widen_narrow.argtypes = [p, i, ll, p, i, p]
        lib.bydb_prefix_sum_narrow.restype = i
        lib.bydb_prefix_sum_narrow.argtypes = [p, ll, p, ctypes.c_uint, p, i, p]
        _lib, _lib_path = lib, so
        compile_cache.note_load(time.perf_counter() - t1, hit)
    return time.perf_counter() - t0


def provide(directory) -> Path:
    """Make the library of the current sources exist in `directory`
    (the package's ``_build/`` when None), so that other processes that
    build there (the worker pool's children) load it instead of running
    ``nvcc``: build and load it in this process first (``build()``),
    then copy it across when this process loaded it from another
    directory (atomically, like the build).  -> its path there."""
    build()
    dst = _library_path(BUILD_DIR if directory is None else Path(directory))
    if not dst.exists():
        dst.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dst.parent, suffix=".so.tmp")
        os.close(fd)
        try:
            shutil.copyfile(_lib_path, tmp)
            os.replace(tmp, dst)
        except BaseException:
            os.unlink(tmp)
            raise
    return dst


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


def _smem_bytes(gt: int, nf: int) -> int:
    """Shared memory of one row block (csrc/fused_group.cu smem_bytes):
    the warps' [1 + F, gt] f32 copies and [gt] byte tags."""
    return 4 * _WARPS * (1 + nf) * gt + _WARPS * gt


def _group_tile(num_groups: int, nf: int) -> int:
    """Group-tile width of one row block: from the fewest group tiles
    (each reads every row once), the 32-padded width that is at most
    2048 and whose copies fit the shared memory."""
    ngt = -(-num_groups // 2048)
    while True:
        per_tile = -(-num_groups // ngt)
        gt = -(-per_tile // 32) * 32
        if _smem_bytes(gt, nf) <= _SMEM_BUDGET:
            return gt
        if gt == 32:
            raise ValueError(f"{nf} fields do not fit one group tile")
        ngt += 1


def _partition(n: int, nf: int, num_groups: int) -> list[tuple[int, int]]:
    """Tile ranges [t0, t1) of the row blocks of one group tile: P
    contiguous ranges of the N / TILE tiles, P fixed by (N, F, G) alone
    (about one block per SM over all group tiles, at most one per tile).
    The kernel computes the same ranges from P."""
    tiles = n // TILE
    if tiles == 0:
        return []
    gt = _group_tile(num_groups, nf)
    p = min(tiles, max(1, _BLOCKS // -(-num_groups // gt)))
    return [(i * tiles // p, (i + 1) * tiles // p) for i in range(p)]


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
    return torch.ops.bydb.fused_group_multi(
        codes, pred_mask, values, valid, num_groups
    )


def _fused_group_multi_cpu(codes, pred_mask, values, valid, num_groups):
    count, sums = fused_group_multi_plain(codes, pred_mask, values, valid, num_groups)
    return count.clone(), sums  # one op's outputs do not alias


@torch.library.register_fake("bydb::fused_group_multi")
def _(codes, pred_mask, values, valid, num_groups):
    return (
        codes.new_empty((num_groups,), dtype=torch.float32),
        codes.new_empty((values.shape[0], num_groups), dtype=torch.float32),
    )


def _fused_group_multi_cuda(codes, pred_mask, values, valid, num_groups):
    n = codes.shape[0]
    nf = values.shape[0]
    dev = codes.device
    count = torch.empty(num_groups, dtype=torch.float32, device=dev)
    sums = torch.empty((nf, num_groups), dtype=torch.float32, device=dev)
    if n == 0:
        return count.zero_(), sums.zero_()
    build()
    # the kernel loads 16-byte vectors
    codes, pred_mask, values, valid = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (codes, pred_mask, values, valid)
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one launch per _MAX_FIELDS fields (the count comes from the first)
    for f0 in range(0, max(nf, 1), _MAX_FIELDS):
        k = min(_MAX_FIELDS, nf - f0)
        gt = _group_tile(num_groups, k)
        gpad = -(-num_groups // gt) * gt
        if gpad // gt > 65535:
            raise ValueError(f"num_groups={num_groups} exceeds the group grid")
        blocks = len(_partition(n, k, num_groups))
        pairs = torch.empty(
            (blocks, 2, 1 + k, gpad), dtype=torch.float32, device=dev
        )
        cnt = count if f0 == 0 else torch.empty_like(count)
        rc = _lib.bydb_fused_group_multi(
            codes.data_ptr(), pred_mask.data_ptr(),
            values.data_ptr() + f0 * n * 4, valid.data_ptr(), n, k,
            num_groups, gt, blocks, pairs.data_ptr(), cnt.data_ptr(),
            sums.data_ptr() + f0 * num_groups * 4, dev.index, stream,
        )
        _check_rc(rc, "fused_group_multi")
    LAUNCHES["fused_group_multi"] += 1
    return count, sums


_ops.impl("fused_group_multi", _fused_group_multi_cpu, "CPU")
_ops.impl("fused_group_multi", _fused_group_multi_cuda, "CUDA")


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
    return torch.ops.bydb.widen_narrow(x)


def _widen_narrow_cuda(x):
    n = x.shape[0]
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


_ops.impl("widen_narrow", widen_narrow_plain, "CPU")
_ops.impl("widen_narrow", _widen_narrow_cuda, "CUDA")


@torch.library.register_fake("bydb::widen_narrow")
def _(x):
    return x.new_empty(x.shape, dtype=torch.int32)


# -- prefix_sum_narrow --------------------------------------------------------

# (device index, stream) -> [status buffer, epoch of its last call]
_scan_states: dict = {}
_scan_lock = threading.Lock()


def _scan_state(dev, stream: int, tiles: int):
    """-> (status buffer, epoch) for one scan call on `stream`.  The
    buffer (one status word per scan tile) is zeroed once when it is
    made or grown; each call gets the next epoch, so words of earlier
    calls read as unpublished (csrc/prefix_sum.cu)."""
    key = (dev.index, stream)
    with _scan_lock:
        st = _scan_states.get(key)
        if st is None or st[0].numel() < tiles or st[1] + 1 >= 1 << 30:
            size = max(tiles, 1024)
            st = [torch.zeros(size, dtype=torch.int64, device=dev), 0]
            _scan_states[key] = st
        st[1] += 1
        return st[0], st[1]


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
    return torch.ops.bydb.prefix_sum_narrow(x)


def _prefix_sum_narrow_cuda(x):
    n = x.shape[0]
    if x.data_ptr() % 16:
        raise ValueError("prefix_sum_narrow: input not 16-byte aligned")
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    state, epoch = _scan_state(x.device, stream, -(-n // _SCAN_TILE))
    rc = _lib.bydb_prefix_sum_narrow(
        x.data_ptr(), n, state.data_ptr(), epoch, out.data_ptr(),
        x.device.index, stream,
    )
    _check_rc(rc, "prefix_sum_narrow")
    LAUNCHES["prefix_sum_narrow"] += 1
    return out


_ops.impl("prefix_sum_narrow", prefix_sum_narrow_plain, "CPU")
_ops.impl("prefix_sum_narrow", _prefix_sum_narrow_cuda, "CUDA")


@torch.library.register_fake("bydb::prefix_sum_narrow")
def _(x):
    return x.new_empty(x.shape, dtype=torch.int32)
