#!/usr/bin/env python3
"""Where the time of the hand-written Hopper kernels goes, on one card.

    python3 chip_ablation.py

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``.  It builds copies of ``banyandb_tpu_torch/csrc/fused_group.cu``
and ``csrc/prefix_sum.cu`` with one part switched off or replaced (a
named string edit of the source; the edit must still match, or the
script stops), loads each with ``ctypes`` beside the real kernel, and
prints per variant the profiler device time per call, with the L2
flushed before each call (a read of 64 MB, as ``chip_smoke.py`` times
its kernels) and warm.  Variants that drop work give wrong results and
are only timed.

``fused_group_multi`` (N = 1,048,576, F = 2, G = 1,024, uniform codes and
rows stored by series):

- ``base``: the kernel as built by the package;
- ``no_rows``: no warp reads or reduces rows (launch, zeroing, block
  barriers, the per-round fold and the pairs written, then fold_pairs);
- ``no_reduce``: the rows are loaded, not reduced;
- ``no_fold``: no per-round fold of the warp copies;
- ``no_tag``: every step takes ``__match_any_sync``;
- ``depth1``, ``depth4``: one or four 128-row steps in flight a warp
  instead of two;
- ``fake_match``: ``__match_any_sync`` replaced by one ballot.

Then a clock64 timeline of ``group_rows`` (cycles from the block's start
per warp: first rows in registers, first 128-row step done, all rows
done, the block barrier, the end), warm and after the flush.

``prefix_sum_narrow`` (N = 1,048,576): ``base``, ``no_lookback`` (every
block publishes at once: the floor of its loads and stores) and
``acquire`` (acquire/release status words instead of relaxed), beside
``torch.cumsum``.

``python3 chip_ablation.py --kernels TREE`` instead times the kernel
wrappers of the checkout at TREE (another commit unpacked with ``git
archive``) the same way, at the main path's shapes: ``fused_group_multi``
on both layouts, ``prefix_sum_narrow`` and ``widen_narrow``.  Run it for
the parent and the change in turns in one call to compare them on one
card.

The last line is ``{"ok": true, ...}``; the script exits 2 without a
card and 1 if a variant fails to build.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke as cs

N = 1 << 20
F = 2
G = 1024

FG = {
    "base": [],
    "no_rows": [("if (tile < t1) {", "if (false) {")],
    "no_reduce": [(
        "reduce_rows<NF>(buf[s % D], g0, gt, g, wacc, tags + warp, lane);",
        "if (buf[s % D].code.x == 0x7fffffff) wacc[0] += buf[s % D].val[0].x"
        " + (float)buf[s % D].pred + (float)buf[s % D].valid;",
    )],
    "no_fold": [(
        "if (round + q >= t1) break;",
        "break;",
    )],
    "no_tag": [("if (!__any_sync(kFull, adds && tag[key * kWarps] != lane + 1)) {",
                "if (false) {")],
    "depth1": [("constexpr int kDepth = 2;", "constexpr int kDepth = 1;")],
    "depth4": [("constexpr int kDepth = 2;", "constexpr int kDepth = 4;")],
    "fake_match": [(
        "const unsigned peers = __match_any_sync(kFull, key);",
        "const int k0 = __shfl_sync(kFull, key, 0);"
        " const unsigned b0 = __ballot_sync(kFull, key == k0);"
        " const unsigned peers = key == k0 ? b0 : (1u << lane);",
    )],
}
TIMELINE = [
    ("namespace {\n\nconstexpr int kTile",
     "__device__ long long g_dbg[132 * 16 * 8];\nnamespace {\n\nconstexpr int kTile"),
    ("  const long long t1 = (long long)(blockIdx.x + 1) * tiles / gridDim.x;\n",
     "  const long long t1 = (long long)(blockIdx.x + 1) * tiles / gridDim.x;\n"
     "  const long long T0 = clock64();\n"
     "  long long* dbg = g_dbg + (blockIdx.x * 16 + (threadIdx.x >> 5)) * 8;\n"),
    ("        reduce_rows<NF>(buf[s % D], g0, gt, g, wacc, tags + warp, lane);\n",
     "        if (s == 0 && round == t0) {\n"
     "          if (buf[0].val[0].x + (float)buf[0].code.x == 12345.f) wacc[1] = 1.f;\n"
     "          dbg[1] = clock64() - T0;\n"
     "        }\n"
     "        reduce_rows<NF>(buf[s % D], g0, gt, g, wacc, tags + warp, lane);\n"
     "        if (s == 0 && round == t0) dbg[2] = clock64() - T0;\n"),
    ("    __syncthreads();\n    // -- fold: each tile's partial",
     "    if (round == t0) dbg[3] = clock64() - T0;\n    __syncthreads();\n"
     "    if (round == t0) dbg[4] = clock64() - T0;\n    // -- fold: each tile's partial"),
    ("  float* out = pairs + (long long)blockIdx.x * 2 * (1 + NF) * gpad;\n",
     "  dbg[5] = clock64() - T0;\n"
     "  float* out = pairs + (long long)blockIdx.x * 2 * (1 + NF) * gpad;\n"),
    ('extern "C" int bydb_fused_group_multi(',
     'extern "C" int dbg_copy(void* dst) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, g_dbg, sizeof(g_dbg));\n}\n"
     'extern "C" int bydb_fused_group_multi('),
]
PS = {
    "base": [],
    "no_lookback": [("if (tile == 0) {", "if (true) {")],
    "acquire": [
        ("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
        ("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64"),
    ],
}


def build(hk, tmp: str, variants: dict) -> dict:
    """nvcc every (name -> (source, edits)) in parallel; -> name -> CDLL."""
    nvcc = hk._nvcc()
    procs = {}
    for name, (src, edits) in variants.items():
        text = (hk.CSRC_DIR / src).read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"chip_ablation: edit of {name} no longer matches {src}")
            text = text.replace(old, new)
        cu = os.path.join(tmp, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *hk.NVCC_FLAGS, "-shared", cu, "-o", cu[:-3] + ".so"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(out[-4000:], file=sys.stderr)
            raise SystemExit(1)
        libs[name] = ctypes.CDLL(os.path.join(tmp, name + ".so"))
    return libs


def group_call(hk, lib, args):
    import torch

    codes, pred, vals, valid = args
    gt = hk._group_tile(G, F)
    blocks = len(hk._partition(N, F, G))
    gpad = -(-G // gt) * gt
    pairs = torch.empty((blocks, 2, 1 + F, gpad), device="cuda")
    count = torch.empty(G, device="cuda")
    sums = torch.empty((F, G), device="cuda")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.bydb_fused_group_multi
    fn.argtypes = [p, p, p, p, ll, i, i, i, i, p, p, p, i, p]
    st = torch.cuda.current_stream().cuda_stream
    return lambda: fn(
        codes.data_ptr(), pred.data_ptr(), vals.data_ptr(), valid.data_ptr(),
        N, F, G, gt, blocks, pairs.data_ptr(), count.data_ptr(),
        sums.data_ptr(), 0, st,
    )


def times(fn) -> str:
    cold = cs.device_profile(fn, 50, cold=True)
    warm = cs.device_profile(fn, 50)
    parts = {k.split("(")[0].split("::")[-1]: round(v * 1e3, 3)
             for k, v in cold.items() if k != "total"}
    return (f"cold {cold['total'] * 1e3:.3f} us {parts}, "
            f"warm {warm['total'] * 1e3:.3f} us")


def timeline(lib, call) -> None:
    import torch

    for state in ("warm", "cold"):
        call()
        torch.cuda.synchronize()
        if state == "cold":
            cs.flush_l2()
        call()
        torch.cuda.synchronize()
        d = np.zeros(132 * 16 * 8, np.int64)
        lib.dbg_copy(ctypes.c_void_p(d.ctypes.data))
        d = d.reshape(132, 16, 8)
        act = d[:, :, 2] > 0
        pct = lambda a: np.percentile(a, [10, 50, 90]).astype(int).tolist()
        print(f"    {state}: cycles p10/p50/p90 — first rows {pct(d[:, :, 1][act])}, "
              f"first step {pct((d[:, :, 2] - d[:, :, 1])[act])}, rows done "
              f"{pct(d[:, :, 3][act])}, barrier {pct(d[:, :, 4][act])}, end "
              f"{pct(d[:, :, 5])}", flush=True)


def kernels(tree: str) -> None:
    """Time the kernel wrappers of the checkout at `tree`."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    print(f"kernels of {tree} ({hk.__file__}), device time per call:", flush=True)
    for layout in ("uniform", "sorted"):
        codes, pred, vals, valid = cs.group_inputs(N, F, G, False, 9, layout)
        fn = lambda: hk.fused_group_multi(codes, pred, vals, valid, num_groups=G)
        print(f"  fused_group_multi {layout:7s} {times(fn)}", flush=True)
    x = torch.from_numpy(
        np.random.default_rng(1).integers(-4096, 4096, N).astype(np.int32)
    ).cuda()
    print(f"  prefix_sum_narrow         {times(lambda: hk.prefix_sum_narrow(x))}")
    w = torch.from_numpy(
        np.random.default_rng(2).integers(0, 1024, N).astype(np.int16)
    ).cuda()
    print(f"  widen_narrow              {times(lambda: hk.widen_narrow(w))}")


def main() -> int:
    try:
        import torch
    except ImportError:
        return 2
    if not torch.cuda.is_available():
        print("chip_ablation: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels":
        kernels(sys.argv[2])
        return 0
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    variants = {f"fg_{k}": ("fused_group.cu", v) for k, v in FG.items()}
    variants["fg_timeline"] = ("fused_group.cu", TIMELINE)
    variants.update({f"ps_{k}": ("prefix_sum.cu", v) for k, v in PS.items()})
    hk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=hk.BUILD_DIR) as tmp:
        libs = build(hk, tmp, variants)
        print(f"fused_group_multi N={N} F={F} G={G}, device time per call:", flush=True)
        for layout in ("uniform", "sorted"):
            args = cs.group_inputs(N, F, G, False, 9, layout)
            for name in FG:
                print(f"  {layout:7s} {name:10s} "
                      f"{times(group_call(hk, libs['fg_' + name], args))}", flush=True)
            print(f"  {layout} timeline of group_rows:", flush=True)
            timeline(libs["fg_timeline"], group_call(hk, libs["fg_timeline"], args))

        x = torch.from_numpy(
            np.random.default_rng(1).integers(-4096, 4096, N).astype(np.int32)
        ).cuda()
        out = torch.empty_like(x)
        st = torch.cuda.current_stream().cuda_stream
        print(f"prefix_sum_narrow N={N}, device time per call:", flush=True)
        for name in PS:
            fn = libs["ps_" + name].bydb_prefix_sum_narrow
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
            state = torch.zeros(-(-N // hk._SCAN_TILE), dtype=torch.int64, device="cuda")
            epoch = [0]

            def call(fn=fn, state=state, epoch=epoch):
                epoch[0] += 1
                fn(x.data_ptr(), N, state.data_ptr(), epoch[0], out.data_ptr(), 0, st)

            print(f"  {name:12s} {times(call)}", flush=True)
        print(f"  torch.cumsum {times(lambda: torch.cumsum(x, 0, dtype=torch.int32))}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
