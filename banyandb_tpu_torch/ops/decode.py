"""Device-side decode on torch tensors.

The on-disk format (utils/encoding) stores *fixed-width* deltas and
dictionary codes; the prefix-sum reconstruction, dictionary gather and
the narrow -> wide conversions run on the device where they feed the
scan pipeline.  Gathers clamp out-of-range indices (the JAX package's
``jnp.take(mode="clip")``): torch indexing would raise instead.
"""

from __future__ import annotations

import numpy as np
import torch

from banyandb_tpu_torch.ops import hopper_kernels

_NARROW = (torch.int8, torch.int16)


def delta_decode(first, deltas):
    """Reconstruct the FULL series of ``len(deltas) + 1`` values:
    out[0] == first, out[i] == first + sum(deltas[:i]).

    Narrow i8/i16 payloads widen to i32 first (a narrow cumsum would
    wrap), so the output dtype is max(deltas.dtype, i32).  A concrete
    ``first`` that does not fit the i32 width raises instead of
    wrapping.  1-D i32 deltas on a CUDA tensor whose length + 1 is a
    TILE multiple route through the Hopper prefix-sum kernel
    (ops.hopper_kernels.prefix_sum_narrow), as the JAX package routed
    that shape class to its Pallas kernel on a TPU; every other shape
    runs ``torch.cumsum``.  Both wrap mod 2^32 alike."""
    if deltas.dtype in _NARROW:
        deltas = deltas.to(torch.int32)
    if (
        isinstance(first, (int, np.integer))
        and deltas.dtype == torch.int32
        and not -(2**31) <= first < 2**31
    ):
        raise ValueError(
            f"first={first} does not fit the i32 decode width; "
            "rebase it to an epoch offset (ts - epoch) or pass i64 deltas"
        )
    first = torch.as_tensor(first, dtype=deltas.dtype, device=deltas.device)
    if (
        deltas.is_cuda
        and deltas.dim() == 1
        and deltas.dtype == torch.int32
        and (deltas.shape[0] + 1) % hopper_kernels.TILE == 0
    ):
        return hopper_kernels.prefix_sum_narrow(
            torch.cat([first.reshape(1), deltas])
        )
    rest = first[..., None] + torch.cumsum(deltas, dim=-1, dtype=deltas.dtype)
    head = first[..., None].expand(rest.shape[:-1] + (1,))
    return torch.cat([head, rest], dim=-1)


def dod_decode(first, first_delta, dods):
    """Delta-of-delta decode: out[0] == first,
    out[i] == out[i-1] + (first_delta + sum(dods[:i]))."""
    first = torch.as_tensor(first, dtype=dods.dtype, device=dods.device)
    deltas = first_delta + torch.cumsum(dods, dim=-1, dtype=dods.dtype)
    rest = first[..., None] + torch.cumsum(deltas, dim=-1, dtype=deltas.dtype)
    head = first[..., None].expand(rest.shape[:-1] + (1,))
    return torch.cat([head, rest], dim=-1)


def dict_gather(dictionary, codes):
    """out[i] = dictionary[codes[i]]; out-of-range codes clamp to the
    dictionary bounds (a corrupt code never reads another slot)."""
    idx = codes.long().clamp(0, dictionary.shape[0] - 1)
    return dictionary[idx]


def widen_codes(codes):
    """Narrow stored-width dict codes (i8/i16) -> i32."""
    return codes.to(torch.int32)


def dict_remap(codes, lut2d, src_ord):
    """Local -> global dictionary code remap.

    ``codes``: narrow per-row LOCAL codes (any shape); ``src_ord``: the
    per-row source ordinal (same shape); ``lut2d``: ``[S, L]`` i32 table
    whose row ``s`` maps source s's local codes to global codes
    (storage/encoded.pack_luts).  The flattened gather clamps (OOB
    guard) — in range by construction, never wrapping on corrupt input.
    """
    flat = lut2d.reshape(-1)
    idx = src_ord.to(torch.int32) * lut2d.shape[-1] + codes.to(torch.int32)
    return flat[idx.long().clamp(0, flat.shape[0] - 1)]


def ints_to_f32(vals):
    """Narrow int field column -> f32; exact for every i8/i16 value."""
    return vals.to(torch.float32)


def decode_chunk(chunk: dict) -> dict:
    """The device-side decode stage: encoded chunk -> the canonical
    chunk the plan body consumes.

    Encoded chunks carry (measure_exec._device_chunk /
    fused_exec._stacked_chunks):

    - ``tags_enc``  narrow local dict codes per tag column
    - ``tags_lut``  [S, L] local->global LUT per tag column
    - ``src_ord``   per-row source ordinal (shared by all tag columns)
    - ``fields_enc``  narrow exact-int field columns

    Chunks without those keys (``BYDB_DEVICE_DECODE=0``) pass through
    unchanged, which is what makes the A/B flag a pure ship-form flip.
    """
    if "tags_enc" not in chunk and "fields_enc" not in chunk:
        return chunk
    out = {
        k: v
        for k, v in chunk.items()
        if k not in ("tags_enc", "tags_lut", "src_ord", "fields_enc")
    }
    tags_code = dict(out.get("tags_code", {}))
    for t, codes in chunk.get("tags_enc", {}).items():
        tags_code[t] = dict_remap(
            _maybe_kernel_widen(codes), chunk["tags_lut"][t], chunk["src_ord"]
        )
    out["tags_code"] = tags_code
    fields = dict(out.get("fields", {}))
    for f, vals in chunk.get("fields_enc", {}).items():
        fields[f] = ints_to_f32(_maybe_kernel_widen(vals))
    out["fields"] = fields
    return out


def _maybe_kernel_widen(vals):
    """Route the i8/i16 widen through the Hopper kernel
    (ops.hopper_kernels.widen_narrow) for a 1-D CUDA tensor whose length
    is a TILE multiple — the staged executor's chunks; everything else
    (CPU tensors, the fused executor's [C, nrows] batches) passes
    through to the plain conversion of its caller."""
    if not vals.is_cuda or vals.dim() != 1 or vals.dtype not in _NARROW:
        return vals
    if vals.shape[0] % hopper_kernels.TILE != 0:
        return vals
    return hopper_kernels.widen_narrow(vals)
