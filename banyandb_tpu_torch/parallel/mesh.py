"""Mesh construction helpers.

Axis vocabulary (DB analog of dp/tp/sp):
- ``shard``: data parallelism over storage shards — each slot scans the
  rows its shard owns (the reference's per-data-node scan).
- ``seg``: segment/time parallelism within a shard — blocks of the same
  shard spread over a second axis (the reference scans segments
  concurrently per node).

A mesh is a row-major grid of slots, each bound to a ``torch.device``.
Slots may share a device (``devices=[dev] * n``): the slots' scans then
run one after another on it, with the same partials and the same
cross-slot reduction as on distinct devices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from banyandb_tpu_torch.backend import resolve_device


@dataclass(frozen=True)
class Mesh:
    """('shard', 'seg') grid of device slots, flattened row-major."""

    devices: tuple[torch.device, ...]
    n_shard: int
    n_seg: int
    axis_names = ("shard", "seg")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {"shard": self.n_shard, "seg": self.n_seg}


def make_mesh(n_shard: int, n_seg: int = 1, *, devices=None) -> Mesh:
    """-> the n_shard x n_seg mesh over the first n_shard * n_seg of
    `devices` (default: every CUDA device present).  Raises when there
    are too few."""
    if devices is None:
        devices = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]
    need = n_shard * n_seg
    if len(devices) < need:
        raise ValueError(
            f"mesh {n_shard}x{n_seg} needs {need} devices, have {len(devices)}"
        )
    slots = tuple(resolve_device(d) for d in devices[:need])
    return Mesh(slots, n_shard, n_seg)


def shard_axis_size(mesh: Mesh) -> int:
    return mesh.shape["shard"]
