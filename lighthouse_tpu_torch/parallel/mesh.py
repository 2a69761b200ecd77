"""The device mesh of the sharded batch verify, and its batch-axis split.

Counterpart: ``lighthouse_tpu/parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` with one axis, ``"batch"``, and XLA partitions each
stage over it. Here a mesh is an ordered tuple of ``torch.device``, the
lead device first, and ``ops/backend.py`` runs each shard's stages on its
own device and joins the shards on the lead.

The batch-minor layout puts the batch on the last axis of every staged
tensor (``(..., 12, n)`` field elements), so a batch is split by slicing
that axis: ``shard_minor`` stands for JAX's ``minor_sharding`` plus
``shard_batch_minor``, ``replicated`` for its ``replicated``. JAX's
batch-major helpers (``batch_sharding``, ``shard_batch``) serve the
batch-major engine, which the port leaves out.

A mesh may name one device more than once, so that one card (or the CPU,
in tests) carries a 2- or 4-shard layout: the shards then run one after
another on it.
"""

from typing import Optional, Sequence, Tuple

import torch

from ..ops import limbs as lb

BATCH_AXIS = "batch"


def _indexed(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def get_mesh(n_devices: Optional[int] = None,
             devices: Optional[Sequence] = None) -> Tuple[torch.device, ...]:
    """The mesh over `devices` (default: every visible CUDA device, which
    raises without a card, as ``limbs.default_device`` does), cut to its
    first `n_devices`. A CUDA device without an index is the current one."""
    if devices is None:
        lb.default_device()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(_indexed(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(mesh):
            raise ValueError(f"a mesh of {n_devices} devices from {len(mesh)}")
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("an empty mesh")
    return mesh


def _moved(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`x` on `device`, contiguous. From the host to the card the copy is
    pinned and does not block, queued on the card's current stream."""
    x = x.contiguous()
    if x.device.type == "cpu" and device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def shard_minor(x: torch.Tensor, mesh: Sequence[torch.device]) -> list:
    """The len(mesh) equal slices of `x`'s trailing (batch) axis, slice i
    on mesh[i]. The trailing axis must divide by the mesh size (staging
    floors the n and m buckets at it)."""
    d = len(mesh)
    n = x.shape[-1]
    assert n % d == 0, (tuple(x.shape), d)
    w = n // d
    return [_moved(x[..., i * w:(i + 1) * w], dev) for i, dev in enumerate(mesh)]


def replicated(x: torch.Tensor, mesh: Sequence[torch.device]) -> list:
    """`x` on each device of the mesh."""
    return [_moved(x, dev) for dev in mesh]
