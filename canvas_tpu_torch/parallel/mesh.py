"""Meshes of devices and the placement of lane and position axes on them.

The genome maps onto the devices as in canvas_tpu (SURVEY.md §2.2):
  * the "contig" mesh axis splits per-contig lanes (the reference's
    process-per-chromosome fan-out, CanvasRunner.cs:336-389);
  * the "pos" mesh axis splits the genome position / bin axis inside a
    lane (the reference's per-chromosome memory bound).
Lanes are independent, so a split needs no collectives: each device works
on its own group of lanes, and genome-wide statistics are added where the
results come together.

A mesh's device list may repeat an entry.  [torch.device("cpu")] * 8 or
[torch.device("cuda", 0)] * 4 is a virtual mesh: every split and every
placement happens as on distinct cards, on one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device


def sharding_enabled() -> bool:
    """Multi-device kill switch.

    CANVAS_TPU_FORCE_SINGLE_DEVICE=1 pins all compute to the first device
    of a mesh even when more are given or visible: the multichip dryrun
    uses it to show that the split pipeline equals the single-device one,
    and it is an escape hatch in production."""
    return os.environ.get("CANVAS_TPU_FORCE_SINGLE_DEVICE", "0") != "1"


@dataclass(frozen=True)
class Mesh:
    """Devices laid out on named axes: `devices` is a numpy object array of
    torch.device whose dimensions are the axes in `axis_names`."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, name: str) -> list[torch.device]:
        """The devices along axis `name`, at index 0 of every other axis."""
        k = self.axis_names.index(name)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device; raises through resolve_device where there
    is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axes=("contig",),
              devices=None) -> Mesh:
    """1D (contig) or 2D (contig, pos) mesh over the first n devices of
    `devices`, by default the visible CUDA devices.  A 2D mesh factors n
    into a near-square grid.  Asking for more devices than there are
    raises."""
    devs = visible_devices() if devices is None else \
        [resolve_device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices asked for, {len(devs)} "
                         f"available")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    if len(axes) == 1:
        return Mesh(arr, tuple(axes))
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return Mesh(arr.reshape(a, n // a), tuple(axes))


def lane_devices(device="cuda", devices=None) -> list[torch.device]:
    """The devices a stage splits its lanes over.

    `devices` (a Mesh, whose "contig" axis is taken, or a list) wins; else
    an unindexed "cuda" means every visible card, and any other device
    itself.  With sharding disabled, only the first device.  Asking for a
    missing card raises."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None \
                and torch.cuda.device_count() > 1:
            devs = visible_devices()
        else:
            devs = [dev]
    elif isinstance(devices, Mesh):
        devs = devices.axis_devices("contig" if "contig" in
                                    devices.axis_names
                                    else devices.axis_names[0])
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs if sharding_enabled() else devs[:1]


def split_lanes(x: torch.Tensor, devices: list[torch.device]
                ) -> list[torch.Tensor]:
    """Split the leading lane axis into len(devices) contiguous groups of
    B / n lanes, group k on devices[k]."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} lanes do not split over {n} devices "
                         f"(pad_lanes_to_multiple)")
    return [part.to(dev) for part, dev in zip(torch.chunk(x, n), devices)]


def split_positions(x: torch.Tensor, mesh: Mesh, axis: int = 0
                    ) -> list[torch.Tensor]:
    """Split a position axis over the mesh's "pos" axis (or its only axis)
    into contiguous equal blocks, block k on the axis's k-th device."""
    devs = mesh.axis_devices("pos" if "pos" in mesh.axis_names
                             else mesh.axis_names[0])
    n = len(devs)
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not "
                         f"split over {n} devices")
    return [part.to(dev)
            for part, dev in zip(torch.chunk(x, n, dim=axis), devs)]


def replicate(x: torch.Tensor, devices: list[torch.device]
              ) -> list[torch.Tensor]:
    """x on every device, one copy a device."""
    return [x.to(dev) for dev in devices]


def gather_lanes(parts: list[torch.Tensor], device) -> torch.Tensor:
    """Lane groups back on one device, in lane order."""
    return torch.cat([p.to(device) for p in parts])


def pad_lanes_to_multiple(arr: np.ndarray, mask: np.ndarray, multiple: int):
    """Pad the leading lane axis so it divides the mesh axis size."""
    b = arr.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return arr, mask
    arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    mask = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)])
    return arr, mask
