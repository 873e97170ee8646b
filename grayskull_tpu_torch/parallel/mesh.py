"""A device mesh for the sharded paths: a grid of ``torch.device``s with axis names.

The port's mesh is single-controller, like JAX's: one process drives every
shard, and a shard's tensors live on its device.  A mesh may name one device
several times (``[cuda:0] * 4``), which runs the sharded code, its halo
exchanges and reductions on one card, as JAX's virtual CPU devices do.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape`` does.
    """

    def __init__(self, devices: np.ndarray, axis_names):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} axes with names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        kinds = {d.type for d in devices.flat}
        if len(kinds) > 1:
            raise ValueError(f"mesh mixes device types {sorted(kinds)}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))


def make_mesh(shape=None, axis_names=("data", "space"), devices=None) -> Mesh:
    """Build a device mesh.

    ``devices`` defaults to every CUDA device; an explicit list may repeat a
    device (``[torch.device("cuda", 0)] * 4`` is the port's counterpart of
    JAX's virtual CPU devices) and may be CPU devices, all of one type.
    ``shape`` defaults to all the devices on the first axis.  Unlike
    ``grayskull_tpu.parallel.make_mesh`` there is no fallback to CPU devices:
    with too few devices, or none, it raises.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a CPU mesh")
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), tuple(axis_names)[: len(shape)])
