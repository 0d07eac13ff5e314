"""The data-parallel mesh (counterpart of ``tggcn/parallel/mesh.py``).

JAX shards the batch axis over a ``data`` mesh of devices and XLA sums the
gradient across it. The port runs one process a device: a ``Mesh`` names
the devices the processes take (rank r takes ``devices[r]``) and the
process groups the gradient is summed over, in turn. ``make_mesh`` is one
group of every process; ``make_mesh_2d`` lays the processes out as a
('dcn', 'data') grid (``torch.distributed.device_mesh``), row i holding
slice i's devices, and sums the gradient within each row first, then
across the rows, the layout multi-slice data parallelism prescribes.
The batch splits over every process in rank order either way.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]     # rank r's device, rank-major over the grid
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Optional[object] = None  # the torch DeviceMesh of a 2-D grid

    def gradient_groups(self) -> tuple:
        """The process groups a gradient is summed over, in turn (None:
        every process)."""
        if self.device_mesh is None:
            return (None,)
        return tuple(self.device_mesh.get_group(name) for name in reversed(self.axis_names))


def _available(device_type: str, wanted: int) -> int:
    """The devices a run can span: the processes of a joined group (one
    device each), else the cards on this host (any number of CPU processes)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return wanted


def _devices(device_type: str, count: int) -> Tuple[torch.device, ...]:
    if device_type != "cuda":
        return (torch.device("cpu"),) * count
    cards = max(torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1
    return tuple(torch.device("cuda", r % cards) for r in range(count))


def make_mesh(num_devices: Optional[int] = None, device_type: str = "cuda",
              axis_name: str = "data") -> Mesh:
    """A 1-D mesh over num_devices devices (default: every process of the
    joined group, else one); raises ValueError when fewer are present."""
    if num_devices is None:
        num_devices = dist.get_world_size() if dist.is_initialized() else 1
    have = _available(device_type, num_devices)
    if have < num_devices:
        raise ValueError(f"Requested {num_devices} devices, have {have}")
    return Mesh(_devices(device_type, num_devices), (num_devices,), (axis_name,))


def make_mesh_2d(num_slices: int, devices_per_slice: int, device_type: str = "cuda") -> Mesh:
    """A ('dcn', 'data') mesh over the joined process group of
    num_slices * devices_per_slice processes; raises ValueError when
    fewer are present."""
    need = num_slices * devices_per_slice
    have = _available(device_type, need) if dist.is_initialized() else 0
    if have < need:
        raise ValueError(f"Requested {need} devices, have {have}")
    from torch.distributed.device_mesh import init_device_mesh

    grid = init_device_mesh(device_type, (num_slices, devices_per_slice),
                            mesh_dim_names=("dcn", "data"))
    return Mesh(_devices(device_type, need), (num_slices, devices_per_slice), ("dcn", "data"),
                device_mesh=grid)
