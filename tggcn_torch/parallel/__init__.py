"""Data-parallel training over processes (counterpart of ``tggcn/parallel``)."""

from tggcn_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
