"""Mesh encoders: the phase-1 search over ('gop', 'tile') axes, one launch
set for every shard on one card, or one a shard on its own device. See
mesh.py."""
from .mesh import (Mesh, MeshEncoder, MeshGopEncoder, build_gop_mesh,
                   build_mesh, tile_grid_for)

__all__ = ["Mesh", "MeshEncoder", "MeshGopEncoder", "build_gop_mesh",
           "build_mesh", "tile_grid_for"]
