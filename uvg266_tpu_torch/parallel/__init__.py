"""Mesh encoders on one card: the phase-1 search batched over ('gop',
'tile') axes. See mesh.py."""
from .mesh import (MeshEncoder, MeshGopEncoder, build_gop_mesh,
                   build_mesh, tile_grid_for)

__all__ = ["MeshEncoder", "MeshGopEncoder", "build_gop_mesh",
           "build_mesh", "tile_grid_for"]
