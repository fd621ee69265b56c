"""The solver mesh (parallel/mesh.py): one solve over several devices."""

from .mesh import Mesh, make_mesh, sharded_solve_fn

__all__ = ["Mesh", "make_mesh", "sharded_solve_fn"]
