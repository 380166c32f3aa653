from . import sharded, sharded3d
from .sharded import make_mesh

__all__ = ["sharded", "sharded3d", "make_mesh"]
