"""Subpackage of the PyTorch port: the multi-device path over
``torch.distributed`` (``sharded.py``: the mesh, the collectives and the
query-sharded odometry; ``map_fusion.py``: the map-sharded backend;
``dist_fusion.py``: the query-sharded backend)."""
from .dist_fusion import make_distributed_fusion, make_sharded_state

__all__ = ["make_distributed_fusion", "make_sharded_state"]
