"""Subpackage of the PyTorch port: the multi-device path over
``torch.distributed`` (``sharded.py``: the mesh, the collectives and the
query-sharded odometry; ``map_fusion.py``: the map-sharded backend)."""
