"""Command-line entry points of the port (``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``),
and the shard meshes (``mesh``) and the lookup shard policy
(``sharding``) of the sharded planes."""
