"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``), and the shard meshes (``mesh``) and the
lookup shard policy (``sharding``) of the sharded planes."""
