"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.dryrun`` and ``python -m
repro_torch.launch.reanalyze``), the shard meshes and the card's peak
constants (``mesh``), the shard policies of the language models and of
the similarity cache (``sharding``), and the dry run's specs and
roofline (``specs``, ``roofline``)."""
