from repro_torch.serve.engine import (EngineConfig, PlacementBuffer,
                                      ServeStats, SimCacheEngine,
                                      bucket_size)

__all__ = ["SimCacheEngine", "EngineConfig", "ServeStats",
           "PlacementBuffer", "bucket_size"]
