from repro_torch.serve.engine import (EngineConfig, PlacementBuffer,
                                      ServeStats, SimCacheEngine,
                                      bucket_size)
from repro_torch.serve.stream import (DriverStats, RequestStream,
                                      StreamDriver, StreamSpec)

__all__ = ["SimCacheEngine", "EngineConfig", "ServeStats",
           "PlacementBuffer", "bucket_size", "StreamDriver", "StreamSpec",
           "RequestStream", "DriverStats"]
