"""Placement algorithms — the *control plane* of the similarity-cache
network (paper §3). Counterpart of ``repro.core.placement`` for the
slice ported so far:

- host NumPy (``greedy``, ``localswap``, ``localswap_polish``,
  ``greedy_then_localswap``) — the readable differential oracles;
- on the device (``device_greedy``, ``device_localswap``,
  ``device_localswap_polish``, ``device_greedy_then_localswap`` in
  placement/device.py) — the same algorithms over a
  ``core.objective.DeviceInstance`` and the batched gain oracle
  (kernel C). This is the path ``serve.engine.refresh_placement`` takes
  by default.

``netduel`` (§5) is the online λ-unaware policy, ``device_netduel`` its
scan on the device (kernel F on the card) and ``DuelPlane`` that scan
inside the serving engine. The continuous limit and the warm start are
a later slice (ROADMAP queue 1, item 12).
"""
from repro_torch.core.placement.cascade import greedy_then_localswap
from repro_torch.core.placement.device import (device_greedy,
                                               device_greedy_then_localswap,
                                               device_localswap,
                                               device_localswap_polish)
from repro_torch.core.placement.greedy import greedy
from repro_torch.core.placement.localswap import localswap, localswap_polish
from repro_torch.core.placement.netduel import (DuelPlane, device_netduel,
                                                netduel)

__all__ = ["greedy", "localswap", "localswap_polish", "netduel",
           "device_netduel", "DuelPlane", "greedy_then_localswap",
           "device_greedy", "device_localswap", "device_localswap_polish",
           "device_greedy_then_localswap"]
