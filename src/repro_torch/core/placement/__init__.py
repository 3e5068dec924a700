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
inside the serving engine. ``continuous`` is the §4
continuous-relaxation analysis; ``warmstart`` turns it into the
near-O(O) placement path (classify the topology, solve the continuous
program, band-map per Prop 4.2, polish with a bounded device-LOCALSWAP
window) — the route past catalogs where the O(O·J) discrete solvers
cannot run.
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
from repro_torch.core.placement import continuous
from repro_torch.core.placement import warmstart
from repro_torch.core.placement.warmstart import (WarmStartReport,
                                                  classify_topology,
                                                  warm_start)

__all__ = ["greedy", "localswap", "localswap_polish", "netduel",
           "device_netduel", "DuelPlane", "greedy_then_localswap",
           "device_greedy", "device_localswap", "device_localswap_polish",
           "device_greedy_then_localswap", "continuous", "warmstart",
           "warm_start", "classify_topology", "WarmStartReport"]
