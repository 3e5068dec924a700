"""Core library: the paper's contribution (similarity-cache placement).

Counterpart of ``repro.core``: costs, topology, catalog and demand (the
problem building blocks), ``objective`` (eqs. (1)-(4), host and device),
``placement`` (GREEDY, LOCALSWAP, the cascade, NETDUEL, the continuous
limit and the warm start), ``simcache`` (the runtime lookup),
``scenarios`` (general-graph scenario generation), ``routing``
(``StrategyPlane``, the on-path LRU routing strategies) and ``analysis``
(the Che hit-rate plane and the engine's refresh surrogate). Submodules
are imported by path; nothing is loaded here.
"""
