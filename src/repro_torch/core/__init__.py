"""Core library: the paper's contribution (similarity-cache placement).

Counterpart of ``repro.core``: costs, topology, catalog and demand (the
problem building blocks), ``objective`` (eqs. (1)-(4), host and device),
``placement`` (GREEDY, LOCALSWAP, the cascade) and ``simcache`` (the
runtime lookup). Submodules are imported by path; nothing is loaded
here.
"""
