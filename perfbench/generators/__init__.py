"""Traffic generators found by name: a mix that gives ``"generator":
"<name>"`` is drawn by ``generators/<name>.py``, whose ``make_pool(mix,
n, batch, seed, device)`` returns a ``core.traffic.Pool``. A mix without
one is drawn by ``core/traffic.py``'s Criteo generator."""
