"""The fleet's worker half: the SLO plane (``slo.py``: burn-rate math,
rules and the evaluator a worker runs over its own vitals), the peer
chunk exchange (``peers.py``: the peer map a worker holds and the fetch
of missing chunks from sibling workers) and the shared KV endpoint of
multi-worker harnesses (``kv.py``). The fleet front door, its scheduler
and canary builds are not ported yet."""
