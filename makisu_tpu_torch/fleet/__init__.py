"""The SLO plane's worker half (``slo.py``): burn-rate math, rules and
the evaluator a worker runs over its own vitals. The fleet front door,
its scheduler and canary builds are not ported yet."""
