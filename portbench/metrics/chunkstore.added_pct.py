"""chunkstore.added_pct: the bytes the chunk index added over the bytes
of the layers it indexed, over the window's builds, in % (dedup's yield:
after a 1% edit, a small share)."""


def read(run):
    total = sum(r.get("bytes_total") or 0 for r in run.records)
    if not total:
        return None
    return 100.0 * sum(r.get("bytes_added") or 0
                       for r in run.records) / total
