"""The port's own copies of ``repro.data`` (TID indexer, prefetching loader)."""
