"""Storage substrate: columnar parts and memtables, carried from
banyandb_tpu.storage (shared on-disk format)."""
