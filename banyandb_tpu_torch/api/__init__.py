"""API surface: schema objects and query/write models, carried from
banyandb_tpu.api."""
