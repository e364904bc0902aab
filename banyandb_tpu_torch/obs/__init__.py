"""Self-observability: the metric registry and the query tracer,
carried from banyandb_tpu.obs."""
