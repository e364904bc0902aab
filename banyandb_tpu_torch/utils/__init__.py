"""Platform utilities (the reference's L0: pkg/fs, pkg/encoding,
pkg/compress analogs), carried from banyandb_tpu.utils."""
