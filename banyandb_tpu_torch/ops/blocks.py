"""Block-size constant shared with the storage layer.

The reference caps blocks at 8192 rows (banyand/measure/measure.go:46);
storage/part.py cuts parts into blocks of this size.
"""

MAX_ROWS = 8192
