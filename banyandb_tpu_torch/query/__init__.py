"""Query engine: logical request -> device execution -> result, on
torch tensors (the measure aggregate path)."""
