"""banyandb_tpu_torch — the PyTorch/CUDA port of banyandb_tpu.

A second package beside ``banyandb_tpu`` that runs the same system on an
NVIDIA Hopper card (H100) through PyTorch, with the TPU's Pallas kernels
rewritten by hand in CUDA C++ (``csrc/``, bound in
``ops/hopper_kernels.py``).  It imports ``torch`` and numpy and never
``jax`` or ``banyandb_tpu``: host-only modules are carried here as
copies with their imports re-pointed.

The package grows slice by slice.  It carries the single-node measure
engine and its BydbQL front end: ``bydbql.parse`` ->
``models.measure.MeasureEngine.query`` (TSDB shards and segments,
series index, planner, streaming aggregation) -> the aggregate executor
(``query.measure_exec``: filter -> group-by -> count/sum/min/max, TopN
and percentile), and ``ops.delta_decode``.

Dtype policy (the JAX package's 32-bit device contract, carried over):
int64 quantities (timestamps, series ids, versions) stay on the host as
NumPy int64; on the device, timestamps are int32 offsets from the batch
epoch, tag values int32 dictionary codes, fields float32.  f64 is used
only on the host, where per-chunk f32 partials are folded.

Device policy: entry points take an explicit ``device``; the default is
the CUDA device, and without CUDA they raise unless the caller asked
for ``"cpu"`` (``backend.resolve_device``).
"""

__version__ = "0.1.0"
