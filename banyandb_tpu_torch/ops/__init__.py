"""Device kernel substrate on torch tensors: the counterpart of
banyandb_tpu.ops for the measure aggregate path."""

from banyandb_tpu_torch.ops.dedup import latest_by_version
from banyandb_tpu_torch.ops.decode import (
    decode_chunk,
    delta_decode,
    dict_gather,
    dict_remap,
    dod_decode,
    ints_to_f32,
    widen_codes,
)
from banyandb_tpu_torch.ops.filter import (
    cmp_mask,
    in_set_mask,
    mask_and,
    mask_not,
    mask_or,
    time_range_mask,
)
from banyandb_tpu_torch.ops.groupby import (
    GroupReduceResult,
    group_reduce,
    mixed_radix_key,
)
from banyandb_tpu_torch.ops.percentile import (
    group_histogram,
    group_percentile_histogram,
)
from banyandb_tpu_torch.ops.topk import topk_groups
