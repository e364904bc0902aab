"""Cluster fabric: liaison/data roles over a pluggable message transport.

Analog of the reference's banyand/queue (pub/sub/local) + pkg/bus +
pkg/node + banyand/dquery: writes route by (group, shard) with
replica fan-out; queries scatter per-shard to primary-alive nodes and
reduce partial aggregates at the liaison (two rounds for percentile so
node histograms share a range).  Transports: in-process (standalone and
the reference's in-process multi-node test trick) and gRPC sockets.
"""

from banyandb_tpu_torch.cluster.bus import Topic, LocalBus
from banyandb_tpu_torch.cluster.node import NodeInfo, RoundRobinSelector
from banyandb_tpu_torch.cluster.placement import (
    PlacementMap,
    PlacementSelector,
    StaleEpoch,
)
from banyandb_tpu_torch.cluster.data_node import DataNode
from banyandb_tpu_torch.cluster.liaison import Liaison
