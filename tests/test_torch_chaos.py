"""Chaos harness gate of the port (harness/chaos.py, docs/robustness.md):
the streaming-aggregation failover bar.  A data node behind the gRPC
bus is killed mid-load under the liaison write queue and restarted over
its root; the re-shipped parts must leave the materialized windows
gap-free and single."""

# Mirror of tests/test_chaos.py: the same contract, with the JAX
# package's imports re-pointed at banyandb_tpu_torch and the harness's
# shared bits taken from the port's chaos harness.

from banyandb_tpu_torch.harness import chaos


def test_streamagg_failover_windows_gap_free(tmp_path, monkeypatch):
    """The failover bar: kill a data node mid-load, let the
    liaison wqueue replay drain, and assert the materialized streaming-
    aggregation windows are gap-free and not double-counted vs a full-
    rescan oracle (`BYDB_STREAMAGG=0` byte parity + exact acked total).

    The restart path exercises the deterministic rebuild: the new
    DataNode reloads its persisted streamagg registry and backfills
    from the parts that survived on disk; the wqueue then re-ships the
    outage window and the install-digest dedup keeps re-delivered parts
    (and therefore window updates) single."""
    import json as _json
    import time as _time

    from banyandb_tpu_torch.api import SchemaRegistry, WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport
    from banyandb_tpu_torch.server import result_to_json

    reg = SchemaRegistry(tmp_path / "n0" / "schema")
    chaos._schema(reg, shard_num=2)
    dn = DataNode("n0", reg, tmp_path / "n0" / "data", device="cpu")
    # 1s windows so a few hundred points cross a rotation
    dn.measure.streamagg.register(
        "cg", "m", key_tags=("svc",), fields=("v",), window_millis=1000
    )
    srv = chaos._bind_server(dn.bus, 0, sync_install=dn.install_synced_parts)
    port = srv.port
    lreg = SchemaRegistry(tmp_path / "l" / "schema")
    chaos._schema(lreg, shard_num=2)
    transport = GrpcTransport()
    liaison = Liaison(
        lreg, transport, [NodeInfo("n0", srv.addr)], query_budget_s=5.0
    )
    liaison.probe()
    wq = liaison.enable_write_queue(
        tmp_path / "l" / "wqueue", flush_interval_s=30.0, retry_base_s=0.01
    )
    acked = 0

    def write(n):
        nonlocal acked
        acked += liaison.write_measure_queued(
            WriteRequest("cg", "m", chaos._points(acked, n))
        )

    def drain(deadline_s=20.0):
        end = _time.monotonic() + deadline_s
        while _time.monotonic() < end:
            liaison.probe()
            try:
                wq.flush(force=True)
            except Exception:  # noqa: BLE001 - victim still down
                pass
            if wq.pending_parts() == 0:
                return
            _time.sleep(0.05)
        raise AssertionError("wqueue never drained")

    dn2 = None
    try:
        write(1500)  # crosses a window rotation (1ms-spaced points)
        drain()
        # kill mid-load: acked rows pile into the spool while down
        srv.stop(grace=0)
        write(1200)
        try:
            wq.flush(force=True)
        except Exception:  # noqa: BLE001 - expected: node down
            pass
        assert wq.pending_parts() > 0, "outage produced nothing to replay"
        # restart over the SAME root: the fresh engine reloads the
        # persisted streamagg registry and backfills from on-disk parts
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()
        dn2 = DataNode(
            "n0", SchemaRegistry(tmp_path / "n0" / "schema"),
            tmp_path / "n0" / "data", device="cpu"
        )
        st = dn2.measure.streamagg.stats()
        assert len(st["signatures"]) == 1, "registry did not reload"
        assert st["rows"] > 0, "backfill applied nothing"
        srv = chaos._bind_server(
            dn2.bus, port, sync_install=dn2.install_synced_parts
        )
        liaison.probe()
        drain()  # replay: re-ships dedup by part uuid, windows stay single
        req = chaos._count_req()
        monkeypatch.setenv("BYDB_STREAMAGG", "1")
        on = result_to_json(liaison.query_measure(req))
        monkeypatch.setenv("BYDB_STREAMAGG", "0")
        off = result_to_json(liaison.query_measure(req))
        assert _json.dumps(on, sort_keys=True) == _json.dumps(
            off, sort_keys=True
        ), "materialized answer diverged from the rescan oracle"
        # gap-free AND not double-counted: the folded total is exactly
        # the acked row count
        assert sum(on["values"]["count"]) == acked
        assert dn2.measure.streamagg.stats()["rows"] == acked
    finally:
        wq.stop(final_flush=False)
        transport.close()
        srv.stop(grace=0)
        for node in (dn, dn2):
            if node is not None:
                node.measure.close()
                node.stream.close()
                node.trace.close()


# -- a limit on every test of this file (gRPC streams, child processes) ------
import pytest as _pytest  # noqa: E402
from test_torch_mirror_support import hang_limit as _hang_limit  # noqa: E402


@_pytest.fixture(autouse=True)
def _test_limit():
    with _hang_limit(300):
        yield
