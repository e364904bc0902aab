"""The port's data-lifecycle tools against the JAX package's: segment
archive and restore (``admin/lifecycle``), offline format migration
(``admin/migration``), backup and restore (``admin/backup``) and the
native object-store drivers (``utils/object_store``).

Every engine of the port runs on ``device="cpu"``, where the kernels'
plain versions stand in.  Data is made from a seed with numpy: integer
values, so every sum is exact.

- **Mirrors** of the JAX tests' contracts, on the port:
  ``tests/test_admin.py`` (2 backup tests), ``tests/test_remote_fs.py``
  (the S3 driver with its fake boto client), ``tests/test_object_store.py``
  (10 tests, through the same in-process HTTP fakes, which verify each
  signature with the JAX package's signer), ``tests/test_migration_tls.py``
  (3 migration tests) and
  ``tests/test_admin_extra.py::test_lifecycle_migration_and_restore``.
- **Across the packages:** the same data through either package's tool
  gives the same answers; a backup made by one restores under the other;
  format-migrated trees are byte-identical file for file (``metadata.json``
  holds no fresh id or clock, so nothing is exempt); ``sigv4_headers``
  and ``azure_sharedkey_auth`` give the same headers for a fixed clock;
  the archive's progress file is byte-identical.
- **The stale-path probe:** a part path reused in one process (a segment
  rewritten after it was archived, a second backup restored into a wiped
  root) is answered from the serving cache with the old bytes' rows, in
  both packages alike (ROADMAP Queue 3).

Tolerance: exact equality everywhere (counts, integer sums, min/max,
bytes, file lists).
"""

import datetime
import shutil
import types

import numpy as np
import pytest

from banyandb_tpu import api as japi
from banyandb_tpu.admin import backup as jbackup
from banyandb_tpu.admin import lifecycle as jlife
from banyandb_tpu.admin import migration as jmig
from banyandb_tpu.models.measure import MeasureEngine as JEngine
from banyandb_tpu.utils import object_store as jstore
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch.admin import backup as tbackup
from banyandb_tpu_torch.admin import lifecycle as tlife
from banyandb_tpu_torch.admin import migration as tmig
from banyandb_tpu_torch.models.measure import MeasureEngine as TEngine
from banyandb_tpu_torch.utils import object_store as tstore
from banyandb_tpu_torch.utils.object_store import (
    HttpAzureBlobFS,
    HttpGcsFS,
    HttpS3FS,
    ObjectStoreError,
)
from test_object_store import (
    ACCESS,
    AZ_ACCOUNT,
    AZ_KEY,
    GCS_TOKEN,
    SECRET,
    _azure_fake,
    _gcs_fake,
    _s3_fake,
    _serve,
    _Store,
)
from test_remote_fs import _FakeS3Client

JAX = types.SimpleNamespace(
    name="jax", api=japi, engine=JEngine, backup=jbackup, lifecycle=jlife,
    migration=jmig, kw={},
)
PORT = types.SimpleNamespace(
    name="port", api=tapi, engine=TEngine, backup=tbackup, lifecycle=tlife,
    migration=tmig, kw={"device": "cpu"},
)
PKGS = {"jax": JAX, "port": PORT}

T0 = 1_700_006_400_000  # day-aligned
DAY = 86_400_000
STAMP = "20240101000000"


def _schema(pkg, reg, shard_num=1):
    a = pkg.api
    reg.create_group(a.Group(
        "g", a.Catalog.MEASURE,
        a.ResourceOpts(shard_num=shard_num, segment_interval=a.IntervalRule(1, "day")),
    ))
    reg.create_measure(a.Measure(
        "g", "m", (a.TagSpec("svc", a.TagType.STRING),),
        (a.FieldSpec("v", a.FieldType.INT),), a.Entity(("svc",)),
    ))


def _rows(seed, n, days=1, t0=T0):
    rng = np.random.default_rng(seed)
    ts = t0 + np.sort(rng.integers(0, days * DAY, n))
    return ts, rng.integers(0, 7, n), rng.integers(0, 1000, n)


def _write(pkg, eng, rows, flush=True):
    ts, svc, v = rows
    a = pkg.api
    eng.write(a.WriteRequest("g", "m", tuple(
        a.DataPointValue(int(t), {"svc": f"s{s}"}, {"v": int(x)}, version=1)
        for t, s, x in zip(ts.tolist(), svc.tolist(), v.tolist())
    )))
    if flush:
        eng.flush()


def _engine(pkg, root, rows=None, shard_num=1):
    reg = pkg.api.SchemaRegistry(root)
    _schema(pkg, reg, shard_num)
    eng = pkg.engine(reg, root / "data", **pkg.kw)
    if rows is not None:
        _write(pkg, eng, rows)
    return eng


def _reopen(pkg, root):
    return pkg.engine(pkg.api.SchemaRegistry(root), root / "data", **pkg.kw)


def _answers(pkg, eng, lo=T0, hi=T0 + 4 * DAY) -> dict:
    """fn -> {svc: (count, fn(v))} of v by svc over [lo, hi)."""
    a = pkg.api
    out = {}
    for fn in ("count", "sum", "min", "max"):
        r = eng.query(a.QueryRequest(
            ("g",), "m", a.TimeRange(lo, hi),
            group_by=a.GroupBy(("svc",)), agg=a.Aggregation(fn, "v"),
        ))
        out[fn] = {g[0]: (c, v) for g, c, v in
                   zip(r.groups, r.values["count"], r.values[f"{fn}(v)"])}
    return out


def _numpy_answers(rows, lo=T0, hi=T0 + 4 * DAY) -> dict:
    ts, svc, v = rows
    keep = (ts >= lo) & (ts < hi)
    svc, v = svc[keep], v[keep].astype(float)
    out = {fn: {} for fn in ("count", "sum", "min", "max")}
    for s in np.unique(svc):
        vs = v[svc == s]
        for fn, val in (("count", len(vs)), ("sum", vs.sum()),
                        ("min", vs.min()), ("max", vs.max())):
            out[fn][f"s{s}"] = (float(len(vs)), float(val))
    return out


# -- backup and restore (tests/test_admin.py) ----------------------------------


def test_backup_restore_roundtrip(tmp_path):
    rows = _rows(1, 100)
    eng = _engine(PORT, tmp_path / "src", rows)
    remote = tbackup.LocalDirFS(tmp_path / "remote")
    stamp = tbackup.backup(tmp_path / "src", remote, flush=lambda: eng.flush())
    assert tbackup.list_backups(remote) == [stamp]

    n = tbackup.restore(remote, stamp, tmp_path / "restored")
    assert n > 0
    eng2 = _reopen(PORT, tmp_path / "restored")
    a = PORT.api
    r = eng2.query(a.QueryRequest(("g",), "m", a.TimeRange(T0, T0 + DAY),
                                  agg=a.Aggregation("sum", "v")))
    assert r.values["sum(v)"][0] == float(rows[2].sum())
    assert _answers(PORT, eng2) == _numpy_answers(rows) == _answers(PORT, eng)


def test_restore_refuses_nonempty_target(tmp_path):
    _engine(PORT, tmp_path / "src", _rows(2, 50))
    remote = tbackup.LocalDirFS(tmp_path / "remote")
    stamp = tbackup.backup(tmp_path / "src", remote)
    with pytest.raises(FileExistsError):
        tbackup.restore(remote, stamp, tmp_path / "src")


@pytest.mark.parametrize("maker,restorer", [("jax", "port"), ("port", "jax")])
def test_backup_restores_across_packages(tmp_path, maker, restorer):
    """A backup made by one package restores under the other; both give
    the same answers, which equal numpy's, over the same file list."""
    mk, rs = PKGS[maker], PKGS[restorer]
    rows = _rows(3, 600, days=3)
    eng = _engine(mk, tmp_path / "src", rows, shard_num=2)
    remote = mk.backup.LocalDirFS(tmp_path / "remote")
    stamp = mk.backup.backup(tmp_path / "src", remote, time_dir=STAMP, flush=eng.flush)
    assert stamp == STAMP
    remote_rs = rs.backup.LocalDirFS(tmp_path / "remote")
    assert rs.backup.list_backups(remote_rs) == [STAMP]
    assert remote_rs.list(STAMP) == remote.list(STAMP)
    n = rs.backup.restore(remote_rs, STAMP, tmp_path / "restored")
    assert n == len(remote.list(STAMP))
    want = _numpy_answers(rows)
    for pkg in (mk, rs):
        eng2 = _reopen(pkg, tmp_path / "restored")
        assert _answers(pkg, eng2) == want, pkg.name
        eng2.close()


def test_s3fs_backup_restore_roundtrip(tmp_path):
    import json

    src = tmp_path / "src"
    (src / "schema").mkdir(parents=True)
    (src / "schema" / "group.json").write_text(json.dumps({"x": 1}))
    (src / "data").mkdir()
    (src / "data" / "blob.bin").write_bytes(b"\x00" * 1024)

    client = _FakeS3Client()
    fs = tbackup.S3FS("bucket", prefix="backups", client=client)
    stamp = tbackup.backup(src, fs)
    # string-prefix sibling keys must NOT leak into directory listings
    client.objects["backups-archive/20000101000000/foreign"] = b"x"
    assert tbackup.list_backups(fs) == [stamp]
    n = tbackup.restore(fs, stamp, tmp_path / "dst")
    assert n == 2
    assert (tmp_path / "dst" / "schema" / "group.json").read_text() == '{"x": 1}'
    assert (tmp_path / "dst" / "data" / "blob.bin").read_bytes() == b"\x00" * 1024
    # the JAX driver over the same fake bucket lists and restores the same
    jfs = jbackup.S3FS("bucket", prefix="backups", client=client)
    assert jbackup.list_backups(jfs) == [stamp]
    assert jfs.list(stamp) == fs.list(stamp)


class _FakeGcsClient:
    """The three google.cloud.storage calls GcsFS uses, over a dict."""

    def __init__(self):
        self.objects: dict[str, bytes] = {}

    def bucket(self, name):
        client = self

        class Blob:
            def __init__(self, key):
                self.name = key

            def upload_from_filename(self, filename):
                with open(filename, "rb") as f:
                    client.objects[self.name] = f.read()

            def download_to_filename(self, filename):
                with open(filename, "wb") as f:
                    f.write(client.objects[self.name])

        class Bucket:
            def blob(self, key):
                return Blob(key)

            def list_blobs(self, prefix):
                return [Blob(k) for k in sorted(client.objects) if k.startswith(prefix)]

        return Bucket()


def test_gcsfs_backup_restore_roundtrip_with_injected_client(tmp_path):
    """GcsFS over an injected client (a client-less GcsFS would reach for
    cloud credentials, so it is never built here)."""
    src = tmp_path / "src"
    (src / "data").mkdir(parents=True)
    (src / "data" / "a.bin").write_bytes(b"\x07" * 300)
    client = _FakeGcsClient()
    stamp = tbackup.backup(src, tbackup.GcsFS("b", prefix="p", client=client),
                           time_dir=STAMP)
    assert sorted(client.objects) == [f"p/{STAMP}/data/a.bin"]
    jfs = jbackup.GcsFS("b", prefix="p", client=client)
    assert jbackup.restore(jfs, stamp, tmp_path / "dst") == 1
    assert (tmp_path / "dst" / "data" / "a.bin").read_bytes() == b"\x07" * 300


def test_cloud_sdk_drivers_stay_gated_alike():
    """The SDK drivers import their SDK only when built without a client:
    the module imports everywhere, and both packages fail alike at use."""
    import importlib.util

    for mod in (tbackup, jbackup):
        with pytest.raises(TypeError, match="bucket"):
            mod.GcsFS("b", client=object())
    if importlib.util.find_spec("boto3") is None:
        errs = []
        for mod in (tbackup, jbackup):
            with pytest.raises(RuntimeError) as ei:
                mod.S3FS("bucket")
            assert isinstance(ei.value.__cause__, ImportError)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


# -- native object stores (tests/test_object_store.py) --------------------------


@pytest.fixture()
def s3(tmp_path):
    store = _Store()
    httpd = _serve(_s3_fake(store))
    fs = HttpS3FS(
        f"http://127.0.0.1:{httpd.server_port}", "bkt",
        access_key=ACCESS, secret_key=SECRET, prefix="base",
    )
    yield fs, store, tmp_path
    httpd.shutdown()
    httpd.server_close()


def test_s3_sigv4_roundtrip(s3):
    fs, store, tmp = s3
    src = tmp / "a.txt"
    src.write_bytes(b"hello sigv4")
    fs.put("dir/a.txt", src)
    assert list(store.objects) == ["base/dir/a.txt"]
    dst = tmp / "out" / "a.txt"
    fs.get("dir/a.txt", dst)
    assert dst.read_bytes() == b"hello sigv4"
    assert fs.list("dir") == ["dir/a.txt"]
    assert fs.list("dir-sibling") == []  # directory semantics
    fs.delete("dir/a.txt")
    assert fs.list("dir") == []
    assert store.auth_failures == 0


def test_s3_wrong_secret_rejected_at_wire(s3):
    fs, store, tmp = s3
    bad = HttpS3FS(
        fs.endpoint, "bkt", access_key=ACCESS, secret_key="wrong", prefix="base"
    )
    src = tmp / "b.txt"
    src.write_bytes(b"x")
    with pytest.raises(ObjectStoreError) as ei:
        bad.put("b.txt", src)
    assert ei.value.status == 403
    assert store.auth_failures == 1
    assert not store.objects  # nothing stored on auth failure


def test_s3_backup_restore_through_wire(s3):
    fs, store, tmp = s3
    data = tmp / "data"
    (data / "seg").mkdir(parents=True)
    (data / "seg" / "part.bin").write_bytes(b"\x01" * 2048)
    (data / "meta.json").write_text("{}")
    name = tbackup.backup(data, fs)
    assert any(k.startswith(f"base/{name}/") for k in store.objects)
    out = tmp / "restored"
    tbackup.restore(fs, name, out)
    assert (out / "seg" / "part.bin").read_bytes() == b"\x01" * 2048
    assert (out / "meta.json").read_text() == "{}"


def test_gcs_json_api_roundtrip(tmp_path):
    store = _Store()
    httpd = _serve(_gcs_fake(store))
    try:
        fs = HttpGcsFS(
            f"http://127.0.0.1:{httpd.server_port}", "bkt",
            token_fn=lambda: GCS_TOKEN, prefix="p",
        )
        src = tmp_path / "x.bin"
        src.write_bytes(b"gcs-bytes")
        fs.put("d/x.bin", src)
        assert list(store.objects) == ["p/d/x.bin"]
        dst = tmp_path / "out.bin"
        fs.get("d/x.bin", dst)
        assert dst.read_bytes() == b"gcs-bytes"
        assert fs.list("d") == ["d/x.bin"]

        bad = HttpGcsFS(
            f"http://127.0.0.1:{httpd.server_port}", "bkt",
            token_fn=lambda: "stale", prefix="p",
        )
        with pytest.raises(ObjectStoreError) as ei:
            bad.list("d")
        assert ei.value.status == 401 and store.auth_failures == 1
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_azure_sharedkey_roundtrip(tmp_path):
    store = _Store()
    httpd = _serve(_azure_fake(store))
    try:
        fs = HttpAzureBlobFS(
            f"http://127.0.0.1:{httpd.server_port}", "cont",
            account=AZ_ACCOUNT, key_b64=AZ_KEY, prefix="pre",
        )
        src = tmp_path / "z.bin"
        src.write_bytes(b"azure-bytes")
        fs.put("d/z.bin", src)
        assert list(store.objects) == ["pre/d/z.bin"]
        dst = tmp_path / "back.bin"
        fs.get("d/z.bin", dst)
        assert dst.read_bytes() == b"azure-bytes"
        assert fs.list("d") == ["d/z.bin"]
        assert store.auth_failures == 0

        bad = HttpAzureBlobFS(
            f"http://127.0.0.1:{httpd.server_port}", "cont",
            account=AZ_ACCOUNT, key_b64="d3Jvbmd3cm9uZw==", prefix="pre",
        )
        with pytest.raises(ObjectStoreError) as ei:
            bad.put("d/w.bin", src)
        assert ei.value.status == 403 and store.auth_failures == 1
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_s3_key_with_space_single_encoded(s3):
    fs, store, tmp = s3
    src = tmp / "sp.txt"
    src.write_bytes(b"spaced")
    fs.put("dir/a b+c.txt", src)
    assert list(store.objects) == ["base/dir/a b+c.txt"]
    dst = tmp / "sp-out.txt"
    fs.get("dir/a b+c.txt", dst)
    assert dst.read_bytes() == b"spaced"
    assert store.auth_failures == 0


def _paged_query(self):
    import urllib.parse

    u = urllib.parse.urlsplit(self.path)
    return u, dict(urllib.parse.parse_qsl(u.query))


def _page(store, prefix, start):
    keys = sorted(k for k in store.objects if k.startswith(prefix))
    return keys[start: start + 2], start + 2 < len(keys)


def test_drivers_paginate_listings(tmp_path):
    """GCS nextPageToken is followed (2-item pages)."""
    import json

    store = _Store()
    base = _gcs_fake(store)

    class Paged(base):
        def do_GET(self):
            if not self._auth():
                return self._reply(401, b"{}")
            u, q = _paged_query(self)
            if u.path.endswith("/o") and "prefix" in q:
                start = int(q.get("pageToken") or 0)
                page, more = _page(store, q["prefix"], start)
                body = {"items": [{"name": k} for k in page]}
                if more:
                    body["nextPageToken"] = str(start + 2)
                return self._reply(200, json.dumps(body).encode())
            return base.do_GET(self)

    httpd = _serve(Paged)
    try:
        fs = HttpGcsFS(
            f"http://127.0.0.1:{httpd.server_port}", "bkt",
            token_fn=lambda: GCS_TOKEN,
        )
        for i in range(5):
            store.objects[f"d/k{i}"] = b"x"
        assert fs.list("d") == [f"d/k{i}" for i in range(5)]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_s3_list_follows_continuation_token():
    from xml.sax.saxutils import escape

    store = _Store()
    base = _s3_fake(store)

    class Paged(base):
        def do_GET(self):
            u, q = _paged_query(self)
            if q.get("list-type") == "2":
                if not self._verify(b""):
                    return self._reply(403, b"<Error/>")
                start = int(q.get("continuation-token") or 0)
                page, more = _page(store, q.get("prefix", ""), start)
                nxt = (f"<NextContinuationToken>{start + 2}</NextContinuationToken>"
                       if more else "")
                xml = (
                    '<?xml version="1.0"?>'
                    '<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                    + "".join(f"<Contents><Key>{escape(k)}</Key></Contents>" for k in page)
                    + nxt + "</ListBucketResult>"
                )
                return self._reply(200, xml.encode())
            return base.do_GET(self)

    httpd = _serve(Paged)
    try:
        fs = HttpS3FS(
            f"http://127.0.0.1:{httpd.server_port}", "bkt",
            access_key=ACCESS, secret_key=SECRET,
        )
        for i in range(5):
            store.objects[f"d/k{i}"] = b"x"
        assert fs.list("d") == [f"d/k{i}" for i in range(5)]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_azure_list_follows_next_marker():
    from xml.sax.saxutils import escape

    store = _Store()
    base = _azure_fake(store)

    class Paged(base):
        def do_GET(self):
            u, q = _paged_query(self)
            if q.get("comp") == "list":
                if not self._verify(0):
                    return self._reply(403, b"auth failed")
                start = int(q.get("marker") or 0)
                page, more = _page(store, q.get("prefix", ""), start)
                nxt = f"<NextMarker>{start + 2}</NextMarker>" if more else ""
                xml = (
                    '<?xml version="1.0"?><EnumerationResults><Blobs>'
                    + "".join(f"<Blob><Name>{escape(k)}</Name></Blob>" for k in page)
                    + "</Blobs>" + nxt + "</EnumerationResults>"
                )
                return self._reply(200, xml.encode())
            return base.do_GET(self)

    httpd = _serve(Paged)
    try:
        fs = HttpAzureBlobFS(
            f"http://127.0.0.1:{httpd.server_port}", "cont",
            account=AZ_ACCOUNT, key_b64=AZ_KEY,
        )
        for i in range(5):
            store.objects[f"d/k{i}"] = b"x"
        assert fs.list("d") == [f"d/k{i}" for i in range(5)]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_connection_failure_is_object_store_error():
    fs = HttpS3FS(
        "http://127.0.0.1:9",  # discard port: connection refused
        "bkt", access_key=ACCESS, secret_key=SECRET,
    )
    with pytest.raises(ObjectStoreError) as ei:
        fs.list("x")
    assert ei.value.status == 0


_SIGN_CASES = [
    ("GET", "http://127.0.0.1:9000/bkt?list-type=2&prefix=a%2Fb%2F", b""),
    ("PUT", "http://127.0.0.1:9000/bkt/base/dir/a%20b%2Bc.txt", b"\x00\x01" * 513),
    ("DELETE", "https://s3.us-east-1.amazonaws.com/bkt/k", b""),
    ("GET", "http://h/bkt?list-type=2&prefix=&continuation-token=4", b""),
]


@pytest.mark.parametrize("method,url,payload", _SIGN_CASES)
def test_signatures_equal_across_packages(method, url, payload):
    """For a fixed clock both packages sign byte for byte alike."""
    now = datetime.datetime(2024, 2, 29, 23, 59, 58, tzinfo=datetime.timezone.utc)
    kw = dict(access_key=ACCESS, secret_key=SECRET, payload=payload, now=now)
    for region in ("us-east-1", "eu-west-3"):
        assert (tstore.sigv4_headers(method, url, region=region, **kw)
                == jstore.sigv4_headers(method, url, region=region, **kw))
    hdrs = {"x-ms-date": now.strftime("%a, %d %b %Y %H:%M:%S GMT"),
            "x-ms-version": "2021-08-06", "x-ms-blob-type": "BlockBlob"}
    akw = dict(account=AZ_ACCOUNT, key_b64=AZ_KEY, content_length=len(payload),
               extra_headers=hdrs)
    assert (tstore.azure_sharedkey_auth(method, url, **akw)
            == jstore.azure_sharedkey_auth(method, url, **akw))


# -- format migration (tests/test_migration_tls.py) ----------------------------


def test_migration_analyze_plan_copy_verify(tmp_path):
    rows = _rows(4, 200)
    _engine(PORT, tmp_path / "src", rows)
    info = tmig.analyze(tmp_path / "src")
    assert info["parts"] and all("error" not in p for p in info["parts"])
    assert info == jmig.analyze(tmp_path / "src")

    plan = tmig.plan(tmp_path / "src", target_version=2)
    assert set(plan["rewrite"]) == {p["dir"] for p in info["parts"]}

    out = tmig.copy(tmp_path / "src", tmp_path / "dst", plan)
    assert out["rewritten_parts"] == len(plan["rewrite"])

    v = tmig.verify(tmp_path / "src", tmp_path / "dst")
    assert v["ok"], v

    eng2 = _reopen(PORT, tmp_path / "dst")
    a = PORT.api
    r = eng2.query(a.QueryRequest(("g",), "m", a.TimeRange(T0, T0 + DAY),
                                  agg=a.Aggregation("sum", "v")))
    assert r.values["sum(v)"][0] == float(rows[2].sum())


def test_migration_verify_detects_divergence(tmp_path):
    _engine(PORT, tmp_path / "src", _rows(5, 200))
    plan = tmig.plan(tmp_path / "src", target_version=2)
    tmig.copy(tmp_path / "src", tmp_path / "dst", plan)
    victim = next((tmp_path / "dst" / "data").glob("*/*/seg-*/shard-*/part-*/field_v.bin"))
    victim.write_bytes(b"garbage")
    v = tmig.verify(tmp_path / "src", tmp_path / "dst")
    assert not v["ok"] and v["mismatches"]
    assert v == jmig.verify(tmp_path / "src", tmp_path / "dst")


def test_failed_part_quarantined_not_bricking(tmp_path):
    a = PORT.api
    eng = _engine(PORT, tmp_path, _rows(6, 50))
    eng.write(a.WriteRequest("g", "m", (
        a.DataPointValue(T0 + 500, {"svc": "s0"}, {"v": 1}, version=1),)))
    eng.flush()
    shard_dir = next((tmp_path / "data" / "measure" / "g").glob("seg-*/shard-0"))
    parts = sorted(shard_dir.glob("part-*"))
    assert len(parts) == 2
    (parts[0] / "metadata.json").write_text("{corrupt")
    assert "error" in tmig.analyze(tmp_path)["parts"][0]

    eng2 = _reopen(PORT, tmp_path)
    r = eng2.query(a.QueryRequest(("g",), "m", a.TimeRange(T0, T0 + DAY),
                                  agg=a.Aggregation("count", "v")))
    assert r.values["count"][0] == 1  # surviving part serves
    assert (shard_dir / "failed-parts" / parts[0].name).exists()
    eng2.write(a.WriteRequest("g", "m", (
        a.DataPointValue(T0 + 600, {"svc": "s1"}, {"v": 2}, version=1),)))
    assert eng2.flush()


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_migrated_trees_equal_across_packages(tmp_path, writer):
    """Both packages re-encode the same source tree into byte-identical
    trees: every column file, dictionary, block index and metadata.json."""
    _engine(PKGS[writer], tmp_path / "src", _rows(7, 900, days=2), shard_num=2)
    plans = {n: p.migration.plan(tmp_path / "src", target_version=2)
             for n, p in PKGS.items()}
    assert plans["jax"] == plans["port"] and len(plans["port"]["rewrite"]) == 4
    for n, p in PKGS.items():
        assert p.migration.copy(tmp_path / "src", tmp_path / n, plans[n]) == {
            "copied_files": len(_tree(tmp_path / "src"))
            - sum(len(list((tmp_path / "src" / d).iterdir())) for d in plans[n]["rewrite"]),
            "rewritten_parts": 4,
        }
        assert p.migration.verify(tmp_path / "src", tmp_path / n)["ok"]
    jt, tt = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(jt) == sorted(tt)
    assert any(k.endswith("/metadata.json") for k in tt)
    assert [k for k in jt if jt[k] != tt[k]] == []


# -- segment archive and restore (tests/test_admin_extra.py) -------------------


def test_lifecycle_migration_and_restore(tmp_path):
    a = PORT.api
    eng = _engine(PORT, tmp_path)
    # two day-segments: one old, one current — the old one left UNFLUSHED
    # (migrate must seal memtables itself or those rows are lost)
    for ts in (T0 - 10 * DAY, T0):
        eng.write(a.WriteRequest("g", "m", (
            a.DataPointValue(ts, {"svc": "s"}, {"v": 1}, version=1),)))
    db = eng._tsdb("g")
    assert len(db.segments) == 2

    archive = tmp_path / "cold"
    moved = tlife.migrate(db, archive, older_than_millis=T0 - DAY)
    assert len(moved) == 1
    assert len(db.segments) == 1
    assert tlife.list_archived(archive) == moved

    def count(lo, hi):
        r = eng.query(a.QueryRequest(("g",), "m", a.TimeRange(lo, hi),
                                     agg=a.Aggregation("count", "v")))
        return r.values["count"][0]

    assert count(T0 - 11 * DAY, T0 + DAY) == 1  # hot only now

    tlife.restore_segment(archive, db, moved[0])
    assert len(db.segments) == 2
    assert count(T0 - 11 * DAY, T0 + DAY) == 2  # cold segment back
    with pytest.raises(FileExistsError):
        tlife.restore_segment(archive, db, moved[0])


def test_archive_and_restore_equal_across_packages(tmp_path):
    """Four day segments of seeded rows: each package archives the first
    two (one shard of each left unflushed), answers over the last two,
    restores and answers over all four; answers equal numpy, the
    archives and progress files are byte-identical, and the restored
    segment's memtable is the engine's own kind."""
    rows = _rows(8, 2000, days=4)
    half = _rows(9, 100, days=1, t0=T0 + DAY)  # late rows, left in memtables
    allrows = tuple(np.concatenate([x, y]) for x, y in zip(rows, half))
    got = {}
    for n, p in PKGS.items():
        eng = _engine(p, tmp_path / n, rows, shard_num=2)
        _write(p, eng, half, flush=False)
        db = eng._tsdb("g")
        moved = p.lifecycle.migrate(db, tmp_path / f"{n}-arch", T0 + 2 * DAY)
        assert moved == ["seg-20231115", "seg-20231116"]
        after = _answers(p, eng)
        assert after == _numpy_answers(allrows, T0 + 2 * DAY)
        for name in moved:
            p.lifecycle.restore_segment(tmp_path / f"{n}-arch", db, name)
        seg = db.segments[0]
        assert type(seg.shards[0].mem) is type(db.mem_factory())
        got[n] = (moved, after, _answers(p, eng), _tree(tmp_path / f"{n}-arch"))
        eng.close()
    assert got["jax"][:3] == got["port"][:3]
    assert got["port"][2] == _numpy_answers(allrows)
    assert got["jax"][3] == got["port"][3]
    assert ".migration-progress.json" in got["port"][3]


def test_stale_part_cache_on_reused_paths_is_the_reference_behaviour(tmp_path):
    """The stale-path probe (ROADMAP Queue 3).  The serving cache keys a
    part's decoded columns by its path, and part names restart in a new
    shard directory, so in one process:

    - a day archived away and then written again answers with the
      archived rows (sum 30 where the disk holds 150);
    - a second backup restored into the same wiped root answers with the
      first backup's rows.

    Both packages do this alike; the test pins it until the reference
    changes (banyandb_tpu/storage/part.py:451-458, its cache key)."""
    got = {}
    for n, p in PKGS.items():
        root = tmp_path / n
        eng = _engine(p, root / "live")
        first = _rows(10, 30)
        _write(p, eng, (first[0], first[1], np.ones(30, np.int64)))
        out = [_answers(p, eng, T0, T0 + DAY)["sum"]]
        p.lifecycle.migrate(eng._tsdb("g"), root / "arch", T0 + DAY)
        out.append(_answers(p, eng, T0, T0 + DAY)["sum"])
        _write(p, eng, (first[0], first[1], np.full(30, 5, np.int64)))
        out.append(_answers(p, eng, T0, T0 + DAY)["sum"])
        eng.close()
        for i, val in enumerate((2, 7)):
            src = root / f"src{i}"
            e = _engine(p, src, (first[0], first[1], np.full(30, val, np.int64)))
            p.backup.backup(src, p.backup.LocalDirFS(root / f"bk{i}"), time_dir=STAMP)
            e.close()
        for i in range(2):
            dst = root / "restored"
            shutil.rmtree(dst, ignore_errors=True)
            p.backup.restore(p.backup.LocalDirFS(root / f"bk{i}"), STAMP, dst)
            e = _reopen(p, dst)
            out.append(_answers(p, e, T0, T0 + DAY)["sum"])
            e.close()
        got[n] = out
    assert got["jax"] == got["port"]
    totals = [sum(v for _c, v in res.values()) for res in got["port"]]
    assert totals == [30.0, 0.0, 30.0, 60.0, 60.0]
