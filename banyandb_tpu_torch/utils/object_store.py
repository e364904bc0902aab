"""Native HTTP object-store drivers: S3 (SigV4), GCS (JSON API), Azure
Blob (SharedKey).

The reference's remote FS drivers (pkg/fs/remote/{aws,gcp,azure}) ride
the vendor SDKs; none of those SDKs ship in this image, so these drivers
speak the wire protocols directly over stdlib HTTP — which also makes
the auth/signing paths first-class, testable code instead of SDK
internals:

- S3: AWS Signature Version 4 (the full canonical-request -> string-to-
  sign -> derived-key chain, hmac/hashlib only), virtual path-style
  requests, ListObjectsV2 XML.
- GCS: JSON/upload API with OAuth2 Bearer tokens.
- Azure Blob: SharedKey authorization (canonicalized headers/resource
  hmac-sha256) and List Blobs XML.

All three satisfy admin.backup.RemoteFS (put/get/list) and compose with
backup/restore/lifecycle unchanged.  tests/test_object_store.py runs
them against in-process HTTP fakes that RECOMPUTE and verify each
scheme's signature — a wrong secret is rejected at the protocol level,
like the reference's dockertest minio/azurite suites
(test/integration/dockertesthelper/minio_init.go).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from pathlib import Path


class ObjectStoreError(RuntimeError):
    def __init__(self, status: int, body: str):
        self.status = status
        super().__init__(f"object store HTTP {status}: {body[:200]}")


def _http(req: urllib.request.Request) -> bytes:
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read()
    except urllib.error.HTTPError as e:
        raise ObjectStoreError(e.code, e.read().decode("utf-8", "replace")) from e
    except (urllib.error.URLError, OSError) as e:
        # connection-level failures (refused, DNS, TLS, socket timeout)
        # surface as the module's error type; status 0 = no HTTP reply
        raise ObjectStoreError(0, f"connection failed: {e}") from e


# -- AWS Signature Version 4 -------------------------------------------------


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    url: str,
    *,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    service: str = "s3",
    payload: bytes = b"",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """Build the SigV4 Authorization + companion headers for a request.

    The canonical chain follows the SigV4 spec exactly (and therefore
    interoperates with real S3/minio): canonical request over the sorted
    signed headers, string-to-sign over its hash, signature from the
    date/region/service derived key.
    """
    u = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = _sha256_hex(payload)

    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in sorted(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    )
    headers = {
        "host": u.netloc,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    signed = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join(
        [
            method,
            # S3 canonical URI = the path exactly as sent on the wire
            # (already percent-encoded once by the caller; re-quoting
            # here would double-encode and real S3 would 403)
            u.path or "/",
            canonical_query,
            canonical_headers,
            signed,
            payload_hash,
        ]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope, _sha256_hex(canonical_request.encode())]
    )
    key = _hmac(
        _hmac(_hmac(_hmac(b"AWS4" + secret_key.encode(), datestamp), region), service),
        "aws4_request",
    )
    signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "Host": u.netloc,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={signature}"
        ),
    }


class _PrefixedCloudFS:
    """Shared key/prefix handling for bucket-store drivers (the base of
    admin/backup's gated-SDK drivers AND the raw-REST drivers below).

    Directory semantics (match LocalDirFS): a non-empty list() prefix
    only matches keys *under* it, never string-prefix siblings like
    "<prefix>-archive/...".
    """

    prefix: str

    def _key(self, rel: str) -> str:
        return f"{self.prefix}/{rel}" if self.prefix else rel

    def _probe(self, prefix: str) -> str:
        full = self._key(prefix).strip("/")
        return full + "/" if full else ""

    def _strip(self, key: str) -> str:
        return key[len(self.prefix) + 1 :] if self.prefix else key

    def list(self, prefix: str) -> list[str]:
        return sorted(
            self._strip(k) for k in self._iter_keys(self._probe(prefix))
        )


class HttpS3FS(_PrefixedCloudFS):
    """S3 RemoteFS over raw REST + SigV4 (pkg/fs/remote/aws analog).

    endpoint: e.g. "http://127.0.0.1:9000" (minio) or
    "https://s3.us-east-1.amazonaws.com"; path-style addressing.
    """

    def __init__(
        self,
        endpoint: str,
        bucket: str,
        *,
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
        prefix: str = "",
    ):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.prefix = prefix.strip("/")

    def _url(self, key: str = "", query: str = "") -> str:
        path = f"/{self.bucket}"
        if key:
            path += "/" + urllib.parse.quote(key)
        return self.endpoint + path + (f"?{query}" if query else "")

    def _request(self, method: str, url: str, payload: bytes = b"") -> bytes:
        hdrs = sigv4_headers(
            method,
            url,
            access_key=self.access_key,
            secret_key=self.secret_key,
            region=self.region,
            payload=payload,
        )
        req = urllib.request.Request(
            url, data=payload if method == "PUT" else None, method=method
        )
        for k, v in hdrs.items():
            req.add_header(k, v)
        return _http(req)

    def put(self, rel: str, local: Path) -> None:
        self._request("PUT", self._url(self._key(rel)), Path(local).read_bytes())

    def get(self, rel: str, local: Path) -> None:
        local = Path(local)
        local.parent.mkdir(parents=True, exist_ok=True)
        local.write_bytes(self._request("GET", self._url(self._key(rel))))

    def _iter_keys(self, probe: str):
        token = ""
        while True:
            q = "list-type=2&prefix=" + urllib.parse.quote(probe, safe="")
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token, safe="")
            body = self._request("GET", self._url(query=q))
            root = ET.fromstring(body)
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            for c in root.findall(f"{ns}Contents/{ns}Key"):
                yield c.text or ""
            token = (root.findtext(f"{ns}NextContinuationToken") or "").strip()
            if not token:
                return

    def delete(self, rel: str) -> None:
        self._request("DELETE", self._url(self._key(rel)))


# -- GCS JSON API ------------------------------------------------------------


class HttpGcsFS(_PrefixedCloudFS):
    """GCS RemoteFS over the JSON/upload API with a Bearer token
    (pkg/fs/remote/gcp analog).  token_fn supplies a fresh OAuth2 token
    (a static lambda in tests; metadata-server fetch in deployments)."""

    def __init__(self, endpoint: str, bucket: str, *, token_fn, prefix: str = ""):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.token_fn = token_fn
        self.prefix = prefix.strip("/")

    def _request(self, method: str, url: str, payload: bytes | None = None) -> bytes:
        req = urllib.request.Request(url, data=payload, method=method)
        req.add_header("Authorization", f"Bearer {self.token_fn()}")
        return _http(req)

    def put(self, rel: str, local: Path) -> None:
        name = urllib.parse.quote(self._key(rel), safe="")
        url = (
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={name}"
        )
        self._request("POST", url, Path(local).read_bytes())

    def get(self, rel: str, local: Path) -> None:
        local = Path(local)
        local.parent.mkdir(parents=True, exist_ok=True)
        name = urllib.parse.quote(self._key(rel), safe="")
        url = f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{name}?alt=media"
        local.write_bytes(self._request("GET", url))

    def _iter_keys(self, probe: str):
        import json

        token = ""
        while True:
            url = (
                f"{self.endpoint}/storage/v1/b/{self.bucket}/o"
                f"?prefix={urllib.parse.quote(probe, safe='')}"
            )
            if token:
                url += "&pageToken=" + urllib.parse.quote(token, safe="")
            resp = json.loads(self._request("GET", url))
            for o in resp.get("items", []):
                yield o["name"]
            token = resp.get("nextPageToken", "")
            if not token:
                return


# -- Azure Blob SharedKey ----------------------------------------------------


def azure_sharedkey_auth(
    method: str,
    url: str,
    *,
    account: str,
    key_b64: str,
    content_length: int,
    extra_headers: dict[str, str],
) -> str:
    """Authorization header for Azure Blob SharedKey (the reference's
    pkg/fs/remote/azure auth path): hmac-sha256 over the canonicalized
    string-to-sign."""
    import base64

    u = urllib.parse.urlsplit(url)
    canon_headers = "".join(
        f"{k}:{extra_headers[k]}\n"
        for k in sorted(extra_headers)
        if k.startswith("x-ms-")
    )
    canon_resource = f"/{account}{u.path}"
    if u.query:
        for k, v in sorted(urllib.parse.parse_qsl(u.query, keep_blank_values=True)):
            canon_resource += f"\n{k}:{v}"
    string_to_sign = "\n".join(
        [
            method,
            "",  # Content-Encoding
            "",  # Content-Language
            str(content_length) if content_length else "",
            "",  # Content-MD5
            "",  # Content-Type
            "",  # Date (x-ms-date used instead)
            "",  # If-Modified-Since
            "",  # If-Match
            "",  # If-None-Match
            "",  # If-Unmodified-Since
            "",  # Range
            canon_headers + canon_resource,
        ]
    )
    sig = base64.b64encode(
        hmac.new(
            base64.b64decode(key_b64), string_to_sign.encode(), hashlib.sha256
        ).digest()
    ).decode()
    return f"SharedKey {account}:{sig}"


class HttpAzureBlobFS(_PrefixedCloudFS):
    """Azure Blob RemoteFS over REST + SharedKey (pkg/fs/remote/azure
    analog).  endpoint: e.g. "http://127.0.0.1:10000/devstoreaccount1"
    (azurite) or "https://<account>.blob.core.windows.net"."""

    def __init__(
        self,
        endpoint: str,
        container: str,
        *,
        account: str,
        key_b64: str,
        prefix: str = "",
    ):
        self.endpoint = endpoint.rstrip("/")
        self.container = container
        self.account = account
        self.key_b64 = key_b64
        self.prefix = prefix.strip("/")

    def _request(
        self, method: str, url: str, payload: bytes | None = None, blob: bool = False
    ) -> bytes:
        now = datetime.datetime.now(datetime.timezone.utc)
        hdrs = {
            "x-ms-date": now.strftime("%a, %d %b %Y %H:%M:%S GMT"),
            "x-ms-version": "2021-08-06",
        }
        if blob:
            hdrs["x-ms-blob-type"] = "BlockBlob"
        auth = azure_sharedkey_auth(
            method,
            url,
            account=self.account,
            key_b64=self.key_b64,
            content_length=len(payload) if payload else 0,
            extra_headers=hdrs,
        )
        req = urllib.request.Request(url, data=payload, method=method)
        for k, v in hdrs.items():
            req.add_header(k, v)
        req.add_header("Authorization", auth)
        return _http(req)

    def put(self, rel: str, local: Path) -> None:
        url = f"{self.endpoint}/{self.container}/{urllib.parse.quote(self._key(rel))}"
        self._request("PUT", url, Path(local).read_bytes(), blob=True)

    def get(self, rel: str, local: Path) -> None:
        local = Path(local)
        local.parent.mkdir(parents=True, exist_ok=True)
        url = f"{self.endpoint}/{self.container}/{urllib.parse.quote(self._key(rel))}"
        local.write_bytes(self._request("GET", url))

    def _iter_keys(self, probe: str):
        marker = ""
        while True:
            url = (
                f"{self.endpoint}/{self.container}?restype=container&comp=list"
                f"&prefix={urllib.parse.quote(probe, safe='')}"
            )
            if marker:
                url += "&marker=" + urllib.parse.quote(marker, safe="")
            root = ET.fromstring(self._request("GET", url))
            for name in root.iter("Name"):
                yield name.text or ""
            marker = (root.findtext("NextMarker") or "").strip()
            if not marker:
                return
