"""Native S3 client: urllib and hmac SigV4, no boto3.

A copy of ``spherical_dyffusion_tpu/utils/s3.py`` (the standard library
only; the port imports nothing of the JAX package): list (paginated,
wildcard-filtered), download, upload and delete against a custom endpoint,
with anonymous or AWS-SigV4-signed requests, over the S3 REST API with
path-style addressing. ``S3_ENDPOINT_URL`` or ``endpoint_url`` names the
endpoint, so a loopback server can stand in for it.
"""

from __future__ import annotations

import datetime
import fnmatch
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import List, Optional

__all__ = ["S3Client", "get_s3_objects", "download_s3_path"]

_XMLNS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class S3Client:
    """Minimal S3 REST client with SigV4 signing (path-style addressing).

    Credentials come from ``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY``
    (anonymous requests when absent — the reference's UNSIGNED fallback,
    s3utils.py:42-43); the endpoint from ``endpoint_url`` or
    ``S3_ENDPOINT_URL``.
    """

    def __init__(self, bucket: str, endpoint_url: Optional[str] = None,
                 region: str = "us-east-1",
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None):
        self.bucket = bucket
        self.endpoint = (endpoint_url or os.environ.get("S3_ENDPOINT_URL")
                         or "https://s3.amazonaws.com").rstrip("/")
        self.region = region
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY")

    # -- SigV4 ------------------------------------------------------------
    def _sign(self, method: str, path: str, query: dict, payload: bytes):
        """Return headers for the request; SigV4-signed when credentialed."""
        host = urllib.parse.urlparse(self.endpoint).netloc
        payload_hash = _sha256(payload)
        headers = {"host": host, "x-amz-content-sha256": payload_hash}
        if not (self.access_key and self.secret_key):
            return headers  # anonymous
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers["x-amz-date"] = amz_date
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(str(v), safe='')}"
            for k, v in sorted(query.items()))
        signed_names = sorted(headers)
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in signed_names)
        signed_headers = ";".join(signed_names)
        canonical_request = "\n".join([
            method, urllib.parse.quote(path), canonical_query,
            canonical_headers, signed_headers, payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope, _sha256(canonical_request.encode())])
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}")
        return headers

    def _request(self, method: str, key: str = "", query: Optional[dict] = None,
                 payload: bytes = b"") -> bytes:
        query = query or {}
        path = "/" + self.bucket + (f"/{key}" if key else "")
        headers = self._sign(method, path, query, payload)
        qs = urllib.parse.urlencode(sorted(query.items()))
        url = self.endpoint + urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=payload or None, method=method)
        for k, v in headers.items():
            if k != "host":  # urllib sets Host itself
                req.add_header(k, v)
        with urllib.request.urlopen(req) as resp:
            return resp.read()

    # -- API --------------------------------------------------------------
    def upload(self, local_path: str, key: str) -> None:
        with open(local_path, "rb") as f:
            self._request("PUT", key, payload=f.read())

    def put_bytes(self, key: str, data: bytes) -> None:
        self._request("PUT", key, payload=data)

    def get_bytes(self, key: str) -> bytes:
        return self._request("GET", key)

    def download(self, key: str, local_path: str) -> None:
        data = self._request("GET", key)
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        with open(local_path, "wb") as f:
            f.write(data)

    def delete(self, key: str) -> None:
        self._request("DELETE", key)

    def list(self, prefix: str = "", delimiter: str = "") -> List[str]:
        """Paginated ListObjectsV2 (the reference paginates via boto,
        s3utils.py:96-97); returns object keys."""
        keys: List[str] = []
        token = None
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if delimiter:
                query["delimiter"] = delimiter
            if token:
                query["continuation-token"] = token
            root = ET.fromstring(self._request("GET", "", query=query))
            for c in root.iter(f"{_XMLNS}Contents"):
                keys.append(c.find(f"{_XMLNS}Key").text)
            trunc = root.find(f"{_XMLNS}IsTruncated")
            if trunc is None or trunc.text != "true":
                break
            token = root.find(f"{_XMLNS}NextContinuationToken").text
        return keys


def get_s3_objects(client: S3Client, s3_path: str) -> List[str]:
    """Keys under ``s3_path``, with reference-style ``*`` wildcard support
    (s3utils.py:80-108: the part before the first ``*`` is the listing
    prefix, the remainder an fnmatch pattern on the tail)."""
    i = s3_path.find("*")
    if i == -1:
        return client.list(prefix=s3_path)
    prefix = s3_path[:i]
    pattern = s3_path[i:]
    return [k for k in client.list(prefix=prefix)
            if fnmatch.fnmatch(k[len(prefix):], pattern)]


def download_s3_path(client: S3Client, s3_path: str, local_path: str = "./") -> List[str]:
    """Recursively download everything matching ``s3_path`` (reference
    download_s3_path/download_s3_objects, s3utils.py:111-165); skips files
    that already exist locally, like the reference."""
    done = []
    for key in get_s3_objects(client, s3_path):
        dst = os.path.join(local_path, key)
        if not os.path.exists(dst):
            client.download(key, dst)
        done.append(dst)
    return done
