"""S3 authentication (the port's copy of htslib_tpu/remote/s3.py;
reference hfile_s3.c:1-2498): V2 HMAC-SHA1 and V4 AWS4-HMAC-SHA256
request signing, credentials from the environment, ~/.aws/credentials
and ~/.s3cfg profiles (reread near their expiry), and s3:// URLs
rewritten to https (virtual-host or path style)."""
from __future__ import annotations

import base64
import configparser
import datetime
import hashlib
import hmac
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class S3Auth:
    access_key: str = ""
    secret_key: str = ""
    session_token: str = ""
    region: str = "us-east-1"
    host: str = "s3.amazonaws.com"
    expiry: float = 0.0         # epoch seconds; 0 = never expires


CREDENTIAL_LIFETIME = 60   # hfile_s3.c:104 — reread this long before expiry
AUTH_LIFETIME = 60         # hfile_s3.c:103 — regenerate headers if older


def _parse_expiry(text: str) -> float:
    """ISO8601 expiry_time from ~/.aws/credentials (hfile_s3.c
    expiry-time parsing); 0 when unparsable."""
    text = text.strip().replace("Z", "+00:00")
    try:
        return datetime.datetime.fromisoformat(text).timestamp()
    except ValueError:
        return 0.0


class CredentialProvider:
    """Cached credentials with automatic refresh: rereads the discovery
    chain when within CREDENTIAL_LIFETIME seconds of expiry (the
    expiring-credential model of hfile_s3.c:104)."""

    def __init__(self, profile: Optional[str] = None):
        self.profile = profile
        self._auth: Optional[S3Auth] = None

    def get(self) -> S3Auth:
        now = time.time()
        if (self._auth is None
                or (self._auth.expiry
                    and now >= self._auth.expiry - CREDENTIAL_LIFETIME)):
            self._auth = load_credentials(self.profile)
        return self._auth


def load_credentials(profile: Optional[str] = None) -> S3Auth:
    """Credential discovery order (hfile_s3.c:383): env vars, then
    ~/.aws/credentials, then ~/.s3cfg."""
    auth = S3Auth()
    profile = profile or os.environ.get("AWS_PROFILE",
                                        os.environ.get("AWS_DEFAULT_PROFILE",
                                                       "default"))
    auth.access_key = os.environ.get("AWS_ACCESS_KEY_ID", "")
    auth.secret_key = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    auth.session_token = os.environ.get("AWS_SESSION_TOKEN", "")
    auth.region = os.environ.get("AWS_DEFAULT_REGION", auth.region)
    if auth.access_key:
        return auth
    path = os.environ.get("AWS_SHARED_CREDENTIALS_FILE",
                          os.path.expanduser("~/.aws/credentials"))
    if os.path.exists(path):
        cp = configparser.ConfigParser()
        cp.read(path)
        if cp.has_section(profile):
            auth.access_key = cp.get(profile, "aws_access_key_id", fallback="")
            auth.secret_key = cp.get(profile, "aws_secret_access_key", fallback="")
            auth.session_token = cp.get(profile, "aws_session_token", fallback="")
            auth.region = cp.get(profile, "region", fallback=auth.region)
            exp = cp.get(profile, "expiry_time", fallback="")
            if exp:
                auth.expiry = _parse_expiry(exp)
            if auth.access_key:
                return auth
    s3cfg = os.path.expanduser("~/.s3cfg")
    if os.path.exists(s3cfg):
        cp = configparser.ConfigParser()
        cp.read(s3cfg)
        sec = profile if cp.has_section(profile) else "default"
        if cp.has_section(sec):
            auth.access_key = cp.get(sec, "access_key", fallback="")
            auth.secret_key = cp.get(sec, "secret_key", fallback="")
            auth.host = cp.get(sec, "host_base", fallback=auth.host)
    return auth


# ---------------------------------------------------------------------------
# V2 signing (hfile_s3.c:115 s3_sign: HMAC-SHA1 over the string-to-sign)
# ---------------------------------------------------------------------------

def sign_v2(secret_key: str, string_to_sign: str) -> str:
    digest = hmac.new(secret_key.encode(), string_to_sign.encode(),
                      hashlib.sha1).digest()
    return base64.b64encode(digest).decode()


def v2_string_to_sign(method: str, bucket: str, key: str, date: str,
                      content_md5: str = "", content_type: str = "",
                      token: str = "") -> str:
    amz = f"x-amz-security-token:{token}\n" if token else ""
    return (f"{method}\n{content_md5}\n{content_type}\n{date}\n"
            f"{amz}/{bucket}/{key}")


def v2_auth_header(auth: S3Auth, method: str, bucket: str, key: str,
                   date: str) -> str:
    sts = v2_string_to_sign(method, bucket, key, date,
                            token=auth.session_token)
    return f"AWS {auth.access_key}:{sign_v2(auth.secret_key, sts)}"


# ---------------------------------------------------------------------------
# V4 signing (hfile_s3.c:143: AWS Signature Version 4)
# ---------------------------------------------------------------------------

def _hmac256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def v4_signing_key(secret_key: str, datestamp: str, region: str,
                   service: str = "s3") -> bytes:
    k = _hmac256(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac256(k, region)
    k = _hmac256(k, service)
    return _hmac256(k, "aws4_request")


def v4_canonical_request(method: str, path: str, query: str,
                         headers: Dict[str, str], signed_headers: str,
                         payload_hash: str) -> str:
    canon_headers = "".join(f"{k}:{headers[k]}\n"
                            for k in signed_headers.split(";"))
    return "\n".join([method, path, query, canon_headers, signed_headers,
                      payload_hash])


def v4_sign_request(auth: S3Auth, method: str, host: str, path: str,
                    query: str = "", amzdate: Optional[str] = None,
                    payload: bytes = b"") -> Dict[str, str]:
    """Returns the headers (incl. Authorization) for a V4-signed request."""
    if amzdate is None:
        amzdate = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
    datestamp = amzdate[:8]
    payload_hash = hashlib.sha256(payload).hexdigest()
    headers = {"host": host, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amzdate}
    if auth.session_token:
        headers["x-amz-security-token"] = auth.session_token
    signed = ";".join(sorted(headers))
    creq = v4_canonical_request(method, path, query, headers, signed,
                                payload_hash)
    scope = f"{datestamp}/{auth.region}/s3/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    key = v4_signing_key(auth.secret_key, datestamp, auth.region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={auth.access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    return headers


# ---------------------------------------------------------------------------
# URL handling
# ---------------------------------------------------------------------------

def parse_s3_url(url: str) -> Tuple[str, str, Optional[str]]:
    """s3://[profile@]bucket/key -> (bucket, key, profile)."""
    rest = url.split("://", 1)[1]
    profile = None
    if "@" in rest.split("/", 1)[0]:
        profile, rest = rest.split("@", 1)
    bucket, _, key = rest.partition("/")
    return bucket, key, profile


def s3_open(url: str, mode: str = "r"):
    from htslib_tpu_torch.remote import HttpFile
    bucket, key, profile = parse_s3_url(url)
    provider = CredentialProvider(profile)
    auth = provider.get()
    host = f"{bucket}.{auth.host}" if "." not in bucket else auth.host
    path = f"/{key}" if "." not in bucket else f"/{bucket}/{key}"
    https_url = f"https://{host}{path}"

    def signed_headers():
        a = provider.get()      # refreshes near expiry
        if not a.access_key:
            return {}
        return v4_sign_request(a, "GET", host, path)

    return HttpFile(https_url, headers_fn=signed_headers)
