"""Google Cloud Storage (the port's copy of htslib_tpu/remote/gcs.py;
reference hfile_gcs.c:1-160):
gs://bucket/object -> https rewrite with an optional bearer token from
GCS_OAUTH_TOKEN."""
from __future__ import annotations

import os


def gcs_open(url: str, mode: str = "r"):
    from htslib_tpu_torch.remote import HttpFile
    rest = url.split("://", 1)[1]
    bucket, _, obj = rest.partition("/")
    if "@" in bucket:
        _, bucket = bucket.split("@", 1)
    https_url = f"https://storage.googleapis.com/{bucket}/{obj}"
    headers = {}
    token = os.environ.get("GCS_OAUTH_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    return HttpFile(https_url, headers=headers)
