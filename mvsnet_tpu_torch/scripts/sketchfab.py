"""Sketchfab upload (a copy of scripts/sketchfab.py; parity: the
reference's scripts/sketchfab.py:1-78). Not run by the tests: it needs the
network.

The API token comes from the SKETCHFAB_API_TOKEN environment variable (the
reference hardcoded a token in source — don't do that).
"""

from __future__ import annotations

import json
import os

SKETCHFAB_DOMAIN = "sketchfab.com"
SKETCHFAB_API_URL = f"https://api.{SKETCHFAB_DOMAIN}/v3"


def _get_request_payload(api_token, data=None, files=None, json_payload=False):
    headers = {"Authorization": f"Token {api_token}"}
    data = data or {}
    files = files or {}
    if json_payload:
        headers.update({"Content-Type": "application/json"})
        data = json.dumps(data)
    return {"data": data, "files": files, "headers": headers}


def upload(model_file: str, api_token: str | None = None, name: str = "",
           description: str = "") -> str:
    """POST a model; returns the model URL."""
    import requests

    api_token = api_token or os.environ.get("SKETCHFAB_API_TOKEN")
    if not api_token:
        raise RuntimeError("set SKETCHFAB_API_TOKEN to enable uploads")
    model_endpoint = f"{SKETCHFAB_API_URL}/models"
    data = {"name": name, "description": description,
            "tags": ["mvsnet_tpu", "point-cloud"], "isPublished": False}
    with open(model_file, "rb") as f:
        files = {"modelFile": f}
        payload = _get_request_payload(api_token, data=data, files=files)
        r = requests.post(model_endpoint, **payload)
    r.raise_for_status()
    uid = r.json()["uid"]
    return f"https://{SKETCHFAB_DOMAIN}/models/{uid}"
