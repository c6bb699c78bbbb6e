"""File and content MD5 digests (copy of oakink2_tamf_tpu/utils/hash_util.py;
the reference dev_fn/util/hash_util.py role)."""

from __future__ import annotations

import hashlib


def md5_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def md5_bytes(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()
