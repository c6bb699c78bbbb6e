"""SHA256 pin check for licensed assets (copy of the JAX package's
utils/integrity.verify_pinned).

Pin file format (`asset/SHA256SUMS`, sha256sum-compatible):
    <hex sha256>  <path relative to the pin file's directory>
"""

from __future__ import annotations

import hashlib
import logging
import os

_logger = logging.getLogger(__name__)

PIN_BASENAME = "SHA256SUMS"


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _find_pin_file(path: str) -> str | None:
    """Nearest SHA256SUMS walking up from the file's directory."""
    d = os.path.dirname(os.path.abspath(path))
    while True:
        cand = os.path.join(d, PIN_BASENAME)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def _load_pins(pin_file: str) -> dict[str, str]:
    pins: dict[str, str] = {}
    with open(pin_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            digest, _, rel = line.partition("  ")
            if len(digest) == 64 and rel:
                pins[rel.strip()] = digest.lower()
    return pins


def verify_pinned(path: str, *, what: str = "asset") -> bool:
    """True when a pin covers `path` and matches; False (with a warning) when
    no pin covers it; raises ValueError on a mismatch."""
    pin_file = _find_pin_file(path)
    if pin_file is None:
        _logger.warning("%s %s is UNPINNED (no SHA256SUMS near it)", what, path)
        return False
    rel = os.path.relpath(os.path.abspath(path), os.path.dirname(pin_file))
    expected = _load_pins(pin_file).get(rel.replace(os.sep, "/"))
    if expected is None:
        _logger.warning("%s %s is UNPINNED (not listed in %s)", what, path, pin_file)
        return False
    actual = sha256_file(path)
    if actual != expected:
        raise ValueError(
            f"{what} {path} FAILS its integrity pin: sha256 {actual} != pinned "
            f"{expected} ({pin_file})"
        )
    return True
