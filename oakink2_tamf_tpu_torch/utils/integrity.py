"""SHA256 pins for licensed assets (copy of the JAX package's
utils/integrity: verify_pinned, load_pins, record_pin).

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


def load_pins(pin_file: str) -> dict[str, str]:
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
    expected = load_pins(pin_file).get(rel.replace(os.sep, "/"))
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


def record_pin(path: str, pin_file: str) -> None:
    """Add the pin of `path` to `pin_file` (created when absent), writing
    the same bytes as the JAX package's record_pin: the file's comment
    lines kept (a default header for a new file), then every pin sorted
    by path. Refuses to change an existing pin: delete its line first if
    the upstream file legitimately changed."""
    rel = os.path.relpath(os.path.abspath(path), os.path.dirname(os.path.abspath(pin_file)))
    rel = rel.replace(os.sep, "/")
    digest = sha256_file(path)
    pins = load_pins(pin_file) if os.path.isfile(pin_file) else {}
    if rel in pins and pins[rel] != digest:
        raise ValueError(
            f"refusing to overwrite the existing pin for {rel} "
            f"({pins[rel]} -> {digest}): if the upstream asset legitimately "
            f"changed, delete its line from {pin_file} first."
        )
    pins[rel] = digest
    header = ["# sha256 integrity pins - verify with: (cd asset && sha256sum -c SHA256SUMS)\n"]
    if os.path.isfile(pin_file):
        with open(pin_file) as f:
            existing = [ln for ln in f if ln.startswith("#")]
        if existing:
            header = existing
    tmp = pin_file + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.writelines(header)
        for r in sorted(pins):
            f.write(f"{pins[r]}  {r}\n")
    os.replace(tmp, pin_file)
