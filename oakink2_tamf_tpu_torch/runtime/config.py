"""Typed layered config system (copy of oakink2_tamf_tpu/runtime/config.py;
`sync_global_timestamp` uses torch.distributed instead of JAX).

Re-provides the capability surface of the reference's config_reg registry +
dev_fn/upkeep/config.py (SURVEY §2.5, §5 'Config / flag system'):

- typed entries with dotted-key prefixes (`train.loss.coef_rec_joint_loss`)
- layered YAML: repeated `--cfg a.yml --cfg b.yml` merged in order, then CLI
  flags override (`--train.batch_size 64`)
- list entries with colon/comma separators on the command line
- `?(...)` substitutions:
    ?(ts) / ?(ts:full)  timestamp of process start  (upkeep/ckpt.py:28-60)
    ?(ts:date)          date-only stamp
    ?(prog)             program name
    ?(file:PATH)        expand to the stripped lines of PATH (split files,
                        upkeep/config.py:25-72), deduplicated
- required/default semantics; unknown keys in YAML are carried through so
  model/loss sub-dicts can be free-form
- `select(prefix)` -> nested plain dict
"""

from __future__ import annotations

import argparse
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import yaml

GLOBAL_TIMESTAMP = time.time()

_SPECIAL = re.compile(r"\?\(([^)]*)\)")


def sync_global_timestamp() -> None:
    """Multi-process runs: make `?(ts)` expand identically in every process.
    The default exp_id is `?(prog)__?(ts)` (launch/param.py); with a stamp
    per process each one would write its part of one logical run into a
    different common/<prog>/<exp_id> tree. When torch.distributed is
    initialised with more than one process, rank 0's stamp is broadcast;
    otherwise nothing happens."""
    global GLOBAL_TIMESTAMP
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return
    box = [GLOBAL_TIMESTAMP]
    dist.broadcast_object_list(box, src=0)
    GLOBAL_TIMESTAMP = float(box[0])


class Unspecified:
    def __repr__(self):
        return "<unspecified>"

    def __bool__(self):
        # falsy: every launcher reads optional entries with the
        # `reg.select(...).get(key) or fallback` idiom — a truthy sentinel
        # would leak into int()/open() calls far from the config layer
        return False


UNSPECIFIED = Unspecified()


def _split_outside_subst(raw: str, sep: str) -> list[str]:
    """Split `raw` on `sep`, treating `?(...)` substitution tokens as atoms
    (their contents — e.g. the colon in `?(file:path)` — never split)."""
    spans = [m.span() for m in _SPECIAL.finditer(raw)]
    parts, start = [], 0
    i = 0
    while i < len(raw):
        if raw[i] == sep and not any(a <= i < b for a, b in spans):
            parts.append(raw[start:i])
            start = i + 1
        i += 1
    parts.append(raw[start:])
    return parts


def _load_fileline(path: str) -> list[str]:
    res = []
    path = os.path.normpath(os.path.abspath(path))
    if os.path.exists(path):
        with open(path) as f:
            for line in f.read().splitlines():
                line = line.strip()
                if line:
                    res.append(line)
    return list(dict.fromkeys(res))


def substitute(value: Any, prog: str = "", extra: dict[str, str] | None = None) -> Any:
    """Apply ?(...) substitutions to a string or each element of a list."""
    extra = extra or {}

    def sub_str(s: str) -> str:
        def repl(m):
            cmd = m.group(1)
            if cmd in ("ts", "ts:full"):
                return time.strftime("%Y_%m%d_%H%M_%S", time.localtime(GLOBAL_TIMESTAMP))
            if cmd == "ts:date":
                return time.strftime("%Y_%m%d", time.localtime(GLOBAL_TIMESTAMP))
            if cmd == "prog":
                return prog
            if cmd in extra:
                return extra[cmd]
            return ""

        return _SPECIAL.sub(repl, s)

    if isinstance(value, str):
        return sub_str(value)
    if isinstance(value, list):
        out: list[Any] = []
        for el in value:
            if isinstance(el, str):
                m = _SPECIAL.fullmatch(el)
                if m and m.group(1).startswith("file:"):
                    out.extend(_load_fileline(m.group(1)[len("file:") :]))
                    continue
                out.append(sub_str(el))
            else:
                out.append(el)
        return list(dict.fromkeys(out)) if all(isinstance(e, str) for e in out) else out
    return value


@dataclass
class ConfigEntry:
    key: str  # full dotted key
    category: type = str
    default: Any = UNSPECIFIED
    required: bool = False
    desc: str = ""
    is_list: bool = False
    sep: str = ","  # list separator on the command line (also ':')
    choices: Optional[Sequence[Any]] = None
    callback: Optional[Callable[[Any, "ConfigRegistry"], Any]] = None
    cli: bool = True  # expose as a command-line flag


def _flatten(d: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in d.items():
        full = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, full))
        else:
            out[full] = v
    return out


def _nest(flat: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


class ConfigRegistry:
    def __init__(self, prog: str):
        self.prog = prog
        self.entries: dict[str, ConfigEntry] = {}
        self.values: dict[str, Any] = {}
        self.meta_info: dict[str, Any] = {}

    def register(
        self,
        key: str,
        prefix: Optional[str] = None,
        category: type = str,
        default: Any = UNSPECIFIED,
        required: bool = False,
        desc: str = "",
        is_list: bool = False,
        choices: Optional[Sequence[Any]] = None,
        callback: Optional[Callable[[Any, "ConfigRegistry"], Any]] = None,
        cli: bool = True,
        sep: str = ",",
    ) -> None:
        full = f"{prefix}.{key}" if prefix else key
        self.entries[full] = ConfigEntry(
            key=full,
            category=category,
            default=default,
            required=required,
            desc=desc,
            is_list=is_list,
            choices=choices,
            callback=callback,
            cli=cli,
            sep=sep,
        )

    # -- parsing -----------------------------------------------------------

    def hook(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--cfg", action="append", default=[], help="layered yaml config (repeatable)")
        parser.add_argument("--commit", action="store_true", help="run in commit mode (write outputs)")
        for entry in self.entries.values():
            if not entry.cli:
                continue
            flag = f"--{entry.key}"
            if entry.category is bool and not entry.is_list:
                parser.add_argument(flag, default=None, type=str, help=entry.desc, metavar="BOOL")
            else:
                parser.add_argument(flag, default=None, type=str, help=entry.desc)

    def parse(self, parser: argparse.ArgumentParser, argv: Optional[Sequence[str]] = None) -> dict:
        args = parser.parse_args(argv)
        flat: dict[str, Any] = {}

        # layer 1: YAML files in order
        for cfg_path in args.cfg:
            with open(cfg_path) as f:
                data = yaml.safe_load(f) or {}
            flat.update(_flatten(data))

        # layer 2: CLI overrides
        for entry in self.entries.values():
            if not entry.cli:
                continue
            raw = getattr(args, entry.key.replace("-", "_"), None)
            if raw is None:
                continue
            flat[entry.key] = self._parse_cli_value(entry, raw)

        self.values = {}
        # registered entries: coerce + default + substitute
        for key, entry in self.entries.items():
            if key in flat:
                val = self._coerce(entry, flat.pop(key))
            elif entry.default is not UNSPECIFIED:
                val = entry.default
            elif entry.required:
                raise KeyError(f"missing required config entry: {key}")
            else:
                val = UNSPECIFIED
            val = substitute(val, self.prog)
            if entry.callback is not None:
                val = entry.callback(val, self)
            if entry.choices is not None and val not in (UNSPECIFIED, None) and val not in entry.choices:
                raise ValueError(f"{key}: {val!r} not in {entry.choices}")
            self.values[key] = val

        # unregistered YAML keys carried through verbatim (free-form sub-dicts)
        for key, val in flat.items():
            self.values[key] = substitute(val, self.prog)

        self.values["commit"] = bool(args.commit)
        return self.values

    def _parse_cli_value(self, entry: ConfigEntry, raw: str) -> Any:
        if entry.is_list:
            # split ONLY on the entry's registered separator (reference
            # config_reg's COLON_SEP/COMMA_SEP patterns): splitting on both
            # would mangle elements that legitimately contain the other
            # character — and NEVER inside a ?(...) substitution token,
            # whose expansion runs after this split (the documented
            # `--train.process_range "?(file:asset/split/train.txt)"` form
            # contains the colon separator itself)
            parts = [p for p in _split_outside_subst(raw, entry.sep) if p]
            return [self._cast_scalar(entry.category, p) for p in parts]
        return self._cast_scalar(entry.category, raw)

    @staticmethod
    def _cast_scalar(category: type, raw: Any) -> Any:
        if isinstance(raw, category):
            return raw
        if category is bool:
            return str(raw).lower() in ("1", "true", "yes", "on")
        return category(raw)

    def _coerce(self, entry: ConfigEntry, val: Any) -> Any:
        if entry.is_list:
            if isinstance(val, str):
                return self._parse_cli_value(entry, val)
            return [self._cast_scalar(entry.category, v) for v in val]
        return self._cast_scalar(entry.category, val) if not isinstance(val, Unspecified) else val

    # -- access ------------------------------------------------------------

    def select(self, prefix: Optional[str] = None) -> Any:
        """Nested dict under `prefix` (or the scalar value at that exact key)."""
        if prefix is None:
            return _nest(self.values)
        if prefix in self.values:
            return self.values[prefix]
        sub = {
            k[len(prefix) + 1 :]: v
            for k, v in self.values.items()
            if k.startswith(prefix + ".")
        }
        if not sub:
            raise KeyError(prefix)
        return _nest(sub)
