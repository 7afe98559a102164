"""JSON config system with composition and dotlist overrides.

Counterpart of ``spherical_dyffusion_tpu/utils/config.py`` on JSON files
(the port does not import yaml): ``configs/**/*.json`` are copies of the
JAX package's YAML tree, file for file, and ``load_config`` composes them
the same way:

* ``defaults:`` composition (``name`` merged at the root, ``{group: name}``
  under ``group`` or at the root with ``_global_``, ``_self_`` placing the
  file's own content, ``../main`` and the sibling-group fallback);
* ``${a.b.c}`` interpolation;
* dotlist overrides (``model.embed_dim=128``, ``++new.key=1``);
* ``deep_update``, the merge of override dicts;
* a group choice (``load_config(..., groups={"model": "unet"})``, which the
  command line's ``model=unet`` makes): that file replaces the group's
  entry in every ``defaults`` list, the files' own content still merged
  over it, as Hydra composes a choice. The JAX command line reads
  ``model=unet`` as a dotlist value; the port composes it.

A dotlist value is parsed as ``yaml.safe_load`` parses it (YAML 1.1's
implicit types: ``1e-3`` is a string, ``4.0e-3`` a float, ``yes``/``off``
bools, ``0x10`` 16, ``08`` a string), by ``parse_scalar``, which takes
plain scalars, quoted strings and flow lists of plain scalars, and raises
``ValueError`` on any other form rather than guess. Of the numbers, it
takes decimal ints and floats, hex ints, ``.inf`` and ``.nan``; a binary,
octal, sexagesimal or underscored number, which YAML 1.1 also reads, raises.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, Optional, Sequence

__all__ = ["load_config", "deep_update", "apply_dotlist", "resolve_interpolations",
           "parse_scalar", "with_platform", "CONFIG_DIR"]

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_INLINE_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")

# PyYAML's implicit resolvers (yaml/resolver.py), in its order; ``_number`` takes a
# subset of the numbers they match
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_BOOLS = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
# characters that open a YAML construct other than a plain scalar
_INDICATORS = set("{}]#&*!|>%@`,?:")


def _number(s: str, is_int: bool) -> Any:
    v = s.lstrip("+-")
    if ("_" in v or ":" in v or v.startswith("0b")
            or (is_int and v[0] == "0" and v != "0" and not v.startswith("0x"))):
        raise ValueError(f"config value {s!r}: YAML reads a binary, octal, sexagesimal or "
                         "underscored number here; write it in decimal or quote it")
    if is_int:
        return int(s, 16) if v.startswith("0x") else int(s)
    return float(s.replace(".", "", 1)) if v.lower() in (".inf", ".nan") else float(s)


def _plain(s: str) -> Any:
    if _NULL_RE.match(s):
        return None
    if _BOOL_RE.match(s):
        return _BOOLS[s.lower()]
    if _FLOAT_RE.match(s):
        return _number(s, is_int=False)
    if _INT_RE.match(s):
        return _number(s, is_int=True)
    if _TIMESTAMP_RE.match(s) or s in ("=", "<<"):
        raise ValueError(f"config value {s!r}: YAML would read a timestamp, value or merge "
                         "key; quote it")
    return s


def _check_plain(s: str, raw: str) -> None:
    if s[0] in _INDICATORS or s[0] in "'\"[" or (s[0] == "-" and (len(s) == 1 or s[1] == " ")):
        raise ValueError(f"config value {raw!r}: not a plain scalar, quoted string or flow list")
    if ": " in s or s.endswith(":") or " #" in s or any(c in s for c in "\t\n\r"):
        raise ValueError(f"config value {raw!r}: YAML would not read it as one scalar; quote it")


def parse_scalar(raw: str) -> Any:
    """A dotlist value as ``yaml.safe_load`` reads it: null, bool, int,
    float or string by YAML 1.1's implicit rules; a single- or
    double-quoted string (no escapes); a flow list ``[a, b]`` of plain
    scalars. Any other form raises ``ValueError``."""
    s = raw.strip(" ")
    if not s:
        return None
    if s[0] == "'":
        inner = s[1:-1] if len(s) >= 2 and s[-1] == "'" else None
        if inner is None or "'" in inner.replace("''", ""):
            raise ValueError(f"config value {raw!r}: unbalanced single quotes")
        return inner.replace("''", "'")
    if s[0] == '"':
        inner = s[1:-1] if len(s) >= 2 and s[-1] == '"' else None
        if inner is None or '"' in inner or "\\" in inner:
            raise ValueError(f"config value {raw!r}: double-quoted strings with escapes or "
                             "inner quotes are not taken")
        return inner
    if s[0] == "[":
        if s[-1] != "]" or any(c in s[1:-1] for c in "[]{}'\""):
            raise ValueError(f"config value {raw!r}: only flat lists of plain scalars are taken")
        body = s[1:-1].strip(" ")
        if not body:
            return []
        items = [i.strip(" ") for i in body.split(",")]
        if items[-1] == "":
            items.pop()
        if any(not i for i in items):
            raise ValueError(f"config value {raw!r}: empty list item")
        out = []
        for item in items:
            _check_plain(item, raw)
            out.append(_plain(item))
        return out
    _check_plain(s, raw)
    return _plain(s)


def deep_update(base: Dict, other: Dict) -> Dict:
    """Recursive dict merge; ``other`` wins."""
    out = copy.deepcopy(base)
    for k, v in (other or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def apply_dotlist(cfg: Dict, overrides: Sequence[str]) -> Dict:
    """Apply ``a.b.c=value`` overrides (a ``+``/``++`` prefix allows new keys)."""
    cfg = copy.deepcopy(cfg)
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must be key=value")
        key, val = item.split("=", 1)
        allow_new = key.startswith("+")
        key = key.lstrip("+")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node:
                if not allow_new:
                    raise KeyError(f"Unknown config key {key!r} (use ++ to add)")
                node[p] = {}
            node = node[p]
        if parts[-1] not in node and not allow_new:
            raise KeyError(f"Unknown config key {key!r} (use ++ to add)")
        node[parts[-1]] = parse_scalar(val)
    return cfg


def _lookup(cfg: Dict, dotted: str) -> Any:
    node = cfg
    for p in dotted.split("."):
        node = node[p]
    return node


def resolve_interpolations(cfg: Dict, root: Optional[Dict] = None) -> Dict:
    """Resolve ``${a.b}`` references against the root config."""
    root = root if root is not None else cfg

    def resolve(v):
        if isinstance(v, dict):
            return {k: resolve(x) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve(x) for x in v]
        if isinstance(v, str):
            m = _INTERP_RE.match(v)
            if m:
                return resolve(_lookup(root, m.group(1)))
            if _INTERP_INLINE_RE.search(v):
                return _INTERP_INLINE_RE.sub(lambda mm: str(resolve(_lookup(root, mm.group(1)))),
                                             v)
        return v

    out = cfg
    for _ in range(5):  # nested references, to a fixpoint (bounded)
        new = resolve(out)
        if new == out:
            break
        out = new
    return out


def load_config(path: str, overrides: Sequence[str] = (),
                groups: Optional[Dict[str, str]] = None) -> Dict:
    """Load a JSON config, compose its ``defaults`` list (with ``groups``'
    choices in place of its entries for those groups), apply overrides and
    resolve interpolations. Group references resolve relative to the file
    being loaded, then to its parent directory. A chosen group that no
    ``defaults`` list holds raises ``ValueError``."""
    used: set = set()
    merged = _compose(path, dict(groups or {}), used)
    missing = sorted(set(groups or {}) - used)
    if missing:
        raise ValueError(f"group choice {missing}: no defaults list of {path} holds that group")
    if overrides:
        merged = apply_dotlist(merged, overrides)
    return resolve_interpolations(merged)


def _compose(path: str, groups: Dict[str, str], used: set) -> Dict:
    config_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        own = json.load(f) or {}
    defaults = own.pop("defaults", None)
    if defaults is None:
        merged = own
    else:
        merged: Dict = {}
        placed_self = False
        for entry in defaults:
            if entry == "_self_":
                merged = deep_update(merged, own)
                placed_self = True
            elif isinstance(entry, str):
                merged = deep_update(merged, _compose(_resolve_path(config_dir, entry), groups,
                                                      used))
            elif isinstance(entry, dict):
                (group, name), = entry.items()
                if str(group) in groups:
                    name = groups[str(group)]
                    used.add(str(group))
                if name in (None, "null"):
                    continue
                rel = os.path.join(str(group), str(name))
                sub_path = _resolve_path(config_dir, rel)
                if not os.path.exists(sub_path):
                    alt = _resolve_path(os.path.dirname(config_dir), rel)
                    if os.path.exists(alt):
                        sub_path = alt
                sub = _compose(sub_path, groups, used)
                if sub.pop("_global_", False):
                    merged = deep_update(merged, sub)
                else:
                    merged = deep_update(merged, {str(group): sub})
            else:
                raise ValueError(f"Bad defaults entry: {entry!r}")
        if not placed_self:
            merged = deep_update(merged, own)
    return merged


def with_platform(overrides: Sequence[str]) -> list:
    """The command lines' ``platform=<p>`` argument as ``++platform=<p>``:
    the configs carry no ``platform`` key, and the argument may set it."""
    return ["++" + o if o.startswith("platform=") else o for o in overrides]


def _resolve_path(config_dir: str, name: str) -> str:
    if not name.endswith(".json"):
        name = name + ".json"
    return name if os.path.isabs(name) else os.path.join(config_dir, name)
