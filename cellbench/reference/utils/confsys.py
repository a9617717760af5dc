# Frozen copy of mppiisaac_tpu_torch/utils/confsys.py, part of the benchmark's yardstick.
"""Minimal hydra-style config composition with its own YAML reader.

Same composition model as the reference package's `utils/confsys.py`:

* a config *root* directory with group subdirectories (`conf/mppi/*.yaml`, ...)
* per-task YAMLs with a ``defaults:`` list (``- group: name`` entries, and
  ``_self_`` ordering semantics)
* dotted CLI overrides: ``mppi.num_samples=500`` (parsed as YAML scalars)

PyYAML is not a dependency of the port, so `safe_load` below reads the subset
of YAML that `conf/` uses: block maps (nested by indentation), block lists of
scalars or one-line maps, flow lists (nested, possibly spanning lines),
scalars with PyYAML's YAML 1.1 resolution (int, float, bool, null, string,
quoted string) and `#` comments. Anything else raises ValueError.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), restricted to the scalar
# kinds the subset knows
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}


def parse_scalar(text: str) -> Any:
    """One plain or quoted scalar, resolved as `yaml.safe_load` would."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if _NULL.match(t):
        return None
    if _BOOL.match(t):
        return t in _TRUE
    if _INT.match(t):
        s = t.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if len(s) > 1 and s[0] == "0":
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(t):
        s = t.replace("_", "").lower()
        if s.endswith("inf"):
            return float("-inf") if s.startswith("-") else float("inf")
        if s.endswith("nan"):
            return float("nan")
        return float(s)
    if t[0] in "[]{}&*!|>%@`" or _key_colon(t) >= 0:
        raise ValueError(f"YAML construct outside the supported subset: {t!r}")
    return t


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (start of line, or after whitespace) outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _parse_flow(text: str) -> Any:
    """A flow list `[a, [b, c], d]` (nesting allowed) or a plain scalar."""
    t = text.strip()
    if not t.startswith("["):
        return parse_scalar(t)
    pos = 0

    def parse_list() -> Tuple[list, int]:
        nonlocal pos
        assert t[pos] == "["
        pos += 1
        out: list = []
        item_start = pos
        expect_item = True
        while pos < len(t):
            ch = t[pos]
            if ch == "[":
                out.append(parse_list()[0])
                expect_item = False
                item_start = pos
                continue
            if ch in ",]":
                tok = t[item_start:pos].strip()
                if tok:
                    if not expect_item:
                        raise ValueError(f"malformed flow list: {t!r}")
                    out.append(parse_scalar(tok))
                pos += 1
                item_start = pos
                expect_item = True
                if ch == "]":
                    return out, pos
                continue
            pos += 1
        raise ValueError(f"unterminated flow list: {t!r}")

    val, end = parse_list()
    if t[end:].strip():
        raise ValueError(f"trailing text after flow list: {t!r}")
    return val


def _logical_lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) per logical line: comments and blank lines dropped,
    flow lists that span lines joined."""
    out: List[Tuple[int, str]] = []
    pending: Optional[Tuple[int, str]] = None
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tab indentation is outside the supported subset")
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            ind, acc = pending
            acc = acc + " " + line.strip()
            if acc.count("[") <= acc.count("]"):
                out.append((ind, acc))
                pending = None
            else:
                pending = (ind, acc)
            continue
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise ValueError("multi-document YAML is outside the supported subset")
        ind = len(line) - len(line.lstrip(" "))
        content = line.strip()
        if content.count("[") > content.count("]"):
            pending = (ind, content)
        else:
            out.append((ind, content))
    if pending is not None:
        raise ValueError("unterminated flow list")
    return out


def _key_colon(content: str) -> int:
    """Index of the `: ` (or final `:`) that ends a mapping key, outside
    quotes and flow lists; -1 when the line is no `key: value`."""
    quote, depth = None, 0
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(content) or content[i + 1] == " "):
            return i
    return -1


def _split_key(content: str) -> Tuple[str, Optional[str]]:
    """`key: value` → (key, value or None when the value is a nested block)."""
    i = _key_colon(content)
    if i < 0:
        raise ValueError(f"expected `key: value`, got {content!r}")
    v = content[i + 1:].strip()
    return _parse_key(content[:i]), (v if v else None)


def _parse_key(k: str) -> str:
    k = k.strip()
    if len(k) >= 2 and k[0] == k[-1] and k[0] in "'\"":
        return k[1:-1]
    return k


def _parse_block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    """Parse the block (map or list) whose lines sit at `indent`, from line i."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out_l: list = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            item = lines[i][1][1:].strip()
            i += 1
            if not item:
                if i < len(lines) and lines[i][0] > indent:
                    val, i = _parse_block(lines, i, lines[i][0])
                    out_l.append(val)
                else:
                    out_l.append(None)
            elif _key_colon(item) >= 0:
                k, v = _split_key(item)
                if v is None:
                    raise ValueError(f"nested block in a list item: {item!r}")
                out_l.append({k: _parse_flow(v)})
            else:
                out_l.append(_parse_flow(item))
        return out_l, i
    out_d: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        content = lines[i][1]
        if content.startswith("- ") or content == "-":
            raise ValueError(f"list item where a key was expected: {content!r}")
        k, v = _split_key(content)
        i += 1
        if v is None:
            # nested block: deeper indent, or a list at the same indent
            if i < len(lines) and (lines[i][0] > indent or (
                    lines[i][0] == indent and lines[i][1].startswith("- "))):
                v_parsed, i = _parse_block(lines, i, lines[i][0])
            else:
                v_parsed = None
        else:
            v_parsed = _parse_flow(v)
        if k in out_d:
            # PyYAML keeps the last value of a repeated key
            del out_d[k]
        out_d[k] = v_parsed
    return out_d, i


def safe_load(text: str) -> Any:
    """`yaml.safe_load` for the subset described in the module docstring."""
    lines = _logical_lines(text)
    if not lines:
        return None
    only = lines[0][1]
    if len(lines) == 1 and _key_colon(only) < 0 and not (only.startswith("- ") or only == "-"):
        return _parse_flow(only)
    val, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return val


def load_yaml(path: str) -> Dict:
    with open(path) as f:
        return safe_load(f.read()) or {}


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_group(root: str, group: str, name: str) -> Dict:
    path = os.path.join(root, group, f"{name}.yaml")
    cfg = load_yaml(path)
    defaults = cfg.pop("defaults", [])
    merged: Dict = {}
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, cfg)
            cfg = {}
            continue
        if isinstance(entry, str):
            merged = _deep_merge(merged, _resolve_group(root, group, entry))
        elif isinstance(entry, dict):
            for g, n in entry.items():
                merged = _deep_merge(merged, _resolve_group(root, g, n))
    return _deep_merge(merged, cfg)


def set_dotted(cfg: Dict, key: str, value: Any) -> None:
    parts = key.split(".")
    d = cfg
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def compose(
    root: str,
    task: str,
    overrides: Optional[List[str]] = None,
) -> Dict:
    """task: path to a task yaml (absolute or relative to `root`)."""
    path = task if os.path.isabs(task) else os.path.join(root, task)
    if not path.endswith(".yaml"):
        path += ".yaml"
    cfg = load_yaml(path)
    defaults = cfg.pop("defaults", [])
    merged: Dict = {}
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, cfg)
            self_seen = True
            continue
        if isinstance(entry, str):
            sub = _resolve_group(root, os.path.dirname(task), entry)
            merged = _deep_merge(merged, sub)
        elif isinstance(entry, dict):
            for g, n in entry.items():
                merged.setdefault(g, {})
                merged[g] = _deep_merge(merged[g], _resolve_group(root, g, n))
    if not self_seen:
        merged = _deep_merge(merged, cfg)
    for ov in overrides or []:
        k, _, v = ov.partition("=")
        set_dotted(merged, k, safe_load(v))
    return merged


def parse_cli(argv: List[str]) -> List[str]:
    """Filter `key=value` override tokens from argv (hydra CLI parity)."""
    return [a for a in argv if "=" in a and not a.startswith("-")]
