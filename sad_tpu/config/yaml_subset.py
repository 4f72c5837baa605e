"""Reader and writer for the subset of YAML that Detectron configs use.

Supported: nested block mappings, block sequences (``- item``, and the
compact ``- - item`` / ``- KEY: value`` forms PyYAML's dumper writes), inline
lists (``[0, 180000, 240000]``, nested), ``{}``/``[]``, plain scalars
resolved as YAML 1.1 does (``True``/``false``/``yes``, ints, floats with a
dot, ``null``/``~``, else strings — so ``(600,)`` stays the string the
config coercion parses), single- and double-quoted strings, ``#`` comments,
plain values continued on deeper-indented lines, and anchors with aliases
(``&id001`` / ``*id001``, as PyYAML's dumper writes shared values). Tags,
block scalars (``|``/``>``) and flow mappings with content are not
supported and raise ``ValueError``.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

_BOOL = {
    "true": True, "yes": True, "on": True,
    "false": False, "no": False, "off": False,
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


def _resolve_plain(s: str) -> Any:
    if s in _NULL:
        return None
    if s in ("True", "TRUE", "False", "FALSE", "Yes", "YES", "No", "NO",
             "On", "ON", "Off", "OFF") or s in _BOOL:
        return _BOOL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return -math.inf if s.startswith("-") else math.inf
    if _NAN.match(s):
        return math.nan
    return s


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:{-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Parser for one inline value: a quoted or plain scalar, or a
    (nested) ``[...]`` list. `anchors` maps the document's anchor names to
    their values."""

    def __init__(self, text: str, anchors: Optional[dict] = None):
        self.s = text
        self.i = 0
        self.anchors = {} if anchors is None else anchors

    def _name(self) -> str:
        """The anchor or alias name after the '&' or '*' at self.i."""
        j = self.i + 1
        while j < len(self.s) and self.s[j] not in " \t,[]{}":
            j += 1
        name, self.i = self.s[self.i + 1:j], j
        if not name:
            raise ValueError(f"empty anchor or alias name in {self.s!r}")
        return name

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_list: bool = False) -> Any:
        self._ws()
        s = self.s
        if self.i >= len(s):
            return None
        ch = s[self.i]
        if ch == "&":
            name = self._name()
            self.anchors[name] = self.value(in_list)
            return self.anchors[name]
        if ch == "*":
            name = self._name()
            if name not in self.anchors:
                raise ValueError(f"undefined alias *{name} in {s!r}")
            return self.anchors[name]
        if ch == "[":
            self.i += 1
            items: List[Any] = []
            self._ws()
            if self.i < len(s) and s[self.i] == "]":
                self.i += 1
                return items
            while True:
                items.append(self.value(in_list=True))
                self._ws()
                if self.i >= len(s):
                    raise ValueError(f"unclosed '[' in {s!r}")
                if s[self.i] == ",":
                    self.i += 1
                    continue
                if s[self.i] == "]":
                    self.i += 1
                    return items
                raise ValueError(f"unexpected {s[self.i]!r} in {s!r}")
        if ch == "{":
            end = s.index("}", self.i)
            if s[self.i + 1:end].strip():
                raise ValueError(f"flow mappings are not supported: {s!r}")
            self.i = end + 1
            return {}
        if ch == "'":
            out = []
            self.i += 1
            while True:
                j = s.index("'", self.i)
                out.append(s[self.i:j])
                if j + 1 < len(s) and s[j + 1] == "'":
                    out.append("'")
                    self.i = j + 2
                    continue
                self.i = j + 1
                return "".join(out)
        if ch == '"':
            j = self.i + 1
            out = []
            while s[j] != '"':
                if s[j] == "\\":
                    j += 1
                    out.append({"n": "\n", "t": "\t"}.get(s[j], s[j]))
                else:
                    out.append(s[j])
                j += 1
            self.i = j + 1
            return "".join(out)
        if ch in "!|>%@`":
            raise ValueError(f"unsupported YAML syntax: {s!r}")
        stop = ",]" if in_list else ""
        j = self.i
        while j < len(s) and s[j] not in stop:
            j += 1
        text = s[self.i:j].strip()
        self.i = j
        return _resolve_plain(text)

    def parse(self) -> Any:
        v = self.value()
        self._ws()
        if self.i != len(self.s):
            raise ValueError(f"trailing text in {self.s!r}")
        return v


_MAP_ENTRY = re.compile(r"^([^:#\[\]{},'\"]+?):(?:\s+|$)(.*)$")


def _split_key(content: str) -> Tuple[str, str]:
    """'KEY: rest' -> (KEY, rest); the key may be quoted."""
    if content[0] in "'\"":
        f = _Flow(content)
        key = f.value()
        rest = content[f.i:]
        if not rest.startswith(":"):
            raise ValueError(f"expected ':' after key in {content!r}")
        return key, rest[1:].strip()
    m = _MAP_ENTRY.match(content)
    if not m:
        raise ValueError(f"not a 'key: value' line: {content!r}")
    return m.group(1).strip(), m.group(2).strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _split_anchor(rest: str) -> Tuple[Optional[str], str]:
    """'&name value' -> (name, value); anything else -> (None, rest)."""
    if not rest.startswith("&"):
        return None, rest
    name, _, value = rest[1:].partition(" ")
    return name, value.strip()


def loads(text: str) -> Any:
    """Parse a YAML document of the supported subset."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        body = _strip_comment(raw.replace("\t", "    ")).rstrip()
        if body.strip():
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    anchors: dict = {}

    def inline(pos: int, indent: int, first: str) -> Tuple[Any, int]:
        parts = [first]
        while pos < len(lines) and lines[pos][0] > indent:
            parts.append(lines[pos][1])
            pos += 1
        return _Flow(" ".join(parts), anchors).parse(), pos

    def nested(pos: int, indent: int, rest: str, in_map: bool) -> Tuple[Any, int]:
        """The value after a key or a '-': inline, a deeper block, or
        null; an anchor in front of a block value names that block."""
        anchor, bare = _split_anchor(rest)
        if bare:
            return inline(pos, indent, rest)
        if pos < len(lines) and (
            lines[pos][0] > indent
            or (in_map and lines[pos][0] == indent and _is_item(lines[pos][1]))
        ):
            value, pos = block(pos, lines[pos][0])
        else:
            value = None
        if anchor:
            anchors[anchor] = value
        return value, pos

    def block(pos: int, indent: int) -> Tuple[Any, int]:
        if _is_item(lines[pos][1]):
            items = []
            while pos < len(lines) and lines[pos][0] == indent and _is_item(
                lines[pos][1]
            ):
                content = lines[pos][1]
                rest = content[1:].strip()
                if _is_item(rest) or _MAP_ENTRY.match(rest):
                    # compact form ("- - a", "- KEY: v"): the rest opens a
                    # block at its own column
                    column = indent + len(content) - len(rest)
                    lines[pos] = (column, rest)
                    value, pos = block(pos, column)
                else:
                    value, pos = nested(pos + 1, indent, rest, in_map=False)
                items.append(value)
            return items, pos
        out = {}
        while pos < len(lines) and lines[pos][0] == indent:
            if _is_item(lines[pos][1]):
                raise ValueError(f"sequence item in a mapping: {lines[pos][1]!r}")
            key, rest = _split_key(lines[pos][1])
            out[key], pos = nested(pos + 1, indent, rest, in_map=True)
        return out, pos

    indent, first = lines[0]
    if _is_item(first) or _MAP_ENTRY.match(first) or first[0] in "'\"":
        value, pos = block(0, indent)
    else:  # the document is one inline value
        value, pos = inline(1, indent - 1, first)
    if pos != len(lines):
        raise ValueError(f"bad indentation at {lines[pos][1]!r}")
    return value


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:
            r = r.replace("e", ".0e")
        elif "e" not in r and "." not in r:
            r += ".0"
        return r
    if isinstance(v, str):
        if re.match(r"^[A-Za-z_/][A-Za-z0-9_./+-]*$", v) and _resolve_plain(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dumps(obj: dict) -> str:
    """Write a nested dict as block mappings (keys sorted) with inline
    lists; ``loads`` (and any YAML reader) gives the same value back."""
    out: List[str] = []

    def emit(d: dict, indent: int):
        for key in sorted(d):
            v = d[key]
            pad = " " * indent
            if isinstance(v, dict) and v:
                out.append(f"{pad}{_scalar(str(key))}:")
                emit(v, indent + 2)
            elif isinstance(v, dict):
                out.append(f"{pad}{_scalar(str(key))}: {{}}")
            else:
                out.append(f"{pad}{_scalar(str(key))}: {_scalar(v)}")

    emit(obj, 0)
    return "\n".join(out) + "\n"
