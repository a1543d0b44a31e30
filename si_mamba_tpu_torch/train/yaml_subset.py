"""A reader and a writer for the YAML the repository's configs are written in,
so that the port needs no pyyaml.

The reader takes:

- block mappings and block sequences (also a sequence at its mapping key's
  indentation, as ``yaml.safe_dump`` writes it), comments, blank lines;
- flow mappings and flow sequences, nested in each other, over one or more
  lines (``{_base_: cfgs/x.yaml, others: {subset: 'train', npoints: 1024}}``);
- plain scalars, also over several lines, and single- and double-quoted ones.

A plain scalar's type follows PyYAML's YAML 1.1 resolver exactly: ``True``,
``FALSE``, ``yes``, ``off`` are booleans; ``0.`` and ``100.`` floats;
``1e-4`` (an exponent without a dot) a string; ``~``, ``null`` and an empty
value None; ``0x1f``, ``017`` (octal) and ``1:30`` (base 60) integers. What
lies outside the subset (anchors, aliases, tags, block scalars ``|`` ``>``,
complex keys, merge keys, dates) raises :class:`YAMLSubsetError` instead of
being read another way than ``yaml.safe_load`` reads it.

The writer emits block mappings with flow sequences, and quotes every string
that would otherwise read back as another type, so that both this reader and
``yaml.safe_load`` read its output back to the same data.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_OUTSIDE = re.compile(r"""^(?:<<|=
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLSubsetError(ValueError):
    """The text is not YAML, or uses YAML outside the subset this reader takes."""


def _sexagesimal(text: str, cast) -> Any:
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar under PyYAML's YAML 1.1 rules."""
    if _BOOL.match(text):
        return text in _TRUE
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _NULL.match(text):
        return None
    if _OUTSIDE.match(text):
        raise YAMLSubsetError(f"{text!r}: merge keys, '=' and dates are outside the YAML subset")
    return text


def _fold(raw: str) -> str:
    """Fold the line breaks of a multi-line scalar: one break between two
    lines is a space, each empty line between them a newline."""
    lines = [ln.strip(" \t") for ln in raw.split("\n")]
    out, blanks = lines[0], 0
    for ln in lines[1:]:
        if not ln:
            blanks += 1
            continue
        out += ("\n" * blanks if blanks else " ") + ln
        blanks = 0
    return out + "\n" * blanks


def _unescape(text: str) -> str:
    out, i = [], 0
    while i < len(text):
        c = text[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        esc = text[i + 1:i + 2]
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            digits = text[i + 2:i + 2 + n]
            if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                raise YAMLSubsetError(f"bad escape \\{esc}{digits}")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise YAMLSubsetError(f"unknown escape \\{esc}")
    return "".join(out)


def _quoted(s: str, i: int) -> tuple[str, int]:
    """The quoted scalar that starts at s[i] -> (value, index after it). Line
    breaks in ``s`` (a scalar over several lines) fold as in YAML; in a
    double-quoted scalar an escaped line break joins the lines."""
    q, j = s[i], i + 1
    while True:
        if j >= len(s):
            raise YAMLSubsetError(f"unterminated {q}-quoted scalar")
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if s[j] == q:
            if q == "'" and s.startswith("''", j):
                j += 2
                continue
            break
        j += 1
    raw = s[i + 1:j]
    if q == "'":
        return (_fold(raw) if "\n" in raw else raw).replace("''", "'"), j + 1
    pieces = re.split(r"\\\n[ \t]*", raw)  # escaped line breaks
    return "".join(_unescape(_fold(p) if "\n" in p else p) for p in pieces), j + 1


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at the line's start or after a
    blank, outside quoted scalars."""
    quote, prev = None, ""  # prev: the last non-blank character outside quotes
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line.startswith("''", i):
                    i += 2
                    continue
                quote, prev = None, c
        elif quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                quote, prev = None, c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        elif c in "'\"" and (i == 0 or line[i - 1] in "[{," or
                             (line[i - 1] in " \t" and prev in ("", ":", "-", "[", "{", ","))):
            quote = c
        elif c not in " \t":
            prev = c
        i += 1
    return line


class _Flow:
    """A flow node (``{...}``, ``[...]`` or a scalar) in one string."""

    def __init__(self, s: str):
        self.s, self.i = s, 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def _peek(self) -> str:
        self._ws()
        if self.i >= len(self.s):
            raise YAMLSubsetError(f"unterminated flow collection: {self.s!r}")
        return self.s[self.i]

    def parse(self) -> Any:
        value = self.node()
        self._ws()
        if self.i != len(self.s):
            raise YAMLSubsetError(f"unexpected {self.s[self.i:]!r} after a flow node")
        return value

    def node(self) -> Any:
        c = self._peek()
        if c == "{":
            return self._mapping()
        if c == "[":
            return self._sequence()
        if c in "'\"":
            value, self.i = _quoted(self.s, self.i)
            return value
        if c in "&*!|>%@`?":
            raise YAMLSubsetError(f"{c!r} (anchor, alias, tag, block scalar or complex key) "
                                  f"is outside the YAML subset")
        return resolve_plain(self._plain())

    def _plain(self) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",[]{}":
                break
            if c == ":" and (self.i + 1 == len(self.s) or self.s[self.i + 1] in " \t\n,[]{}"):
                break
            self.i += 1
        return " ".join(self.s[start:self.i].split())

    def _is_colon(self) -> bool:
        return (self._peek() == ":" and (self.i + 1 == len(self.s)
                                         or self.s[self.i + 1] in " \t\n,[]{}"))

    def _mapping(self) -> dict:
        self.i += 1
        out = {}
        while self._peek() != "}":
            if self._peek() == ",":
                raise YAMLSubsetError(f"empty entry in a flow mapping: {self.s!r}")
            key = self.node()
            value = None
            if self._is_colon():
                self.i += 1
                if self._peek() not in ",}":
                    value = self.node()
            out[_hashable(key)] = value
            if self._peek() == ",":
                self.i += 1
            elif self._peek() != "}":
                raise YAMLSubsetError(f"expected ',' or '}}' in {self.s!r}")
        self.i += 1
        return out

    def _sequence(self) -> list:
        self.i += 1
        out = []
        while self._peek() != "]":
            if self._peek() == ",":
                raise YAMLSubsetError(f"empty entry in a flow sequence: {self.s!r}")
            item = self.node()
            if self._is_colon():  # a single-pair mapping
                self.i += 1
                item = {_hashable(item): None if self._peek() in ",]" else self.node()}
            out.append(item)
            if self._peek() == ",":
                self.i += 1
            elif self._peek() != "]":
                raise YAMLSubsetError(f"expected ',' or ']' in {self.s!r}")
        self.i += 1
        return out


def _hashable(key: Any) -> Any:
    if isinstance(key, (dict, list)):
        raise YAMLSubsetError("complex (collection) keys are outside the YAML subset")
    return key


def _flow_closed(s: str) -> bool:
    """Whether the flow collection that starts ``s`` ends in it."""
    depth, i = 0, 0
    while i < len(s):
        c = s[i]
        if c in "'\"":
            try:
                _, i = _quoted(s, i)
            except YAMLSubsetError:
                return False
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
            if depth == 0:
                return True
        i += 1
    return False


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Block:
    """The block structure: lines as (indentation, text without comment)."""

    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        self.lines: list[tuple[int, str]] = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise YAMLSubsetError(f"line {n}: a tab in the indentation")
            if not self.lines and stripped == "---":
                continue  # the document start
            if stripped.startswith("%") and not body.startswith(" "):
                raise YAMLSubsetError(f"line {n}: directives are outside the YAML subset")
            if stripped in ("---", "...") and not body.startswith(" "):
                raise YAMLSubsetError(f"line {n}: one document only")
            self.lines.append((len(body) - len(stripped), stripped))
        self.i = 0

    def _peek(self) -> tuple[int, str] | None:
        while self.i < len(self.lines) and not self.lines[self.i][1]:
            self.i += 1
        return self.lines[self.i] if self.i < len(self.lines) else None

    def document(self) -> Any:
        line = self._peek()
        if line is None:
            return None
        value = self._node(line[0])
        rest = self._peek()
        if rest is not None:
            raise YAMLSubsetError(f"unexpected {rest[1]!r} at indentation {rest[0]}")
        return value

    def _node(self, indent: int) -> Any:
        text = self._peek()[1]
        if _is_item(text):
            return self._sequence(indent)
        if _key_split(text) is not None:
            return self._mapping(indent)
        self.i += 1
        return self._inline(text, indent - 1)

    def _mapping(self, indent: int) -> dict:
        out = {}
        while (line := self._peek()) is not None and line[0] >= indent:
            if line[0] > indent:
                raise YAMLSubsetError(f"bad indentation of {line[1]!r}")
            split = _key_split(line[1])
            if split is None:
                raise YAMLSubsetError(f"expected 'key: value', got {line[1]!r}")
            key, rest = split
            self.i += 1
            if rest:
                value = self._inline(rest, indent)
            else:
                nxt = self._peek()
                if nxt is not None and nxt[0] > indent:
                    value = self._node(nxt[0])
                elif nxt is not None and nxt[0] == indent and _is_item(nxt[1]):
                    value = self._sequence(indent)
                else:
                    value = None
            out[key] = value
        return out

    def _sequence(self, indent: int) -> list:
        out = []
        while (line := self._peek()) is not None and line[0] == indent and _is_item(line[1]):
            rest = line[1][1:].lstrip(" \t")
            if rest:  # the item starts on the dash's line: read it at its own column
                self.lines[self.i] = (indent + len(line[1]) - len(rest), rest)
                out.append(self._node(self.lines[self.i][0]))
                continue
            self.i += 1
            nxt = self._peek()
            out.append(self._node(nxt[0]) if nxt is not None and nxt[0] > indent else None)
        line = self._peek()
        if line is not None and line[0] > indent:
            raise YAMLSubsetError(f"bad indentation of {line[1]!r}")
        return out

    def _continuation(self, parent: int) -> str | None:
        """The next line that continues a node of a parent at indentation
        ``parent`` (one indented more), with the blank lines before it as
        line breaks; None if the node ends here."""
        j = self.i
        while j < len(self.lines) and not self.lines[j][1]:
            j += 1
        if j >= len(self.lines) or self.lines[j][0] <= parent:
            return None
        text = "\n" * (j - self.i) + self.lines[j][1]
        self.i = j + 1
        return text

    def _inline(self, text: str, parent: int) -> Any:
        """The node whose text starts with ``text`` on the current line and may
        continue on the lines indented more than ``parent``."""
        c = text[0]
        if c in "&*!|>%@`?":
            raise YAMLSubsetError(f"{c!r} (anchor, alias, tag, block scalar or complex key) "
                                  f"is outside the YAML subset")
        if _is_item(text):
            raise YAMLSubsetError(f"a sequence entry is not allowed here: {text!r}")
        while True:
            if c in "[{" and _flow_closed(text):
                return _Flow(text).parse()
            if c in "'\"":
                try:
                    value, end = _quoted(text, 0)
                except YAMLSubsetError:
                    pass
                else:
                    if text[end:].strip():
                        raise YAMLSubsetError(f"unexpected {text[end:]!r} after a quoted scalar")
                    return value
            more = self._continuation(parent)
            if more is None:
                break
            text += "\n" + more
        if c in "[{'\"":
            raise YAMLSubsetError(f"unterminated node {text!r}")
        if any(ln.endswith(":") or ": " in ln or ":\t" in ln for ln in text.split("\n")):
            raise YAMLSubsetError(f"mapping values are not allowed in {text!r}")
        return resolve_plain(_fold(text) if "\n" in text else text)


def _key_split(text: str) -> tuple[Any, str] | None:
    """(key, rest) for a 'key: rest' or 'key:' line, else None."""
    if _is_item(text) or text[0] in "[{":
        return None
    if text[0] in "'\"":
        try:
            key, end = _quoted(text, 0)
        except YAMLSubsetError:
            return None
        rest = text[end:].lstrip(" \t")
        if rest == ":" or rest.startswith((": ", ":\t")):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    key = text[:m.start()].rstrip()
    if not key:
        raise YAMLSubsetError(f"empty key in {text!r}")
    if key[0] in "&*!|>%@`?":
        raise YAMLSubsetError(f"{key!r}: anchors, aliases, tags and complex keys are outside "
                              f"the YAML subset")
    return resolve_plain(key), text[m.end():].strip()


def load(text: str) -> Any:
    """Parse one YAML document of the subset -> dicts, lists, str, int,
    float, bool, None (what ``yaml.safe_load`` gives for it)."""
    return _Block(text).document()


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./+-]*")


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
        if "." not in r:  # YAML 1.1 reads an exponent without a dot as a string
            r = r.replace("e", ".0e") if "e" in r else r + ".0"
        return r
    if isinstance(v, str):
        if _PLAIN_SAFE.fullmatch(v) and resolve_plain(v) == v:
            return v
        return json.dumps(v, ensure_ascii=False)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def _emit(d: dict, indent: int, out: list[str]) -> None:
    pad = " " * indent
    for k, v in d.items():
        key = _scalar(k)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{key}:")
            _emit(v, indent + 2, out)
        else:
            out.append(f"{pad}{key}: {_flow(v)}")


def dump(data: Any) -> str:
    """``data`` (dicts, lists, tuples, str, int, float, bool, None) as YAML:
    non-empty mappings in block style, everything else in flow style."""
    if isinstance(data, dict) and data:
        out: list[str] = []
        _emit(data, 0, out)
        return "\n".join(out) + "\n"
    return _flow(data) + "\n"
