"""A reader for the YAML subset the config tree is written in, without PyYAML.

It gives the values the JAX package's loader gives (PyYAML's ``SafeLoader``
with YAML 1.2 float resolution added, ``sheeprl_tpu/config/loader.py``):

- plain scalars resolve by PyYAML's YAML 1.1 rules, in PyYAML's order:
  booleans (``True``, ``false``, ``yes``, ``off``, ...), floats with a dot
  (``2.5e-4``, ``.inf``), integers (``10_000_000``, ``0x1f``, ``017`` octal,
  ``1:30`` sexagesimal), nulls (``null``, ``~``, nothing), then the YAML 1.2
  float rule, which makes ``1e-4`` a float where YAML 1.1 keeps a string.
  Anything else (``???``, ``${algo.dense_units}``, ``32-true``) is a string;
- single- and double-quoted strings are strings;
- block mappings and block sequences (also a sequence at its key's indent),
  ``- key: value`` items, flow sequences (``[state]``, ``[]``) and flow
  mappings (``{}``) on one line, comments after values and on lines of their
  own (the ``# @package`` header is one: :func:`package_header` reads it).

What lies outside the subset raises :class:`UnsupportedYaml` with the file
and line: anchors and aliases, tags, block scalars (``|``, ``>``), document
markers and directives, complex keys, the merge key, timestamps, and scalars
or flow collections that run over several lines. Text that is not YAML
raises :class:`YamlSyntaxError`. Nothing is read some other way.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)\s*$", re.MULTILINE)

# PyYAML's implicit resolvers, each with the first characters it is tried
# for, in the order PyYAML tries them; the JAX loader's YAML 1.2 float rule
# comes last.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT11 = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_VALUE = re.compile(r"^(?:=)$")
_FLOAT12 = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_RESOLVERS = (
    ("bool", _BOOL, "yYnNtTfFoO"),
    ("float", _FLOAT11, "-+0123456789."),
    ("int", _INT, "-+0123456789"),
    ("merge", _MERGE, "<"),
    ("null", _NULL, "~nN"),
    ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", _VALUE, "="),
    ("float", _FLOAT12, "-+0123456789."),
)
_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
    " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " ",
}  # fmt: skip
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"


class YamlError(ValueError):
    """Text the reader cannot read, with the file and line it is on."""

    def __init__(self, message: str, path: str = "<string>", line: Optional[int] = None):
        where = f"{path}:{line}" if line is not None else path
        super().__init__(f"{where}: {message}")
        self.path, self.line = path, line


class YamlSyntaxError(YamlError):
    """The text is not YAML."""


class UnsupportedYaml(YamlError):
    """YAML outside the subset the config tree uses."""


def package_header(text: str) -> Optional[str]:
    """The package a ``# @package <pkg>`` comment names, or None."""
    match = _PACKAGE_RE.search(text)
    return match.group(1) if match else None


def _sexagesimal(value: str) -> float:
    total, base = 0.0, 1
    for part in reversed(value.split(":")):
        total += float(part) * base
        base *= 60
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * int(_sexagesimal(value))
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value)
    return sign * float(value)


def resolve_plain(value: str, path: str = "<string>", line: Optional[int] = None) -> Any:
    """A plain (unquoted) scalar as PyYAML's SafeLoader with the YAML 1.2
    float rule resolves it."""
    first = value[0] if value else ""
    for kind, regex, chars in _RESOLVERS:
        if (first in chars if first else kind == "null") and regex.match(value):
            if kind == "bool":
                return value.lower() in ("yes", "true", "on")
            if kind == "float":
                return _to_float(value)
            if kind == "int":
                return _to_int(value)
            if kind == "null":
                return None
            raise UnsupportedYaml(f"{value!r} resolves to a YAML {kind}, which the config reader does not read", path, line)
    return value


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


class _Reader:
    def __init__(self, text: str, path: str):
        self.path = path
        self.lines: List[_Line] = []
        for number, raw in enumerate(text.splitlines(), start=1):
            body = self._strip_comment(raw).rstrip()
            stripped = body.lstrip(" ")
            if not stripped:
                continue
            if stripped.startswith("\t") or body[: len(body) - len(stripped)].count("\t"):
                raise YamlSyntaxError("tabs are not allowed in indentation", path, number)
            if stripped.startswith(("---", "...")) and (len(stripped) == 3 or stripped[3] in " \t"):
                raise UnsupportedYaml("document markers are not read", path, number)
            if stripped.startswith("%"):
                raise UnsupportedYaml("directives are not read", path, number)
            self.lines.append(_Line(number, len(body) - len(stripped), stripped))

    # ------------------------------------------------------------- lexing
    def _strip_comment(self, raw: str) -> str:
        """``raw`` without its comment: a ``#`` at the start or after
        whitespace, outside quotes."""
        quote = None
        i = 0
        while i < len(raw):
            ch = raw[i]
            if quote == "'":
                if ch == "'":
                    if i + 1 < len(raw) and raw[i + 1] == "'":
                        i += 1
                    else:
                        quote = None
            elif quote == '"':
                if ch == "\\":
                    i += 1
                elif ch == '"':
                    quote = None
            elif ch in "'\"" and self._may_open_quote(raw, i):
                quote = ch
            elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
                return raw[:i]
            i += 1
        return raw

    @staticmethod
    def _may_open_quote(raw: str, i: int) -> bool:
        """A quote opens a quoted scalar only where a scalar starts: after
        indentation, ``- ``, ``: ``, ``[``, ``{`` or ``,``."""
        j = i - 1
        while j >= 0 and raw[j] == " ":
            j -= 1
        if j < 0:
            return True
        return raw[j] in "[{,:-" and (raw[j] not in ":-" or j + 1 < i)

    def error(self, cls, message: str, line: _Line):
        return cls(message, self.path, line.number)

    # ------------------------------------------------------------ parsing
    def parse(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        node, i = self._block(0, first.indent)
        if i < len(self.lines):
            raise self.error(YamlSyntaxError, "unexpected content after the document", self.lines[i])
        return node

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def _block(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if self._is_item(line.text):
            return self._sequence(i, indent)
        if self._mapping_colon(line.text, line) is None:
            value = self._inline(line.text, line)
            if i + 1 < len(self.lines) and self.lines[i + 1].indent >= indent:
                raise self.error(UnsupportedYaml, "plain scalars over several lines are not read", self.lines[i + 1])
            return value, i + 1
        return self._mapping(i, indent)

    def _sequence(self, i: int, indent: int) -> Tuple[List[Any], int]:
        items: List[Any] = []
        while i < len(self.lines) and self.lines[i].indent == indent and self._is_item(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:]
            body = rest.lstrip(" ")
            if not body:
                nxt = self.lines[i + 1] if i + 1 < len(self.lines) else None
                if nxt is not None and nxt.indent > indent:
                    value, i = self._block(i + 1, nxt.indent)
                else:
                    value, i = None, i + 1
            else:
                # The item's content starts a block of its own, at the column
                # it starts in ("- key: value" then "  key2: value2").
                column = indent + 1 + (len(rest) - len(body))
                self.lines[i] = _Line(line.number, column, body)
                value, i = self._block(i, column)
            items.append(value)
            if i < len(self.lines) and self.lines[i].indent > indent:
                raise self.error(YamlSyntaxError, "bad indentation in a sequence", self.lines[i])
        return items, i

    def _mapping(self, i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if self._is_item(line.text):
                raise self.error(YamlSyntaxError, "a sequence item where a mapping key was expected", line)
            colon = self._mapping_colon(line.text, line)
            if colon is None:
                raise self.error(UnsupportedYaml, "expected 'key: value' (plain scalars over several lines are not read)", line)
            key = self._key(line.text[:colon].rstrip(), line)
            rest = line.text[colon + 1 :].strip()
            i += 1
            if rest:
                value = self._inline(rest, line)
                if i < len(self.lines) and self.lines[i].indent > indent:
                    raise self.error(UnsupportedYaml, "a value over several lines is not read", self.lines[i])
            elif i < len(self.lines) and self.lines[i].indent > indent:
                value, i = self._block(i, self.lines[i].indent)
            elif i < len(self.lines) and self.lines[i].indent == indent and self._is_item(self.lines[i].text):
                value, i = self._sequence(i, indent)
            else:
                value = None
            out[key] = value
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise self.error(YamlSyntaxError, "bad indentation in a mapping", self.lines[i])
        return out, i

    def _mapping_colon(self, text: str, line: _Line) -> Optional[int]:
        """Index of the ``:`` that ends a block mapping key, or None."""
        if text[0] == "?" and (len(text) == 1 or text[1] == " "):
            raise self.error(UnsupportedYaml, "complex mapping keys are not read", line)
        if text[0] in "[{":
            return None
        if text[0] in "'\"":
            end = self._quoted_end(text, 0, line)
            rest = text[end:].lstrip(" ")
            if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
                return len(text) - len(rest)
            return None
        for j, ch in enumerate(text):
            if ch == ":" and (j + 1 == len(text) or text[j + 1] == " "):
                return j
        return None

    def _key(self, text: str, line: _Line) -> Any:
        if not text:
            raise self.error(UnsupportedYaml, "empty mapping keys are not read", line)
        value = self._inline(text, line)
        if isinstance(value, (list, dict)):
            raise self.error(UnsupportedYaml, "collection keys are not read", line)
        return value

    # ------------------------------------------------------------ scalars
    def _inline(self, text: str, line: _Line) -> Any:
        """A value on one line: a flow collection, a quoted or a plain scalar."""
        ch = text[0]
        if ch in "[{":
            value, end = self._flow(text, 0, line)
            if text[end:].strip():
                raise self.error(YamlSyntaxError, f"unexpected {text[end:].strip()!r} after a flow collection", line)
            return value
        if ch in "'\"":
            end = self._quoted_end(text, 0, line)
            if text[end:].strip():
                raise self.error(YamlSyntaxError, f"unexpected {text[end:].strip()!r} after a quoted scalar", line)
            return self._unquote(text[:end], line)
        self._check_plain_start(text, line)
        if ": " in text or text.endswith(":"):
            raise self.error(YamlSyntaxError, "mapping values are not allowed here", line)
        return resolve_plain(text, self.path, line.number)

    def _check_plain_start(self, text: str, line: _Line) -> None:
        ch = text[0]
        if ch in "&*":
            raise self.error(UnsupportedYaml, "anchors and aliases are not read", line)
        if ch == "!":
            raise self.error(UnsupportedYaml, "tags are not read", line)
        if ch in "|>":
            raise self.error(UnsupportedYaml, "block scalars are not read", line)
        if ch in ",]}%@`" or (ch in "-?:" and len(text) > 1 and text[1] == " "):
            raise self.error(YamlSyntaxError, f"a plain scalar cannot start with {ch!r}", line)

    def _quoted_end(self, text: str, start: int, line: _Line) -> int:
        """Index just past the quoted scalar that starts at ``start``."""
        quote = text[start]
        j = start + 1
        while j < len(text):
            ch = text[j]
            if quote == '"' and ch == "\\":
                j += 2
                continue
            if ch == quote:
                if quote == "'" and j + 1 < len(text) and text[j + 1] == "'":
                    j += 2
                    continue
                return j + 1
            j += 1
        raise self._unterminated("quoted scalars", line)

    def _unquote(self, token: str, line: _Line) -> str:
        body = token[1:-1]
        if token[0] == "'":
            return body.replace("''", "'")
        out: List[str] = []
        j = 0
        while j < len(body):
            ch = body[j]
            if ch != "\\":
                out.append(ch)
                j += 1
                continue
            code = body[j + 1] if j + 1 < len(body) else ""
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                j += 2
            elif code in _HEX_ESCAPES:
                width = _HEX_ESCAPES[code]
                digits = body[j + 2 : j + 2 + width]
                if len(digits) != width or any(c not in "0123456789abcdefABCDEF" for c in digits):
                    raise self.error(YamlSyntaxError, f"bad escape \\{code}{digits}", line)
                out.append(chr(int(digits, 16)))
                j += 2 + width
            else:
                raise self.error(YamlSyntaxError, f"unknown escape \\{code}", line)
        return "".join(out)

    # --------------------------------------------------------------- flow
    def _flow(self, text: str, i: int, line: _Line) -> Tuple[Any, int]:
        """The flow collection starting at ``text[i]``; returns it and the
        index past its closing bracket."""
        opening = text[i]
        closing = "]" if opening == "[" else "}"
        items: List[Any] = []
        mapping: Dict[Any, Any] = {}
        i += 1
        while True:
            i = self._skip_spaces(text, i, line)
            if text[i] == closing:
                return (items if opening == "[" else mapping), i + 1
            key, i = self._flow_node(text, i, line)
            i = self._skip_spaces(text, i, line)
            if opening == "{":
                value = None
                if text[i] == ":":
                    i = self._skip_spaces(text, i + 1, line)
                    if text[i] in ",}":
                        value = None
                    else:
                        value, i = self._flow_node(text, i, line)
                        i = self._skip_spaces(text, i, line)
                if isinstance(key, (list, dict)):
                    raise self.error(UnsupportedYaml, "collection keys are not read", line)
                mapping[key] = value
            else:
                if text[i] == ":":
                    raise self.error(UnsupportedYaml, "single-pair mappings inside flow sequences are not read", line)
                items.append(key)
            if text[i] == ",":
                i += 1
            elif text[i] != closing:
                raise self.error(YamlSyntaxError, f"expected ',' or {closing!r} in a flow collection, got {text[i]!r}", line)

    def _skip_spaces(self, text: str, i: int, line: _Line) -> int:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise self._unterminated("flow collections", line)
        return i

    def _unterminated(self, what: str, line: _Line) -> YamlError:
        """A collection or quote left open: on the last line it is not YAML,
        before another line it would go on there, which is not read."""
        if line is self.lines[-1]:
            return self.error(YamlSyntaxError, f"unterminated {what[:-1]}", line)
        return self.error(UnsupportedYaml, f"{what} over several lines are not read", line)

    def _flow_node(self, text: str, i: int, line: _Line) -> Tuple[Any, int]:
        ch = text[i]
        if ch in "[{":
            return self._flow(text, i, line)
        if ch in "'\"":
            end = self._quoted_end(text, i, line)
            return self._unquote(text[i:end], line), end
        j = i
        while j < len(text):
            c = text[j]
            if c in _FLOW_END or (c == ":" and (j + 1 == len(text) or text[j + 1] in " ,[]{}")):
                break
            j += 1
        token = text[i:j].rstrip(" ")
        if not token:
            raise self.error(YamlSyntaxError, f"unexpected {ch!r} in a flow collection", line)
        self._check_plain_start(token, line)
        return resolve_plain(token, self.path, line.number), j


def load(text: str, path: str = "<string>") -> Any:
    """The value of one YAML document in the config tree's subset."""
    return _Reader(text, path).parse()


def load_file(path: str) -> Tuple[Any, Optional[str]]:
    """(value, ``# @package`` header or None) of a YAML file."""
    with open(path) as fp:
        text = fp.read()
    return load(text, path), package_header(text)
