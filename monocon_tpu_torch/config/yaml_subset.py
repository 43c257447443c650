"""The YAML of the port's config files, read and written without PyYAML.

The card's machine has no PyYAML, so the port reads and writes its config
files itself. :func:`safe_load` gives what ``yaml.safe_load`` gives on the
subset that the files in ``configs/`` and :func:`dump` use:

  * block mappings nested by indentation (spaces); a key with nothing after
    its colon holds the mapping indented below it, or else null;
  * block sequences of scalars as a key's value: ``- item`` lines at the
    key's indentation (as ``yaml.safe_dump`` writes them) or deeper, all
    at one indentation;
  * ``#`` comments, on their own line or after a value;
  * flow sequences ``[...]`` closed on their line, nested, and the empty
    flow mapping ``{}``;
  * plain, single-quoted and double-quoted scalars on one line.

Plain scalars, keys included, resolve as PyYAML's ``SafeLoader`` resolves
them (YAML 1.1): ``yes/no/on/off/true/false`` in three cases are booleans;
``null``, ``~`` and nothing are None; a float needs a dot in its mantissa
and a sign in its exponent (``4.5e-4`` is a float, ``1e-5`` a string);
integers take ``0b``, ``0x``, a leading ``0`` for octal, ``_`` and base-60
``1:30``. Anything else raises :class:`YAMLSubsetError` with the line
number: block sequences anywhere else or of mappings or sequences, empty
sequence items, non-empty flow mappings, anchors, aliases, tags, block
scalars, directives and document markers, scalars over several lines,
tabs, duplicate keys, timestamps and merge keys.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Tuple

__all__ = ["YAMLSubsetError", "dump", "safe_load"]


class YAMLSubsetError(ValueError):
    """A construct outside the subset, or text that is not YAML."""


# YAML 1.1 implicit types, as PyYAML's resolver matches plain scalars.
_BOOL = re.compile(r"(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)\Z")
_NULL = re.compile(r"(?:~|null|Null|NULL|)\Z")
_FLOAT = re.compile(r"""(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))\Z""", re.X)
_INT = re.compile(r"""(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)\Z""", re.X)
_TIMESTAMP = re.compile(r"""(?:[0-9]{4}-[0-9]{2}-[0-9]{2}
                        |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}
                        (?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}
                        (?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)\Z""",
                        re.X)
# Characters a YAML stream may not hold (PyYAML's reader refuses them).
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\U0000D7FF\U0000E000-\U0000FFFD"
    "\U00010000-\U0010FFFF]")
_LINE_BREAK = re.compile("\r\n|[\r\n\x85\U00002028\U00002029]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ",
            '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": "\U00002028", "P": "\U00002029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# A plain scalar may not start with these (nor with "-", "?" or ":" and
# then a space).
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_FLOW_STOPS = set(",[]{}?")


def _sexagesimal(text: str, number) -> Any:
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += number(part) * base
        base *= 60
    return value


def _resolve(text: str, lineno: int) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader constructs it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise YAMLSubsetError(f"line {lineno}: {text!r} is a timestamp, "
                              "merge or value key, outside the subset")
    return text


class _Line:
    """One line of the text, scanned left to right."""

    def __init__(self, text: str, lineno: int):
        self.text, self.lineno, self.pos = text, lineno, 0

    def error(self, what: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"line {self.lineno}: {what}: {self.text!r}")

    def peek(self, offset: int = 0) -> str:
        i = self.pos + offset
        return self.text[i] if i < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """Only spaces or a comment are left."""
        self.skip_spaces()
        return self.peek() in ("", "#")

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if ch == "":
                raise self.error("a quoted scalar must close on its line")
            self.pos += 1
            if ch == quote:
                if quote == "'" and self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if ch == "\\" and quote == '"':
                ch = self.peek()
                self.pos += 1
                if ch in _ESCAPES:
                    out.append(_ESCAPES[ch])
                elif ch in _HEX_ESCAPES:
                    digits = self.text[self.pos:self.pos + _HEX_ESCAPES[ch]]
                    if not re.fullmatch(r"[0-9A-Fa-f]+", digits) or len(
                            digits) != _HEX_ESCAPES[ch]:
                        raise self.error(f"bad escape \\{ch}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += len(digits)
                else:
                    raise self.error(f"escape \\{ch} is outside the subset")
            else:
                out.append(ch)

    def plain(self, flow: bool) -> str:
        """A plain scalar: to a comment or the end of the line, and in a
        flow sequence to its next indicator."""
        ch = self.peek()
        if ch in _INDICATORS and not (
                self.peek(1) not in ("", " ")
                and (ch == "-" or (not flow and ch in "?:"))):
            raise self.error(f"a value starting with {ch!r} is outside the "
                             "subset")
        start = self.pos
        while True:
            ch = self.peek()
            if ch == "" or (flow and ch in _FLOW_STOPS):
                break
            if ch == " " and self.peek(1) == "#":
                break
            if ch == ":" and (self.peek(1) in ("", " ")
                              or (flow and self.peek(1) in _FLOW_STOPS)):
                raise self.error("a mapping inside a value is outside the "
                                 "subset")
            self.pos += 1
        return self.text[start:self.pos].rstrip(" ")

    def value(self, flow: bool) -> Any:
        """A scalar, a flow sequence or ``{}``, from the current position."""
        ch = self.peek()
        if ch == "[":
            self.pos += 1
            items: List[Any] = []
            while True:
                self.skip_spaces()
                if self.peek() == "]":
                    self.pos += 1
                    return items
                if self.peek() in ("", "#"):
                    raise self.error("a flow sequence must close on its line")
                if self.peek() == ",":
                    raise self.error("an empty flow sequence entry")
                items.append(self.value(flow=True))
                self.skip_spaces()
                if self.peek() == ",":
                    self.pos += 1
                elif self.peek() != "]":
                    raise self.error("expected ',' or ']'")
        if ch == "{":
            self.pos += 1
            self.skip_spaces()
            if self.peek() != "}":
                raise self.error("flow mappings other than {} are outside "
                                 "the subset")
            self.pos += 1
            return {}
        if ch in ("'", '"'):
            return self.quoted()
        return _resolve(self.plain(flow), self.lineno)

    def key(self) -> Any:
        """A mapping key and its colon."""
        if self.peek() in ("'", '"'):
            key = self.quoted()
            self.skip_spaces()
        else:
            start = self.pos
            while not (self.peek() == ":" and self.peek(1) in ("", " ")):
                if self.peek() == "" or (self.peek() == "#" and self.pos > start
                                         and self.text[self.pos - 1] == " "):
                    raise self.error("expected 'key: value'")
                self.pos += 1
            text = self.text[start:self.pos].rstrip(" ")
            if not text or text[0] in _INDICATORS and not (
                    text[0] in "-?:" and len(text) > 1 and text[1] != " "):
                raise self.error("this key is outside the subset")
            key = _resolve(text, self.lineno)
        if self.peek() != ":" or self.peek(1) not in ("", " "):
            raise self.error("expected ': ' after the key")
        self.pos += 1
        return key


def _content_lines(text: str):
    """(line number, indentation, the line from its first non-space) of the
    lines that hold more than a comment. A ``- `` line is a block sequence
    item, which :func:`safe_load` takes only as a key's value."""
    if text.startswith("\U0000FEFF"):
        text = text[1:]
    bad = _NON_PRINTABLE.search(text)
    if bad:
        lineno = text.count("\n", 0, bad.start()) + 1
        raise YAMLSubsetError(f"line {lineno}: character "
                              f"{bad.group()!r} cannot appear in YAML")
    for lineno, raw in enumerate(_LINE_BREAK.split(text), start=1):
        if "\t" in raw:
            raise YAMLSubsetError(f"line {lineno}: tabs are outside the "
                                  "subset")
        content = raw.lstrip(" ")
        if not content or content.startswith("#"):
            continue
        marker = raw[:3] in ("---", "...") and raw[3:4] in ("", " ")
        if (marker or content[0] == "%"
                or content[0] == "?" and content[1:2] in ("", " ")):
            raise YAMLSubsetError(
                f"line {lineno}: complex keys, directives and document "
                f"markers are outside the subset: {raw!r}")
        yield lineno, len(raw) - len(content), content


def _is_item(content: str) -> bool:
    return content[0] == "-" and content[1:2] in ("", " ")


def _sequence_item(content: str, lineno: int) -> Any:
    """The scalar of a block sequence item ``- value``."""
    line = _Line(content, lineno)
    line.pos = 1
    if line.at_end():
        raise line.error("empty block sequence items are outside the subset")
    if line.peek() in ("[", "{"):
        raise line.error("block sequences of sequences or mappings are "
                         "outside the subset")
    value = line.value(flow=False)
    if not line.at_end():
        raise line.error("unexpected text after the value")
    return value


def safe_load(text: str) -> Any:
    """The mapping that ``yaml.safe_load(text)`` gives, or None for a text
    of comments and blank lines."""
    root = None
    levels: List[Tuple[int, Dict[Any, Any]]] = []   # (indent, mapping)
    open_key = None     # (indent, mapping, key) of a key with no value yet
    sequence = None     # (indent, list) of the block sequence being read
    for lineno, indent, content in _content_lines(text):
        item = _is_item(content)
        if sequence is not None:
            item_indent, items = sequence
            if indent > item_indent or (item and indent == item_indent):
                if not item or indent != item_indent:
                    raise YAMLSubsetError(
                        f"line {lineno}: a block sequence's items must be "
                        f"scalars at one indentation: {content!r}")
                items.append(_sequence_item(content, lineno))
                continue
            sequence = None
        if open_key is not None:
            parent_indent, parent, key = open_key
            open_key = None
            if item and indent >= parent_indent:
                parent[key] = [_sequence_item(content, lineno)]
                sequence = (indent, parent[key])
                continue
            if indent > parent_indent:
                parent[key] = {}
                levels.append((indent, parent[key]))
        if item:
            raise YAMLSubsetError(
                f"line {lineno}: block sequences other than a key's value "
                f"are outside the subset: {content!r}")
        if root is None:
            root = {}
            levels.append((indent, root))
        while indent < levels[-1][0]:
            levels.pop()
            if not levels:
                break
        if not levels or indent != levels[-1][0]:
            raise YAMLSubsetError(f"line {lineno}: bad indentation: "
                                  f"{content!r}")
        mapping = levels[-1][1]
        line = _Line(content, lineno)
        key = line.key()
        if key in mapping:
            raise line.error(f"duplicate key {key!r}")
        if line.at_end():
            mapping[key] = None
            open_key = (indent, mapping, key)
            continue
        mapping[key] = line.value(flow=False)
        if not line.at_end():
            raise line.error("unexpected text after the value")
    return root


# ------------------------------------------------------------------ writing
# Plain keys that read back as the same string.
_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")
_YAML_WORDS = {"y", "n", "yes", "no", "on", "off", "true", "false", "null"}


def _quoted(text: str) -> str:
    # A JSON string is a YAML double-quoted scalar; DEL is the one character
    # JSON leaves raw that YAML refuses.
    return json.dumps(text).replace("\x7f", "\\u007f")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # YAML 1.1 reads a float only with a dot in its mantissa.
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(value, str):
        return _quoted(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_scalar(v) for v in value) + "]"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _key(key: str) -> str:
    key = str(key)
    if _PLAIN_KEY.match(key) and key.lower() not in _YAML_WORDS:
        return key
    return _quoted(key)


def _lines(tree: Dict[str, Any], depth: int) -> List[str]:
    pad = "  " * depth
    lines = []
    for key, value in tree.items():
        if isinstance(value, dict) and value:
            lines.append(f"{pad}{_key(key)}:")
            lines.extend(_lines(value, depth + 1))
        else:
            text = "{}" if isinstance(value, dict) else _scalar(value)
            lines.append(f"{pad}{_key(key)}: {text}")
    return lines


def dump(tree: Dict[str, Any]) -> str:
    """``tree`` as block-style YAML that :func:`safe_load` and
    ``yaml.safe_load`` read back equal: nested mappings with string keys,
    and lists and scalars of str, int, float, bool and None."""
    return "".join(line + "\n" for line in _lines(tree, 0))
