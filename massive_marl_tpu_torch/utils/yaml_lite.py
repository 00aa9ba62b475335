"""A loader for the subset of YAML that cfg/ uses, with yaml.safe_load's
results on it.

The port's hosts need not have PyYAML, so the configs are read here: block
mappings, block lists (items indented under their key or level with it),
plain and quoted scalars, and comments.  Scalars resolve as PyYAML's YAML
1.1 resolver does: true/false/yes/no/on/off in their three spellings,
null/~/empty, decimal ints (underscores allowed), floats with a dot and an
optional signed exponent (so `1e-5`, with no dot, stays a string, as in
PyYAML), .inf and .nan.  Anything outside the subset raises ValueError:
flow collections, anchors, aliases, tags, block scalars, several
documents, tabs in the indentation, and the int and timestamp forms the
resolver would read in another base or as a date.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# forms PyYAML resolves that this loader does not take
_OTHER = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}


class _Line:
    def __init__(self, num: int, indent: int, text: str):
        self.num, self.indent, self.text = num, indent, text


def _strip_comment(text: str, num: int) -> str:
    """The line without its comment; quotes are honoured."""
    quote = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote:
            if quote == '"' and ch == "\\":
                i += 1                      # the escaped character
            elif ch == quote and quote == "'" and text[i + 1:i + 2] == "'":
                i += 1                      # '' inside single quotes
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " :-[{,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        raise ValueError(f"line {num}: unterminated quoted scalar")
    return text.rstrip()


def _lines(text: str) -> List[_Line]:
    out = []
    for num, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError(f"line {num}: tab in the indentation")
        body = _strip_comment(body, num)
        if not body:
            continue
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise ValueError(f"line {num}: documents and directives are not supported")
        out.append(_Line(num, len(raw) - len(raw.lstrip(" ")), body))
    return out


def _scalar(tok: str, num: int) -> Any:
    """One scalar token, resolved as yaml.safe_load resolves it."""
    if not tok:
        return None
    if tok[0] == "'":
        if len(tok) < 2 or tok[-1] != "'":
            raise ValueError(f"line {num}: bad single-quoted scalar {tok!r}")
        return tok[1:-1].replace("''", "'")
    if tok[0] == '"':
        if len(tok) < 2 or tok[-1] != '"':
            raise ValueError(f"line {num}: bad double-quoted scalar {tok!r}")
        out, i, body = [], 0, tok[1:-1]
        while i < len(body):
            if body[i] == "\\":
                esc = body[i + 1:i + 2]
                if esc not in _ESCAPES:
                    raise ValueError(f"line {num}: escape \\{esc} is not supported")
                out.append(_ESCAPES[esc])
                i += 2
            else:
                out.append(body[i])
                i += 1
        return "".join(out)
    if tok[0] in "[]{}&*!|>%@`" or tok in ("-", "?") or tok.startswith(("- ", "? ", ": ")):
        raise ValueError(f"line {num}: {tok!r} is outside the supported YAML subset")
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _INF.match(tok):
        return float("-inf") if tok[0] == "-" else float("inf")
    if _NAN.match(tok):
        return float("nan")
    if _OTHER.match(tok):
        raise ValueError(f"line {num}: scalar {tok!r} is outside the supported YAML subset")
    if ": " in tok or tok.endswith(":") or " #" in tok:
        raise ValueError(f"line {num}: unexpected mapping in scalar {tok!r}")
    return tok


def _split_key(text: str, num: int) -> Tuple[str, str] | None:
    """(key, rest) of a `key: value` or `key:` line, else None."""
    if text[0] in "'\"":
        end = text.find(text[0], 1)
        while text[0] == "'" and end >= 0 and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end < 0:
            raise ValueError(f"line {num}: unterminated quoted key")
        key, rest = _scalar(text[:end + 1], num), text[end + 1:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    m = re.match(r"([^:#]+?):(?: +(.*))?$", text)
    if m is None or m.group(1).startswith("- "):
        return None
    return _scalar(m.group(1), num), (m.group(2) or "").strip()


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at lines[i], all at `indent`."""
    if lines[i].text == "-" or lines[i].text.startswith("- "):
        return _seq(lines, i, indent)
    return _map(lines, i, indent)


def _value(lines: List[_Line], i: int, indent: int, rest: str, num: int,
           seq_level: bool) -> Tuple[Any, int]:
    """The value after `key:` (rest on the same line) or `-`; `indent` is the
    key's or the dash's column.  A key's list may sit level with the key."""
    if rest:
        if i < len(lines) and lines[i].indent > indent:
            raise ValueError(f"line {lines[i].num}: continuation lines are not supported")
        return _scalar(rest, num), i
    if i < len(lines) and lines[i].indent > indent:
        return _block(lines, i, lines[i].indent)
    if seq_level and i < len(lines) and lines[i].indent == indent and \
            (lines[i].text == "-" or lines[i].text.startswith("- ")):
        return _seq(lines, i, indent)
    return None, i


def _map(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        ln = lines[i]
        kv = _split_key(ln.text, ln.num)
        if kv is None:
            raise ValueError(f"line {ln.num}: expected `key: value`, got {ln.text!r}")
        key, rest = kv
        out[key], i = _value(lines, i + 1, indent, rest, ln.num, seq_level=True)
    if i < len(lines) and lines[i].indent > indent:
        raise ValueError(f"line {lines[i].num}: bad indentation")
    return out, i


def _seq(lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i].indent == indent and \
            (lines[i].text == "-" or lines[i].text.startswith("- ")):
        ln = lines[i]
        rest = ln.text[1:].lstrip(" ")
        if rest and _split_key(rest, ln.num) is not None:
            # a mapping that starts on the dash's line: re-read it as a block
            # at the column of its first key
            col = indent + len(ln.text) - len(rest)
            lines[i] = _Line(ln.num, col, rest)
            item, i = _map(lines, i, col)
        else:
            item, i = _value(lines, i + 1, indent, rest, ln.num, seq_level=False)
        out.append(item)
    return out, i


def loads(text: str) -> Any:
    """Parse one document of the supported subset."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0].indent != 0:
        raise ValueError(f"line {lines[0].num}: the document must start at column 0")
    if len(lines) == 1 and _split_key(lines[0].text, lines[0].num) is None and \
            not lines[0].text.startswith("- ") and lines[0].text != "-":
        return _scalar(lines[0].text, lines[0].num)
    value, i = _block(lines, 0, 0)
    if i != len(lines):
        raise ValueError(f"line {lines[i].num}: bad indentation")
    return value


def load(path: str) -> Any:
    """Parse the file at `path`."""
    with open(path, encoding="utf-8") as fh:
        return loads(fh.read())
