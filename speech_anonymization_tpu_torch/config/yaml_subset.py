"""A reader for the subset of YAML that the repo's configs use, without PyYAML.

The JAX package's config loader is built on PyYAML's ``SafeLoader``; the port
may not need PyYAML (a CUDA machine with PyTorch need not have it), so it reads
its configs here. What it reads, it reads as ``yaml.SafeLoader`` does:

  * block mappings and block sequences (also a sequence at its key's indent,
    and the compact ``- key: value`` form), comments, and one document
    (a leading ``---`` and a closing ``...`` are allowed);
  * flow sequences and flow mappings (``["train"]``, ``{recon: 0.0, sex:
    0.8}``), also across lines, with a trailing comma;
  * single- and double-quoted scalars on one line (``''``, and a backslash
    before a backslash, a double quote, a slash, ``t`` or ``n``), and plain
    scalars, folded over more-indented lines;
  * YAML 1.1's implicit types with PyYAML's own patterns: ``yes``/``no``/
    ``on``/``off``/``true``/``false`` in three casings are bools; ``1e-5`` is
    a string (a 1.1 float needs a dot) and ``0.000025`` a float; octal
    ``0..``, ``0x..``, ``0b..`` and underscores are ints; ``.inf``/``.nan``;
    ``~``, ``null`` and the empty value are None;
  * tags (``!new:Fbank``, ``!ref``): each tagged node is handed to the
    caller's ``construct(tag, kind, value)``, ``kind`` being ``"scalar"``
    (``value`` the raw string, as PyYAML's ``construct_scalar`` gives it),
    ``"sequence"`` or ``"mapping"``. Without a ``construct``, a tag is an error,
    as an unknown tag is to ``yaml.safe_load``.

Anchors and aliases, block scalars (``|``, ``>``), complex keys (``?``),
merge keys, directives, several documents, multi-line quoted scalars, dates
and timestamps, base-60 numbers (``1:30``) and the other escapes are refused
with :class:`YAMLError`, and so is anything PyYAML itself refuses
among the constructs above (a ``key: value`` where a plain value must be, a
bad indentation, an unclosed bracket or quote).
"""

from __future__ import annotations

import re
from typing import Any, Callable

Construct = Callable[[str, str, Any], Any]


class YAMLError(ValueError):
    pass


# PyYAML's implicit resolvers (yaml/resolver.py), in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
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
# matched only to be refused (PyYAML would read them as datetime values)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_ESCAPES = {"t": "\t", "n": "\n", '"': '"', "\\": "\\", "/": "/"}
_FLOW_STOP = ",[]{}"
# characters that cannot start a plain scalar (PyYAML's check_plain)
_NOT_PLAIN = "-?:,[]{}#&*!|>'\"%@`"


def _int(value: str) -> int:
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
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted, untagged) scalar's value under YAML 1.1, as PyYAML's
    ``SafeLoader`` resolves and constructs it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if (_FLOAT.match(text) or _INT.match(text)) and ":" in text:
        raise YAMLError(f"{text!r}: base-60 numbers are not supported")
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if text in ("<<", "="):
        raise YAMLError(f"{text!r}: merge keys and the value type are not supported")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise YAMLError(f"{text!r}: dates and timestamps are not supported")
    return text


def _quoted(s: str, pos: int, line: int) -> tuple[str, int]:
    """The quoted scalar opening at ``s[pos]`` -> (its value, the index after it)."""
    quote, out, i = s[pos], [], pos + 1
    while i < len(s):
        c = s[i]
        if quote == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            if e not in _ESCAPES:
                raise YAMLError(f"line {line}: the escape \\{e} is not supported")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise YAMLError(f"line {line}: unclosed quoted scalar (multi-line quoted scalars are not supported)")


def _skip_spaces(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] in " \t":
        pos += 1
    return pos


def _at_comment(s: str, pos: int) -> bool:
    return pos < len(s) and s[pos] == "#" and (pos == 0 or s[pos - 1] in " \t")


def _strip_comment(s: str) -> str:
    """``s`` without a trailing comment; quotes opening a token are skipped."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:"):
            try:
                _, i = _quoted(s, i, 0)
            except YAMLError:
                return s
            continue
        if _at_comment(s, i):
            return s[:i].rstrip()
        i += 1
    return s


def _is_seq_entry(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


def _plain_end(s: str, pos: int, flow: bool) -> int:
    """Where the plain scalar starting at ``s[pos]`` ends (its trailing
    spaces included)."""
    i = pos
    while i < len(s):
        c = s[i]
        nxt = s[i + 1:i + 2]
        if c == "#" and s[i - 1] in " \t":
            break
        if c == ":" and (nxt in ("", " ", "\t") or (flow and nxt in _FLOW_STOP)):
            break
        if flow and c in _FLOW_STOP + "?":
            break
        i += 1
    return i


def _check_plain_start(s: str, pos: int, flow: bool, line: int) -> None:
    c, nxt = s[pos], s[pos + 1:pos + 2]
    if c in _NOT_PLAIN and not (c in "-?:" and nxt not in ("", " ", "\t")
                                and not (flow and nxt in _FLOW_STOP)):
        raise YAMLError(f"line {line}: a plain scalar cannot start with {c!r}")


class _Reader:
    def __init__(self, text: str, construct: Construct | None):
        self.construct = construct
        self.lines: list[list] = []
        started = False
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            indent = len(body) - len(stripped)
            if not stripped or stripped.startswith("#"):
                continue
            if stripped.startswith("\t"):
                raise YAMLError(f"line {no}: a tab in the indentation")
            if stripped.startswith("%"):
                raise YAMLError(f"line {no}: directives are not supported")
            if indent == 0 and (stripped == "---" or stripped.startswith("--- ")):
                if started or stripped != "---":
                    raise YAMLError(f"line {no}: one document without content on its '---' line only")
                started = True
                continue
            if indent == 0 and stripped == "...":
                break
            started = True
            self.lines.append([no, indent, stripped])
        self.i = 0

    def error(self, msg: str, line: int | None = None):
        if line is None:
            line = self.lines[min(self.i, len(self.lines) - 1)][0] if self.lines else 0
        raise YAMLError(f"line {line}: {msg}")

    # -- block structure ------------------------------------------------------

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.block(self.lines[0][1], -1)
        if self.i < len(self.lines):
            self.error("content after the document's end (bad indentation?)")
        return value

    def block(self, indent: int, parent: int) -> Any:
        """The node whose first line is the current one, at ``indent``."""
        no, _, text = self.lines[self.i]
        if _is_seq_entry(text):
            return self.sequence(indent)
        if self.split_key(text, no) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.inline(text, parent, no, tagged=False)[0]

    def split_key(self, text: str, no: int):
        """``key: rest`` -> (the key, rest after the colon) or None."""
        if text[0] in "'\"":
            key, pos = _quoted(text, 0, no)
            pos = _skip_spaces(text, pos)
            if text[pos:pos + 1] == ":" and text[pos + 1:pos + 2] in ("", " ", "\t"):
                return key, text[pos + 1:].lstrip(" \t")
            return None
        if text[0] in "[{!&*|>" or text.startswith(("? ", "?\t")) or text == "?":
            if text[0] in "&*" or text.startswith("?"):
                self.error("anchors, aliases and complex keys are not supported", no)
            return None
        end = _plain_end(text, 0, flow=False)
        if text[end:end + 1] != ":":
            return None
        key = text[:end].rstrip()
        _check_plain_start(key, 0, False, no)
        return resolve_plain(key), text[end + 1:].lstrip(" \t")

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                self.error("bad indentation of a mapping entry", no)
            split = self.split_key(text, no)
            if split is None:
                self.error("expected a 'key: value' entry", no)
            key, rest = split
            self.i += 1
            out[key] = self.value(rest, indent, no, in_mapping=True)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind < indent or (ind == indent and not _is_seq_entry(text)):
                break
            if ind > indent:
                self.error("bad indentation of a sequence entry", no)
            after = text[1:]
            rest = after.lstrip(" \t")
            col = indent + 1 + len(after) - len(rest)
            if rest and not rest.startswith("#") and (
                    _is_seq_entry(rest) or self.split_key(rest, no) is not None):
                # the compact form: the rest is a block of its own at its column
                self.lines[self.i] = [no, col, rest]
                out.append(self.block(col, indent))
            else:
                self.i += 1
                out.append(self.value(rest, indent, no, in_mapping=False))
        return out

    def value(self, rest: str, indent: int, no: int, in_mapping: bool) -> Any:
        """The value after ``key:`` or ``-`` (``rest``), or the nested block."""
        tag = None
        if rest.startswith("#"):
            rest = ""
        if rest.startswith("!"):
            end = 0
            while end < len(rest) and rest[end] not in " \t":
                end += 1
            tag, rest = rest[:end], rest[end:].lstrip(" \t")
            if rest.startswith("#"):
                rest = ""
        if rest[:1] in ("&", "*"):
            self.error("anchors and aliases are not supported", no)
        if rest[:1] in ("|", ">"):
            self.error("block scalars are not supported", no)
        if rest:
            value, kind = self.inline(rest, indent, no, tagged=tag is not None)
        elif self.i < len(self.lines) and (self.lines[self.i][1] > indent or (
                in_mapping and self.lines[self.i][1] == indent and _is_seq_entry(self.lines[self.i][2]))):
            value = self.block(self.lines[self.i][1], indent)
            kind = "mapping" if isinstance(value, dict) else "sequence" if isinstance(value, list) else "scalar"
            if kind == "scalar" and tag is not None:
                self.error("a tagged scalar on the lines below its tag is not supported", no)
        else:
            value, kind = ("" if tag is not None else None), "scalar"
        return self.tagged(tag, kind, value, no) if tag is not None else value

    def tagged(self, tag: str, kind: str, value: Any, no: int) -> Any:
        if self.construct is None:
            self.error(f"could not determine a constructor for the tag {tag!r}", no)
        return self.construct(tag, kind, value)

    # -- one node on its line(s) ------------------------------------------------

    def inline(self, text: str, parent: int, no: int, tagged: bool) -> tuple[Any, str]:
        """The node written from ``text`` on, continued on lines indented past
        ``parent`` where it must be: -> (value, kind). A tagged plain scalar
        stays the raw string."""
        if text[0] in "[{":
            s = _strip_comment(text)
            while not self._balanced(s, no):
                if self.i >= len(self.lines):
                    self.error("unclosed flow collection", no)
                s += " " + _strip_comment(self.lines[self.i][2])
                self.i += 1
            value, pos = self.flow_node(s, 0, no)
            self._expect_end(s, pos, no)
            return value, "mapping" if isinstance(value, dict) else "sequence"
        if text[0] in "'\"":
            value, pos = _quoted(text, 0, no)
            self._expect_end(text, pos, no)
            return value, "scalar"
        _check_plain_start(text, 0, False, no)
        end = _plain_end(text, 0, flow=False)
        parts = [text[:end].rstrip()]
        stopped = _at_comment(text, end)
        if end < len(text) and not stopped:
            self.error("mapping values are not allowed here", no)
        while not stopped and self.i < len(self.lines) and self.lines[self.i][1] > parent:
            cont_no, _, cont = self.lines[self.i]
            if _is_seq_entry(cont):
                break
            end = _plain_end(cont, 0, flow=False)
            if end < len(cont) and not _at_comment(cont, end):
                self.error("mapping values are not allowed here", cont_no)
            parts.append(cont[:end].rstrip())
            stopped = _at_comment(cont, end)
            self.i += 1
        plain = " ".join(parts)
        return (plain if tagged else resolve_plain(plain)), "scalar"

    def _balanced(self, s: str, no: int) -> bool:
        depth, i = 0, 0
        while i < len(s):
            c = s[i]
            if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:"):
                _, i = _quoted(s, i, no)
                continue
            depth += c in "[{"
            depth -= c in "]}"
            i += 1
        return depth <= 0

    def _expect_end(self, s: str, pos: int, no: int) -> None:
        pos = _skip_spaces(s, pos)
        if pos < len(s) and not _at_comment(s, pos):
            self.error(f"unexpected {s[pos:]!r} after a node", no)

    def flow_node(self, s: str, pos: int, no: int) -> tuple[Any, int]:
        pos = _skip_spaces(s, pos)
        if pos >= len(s):
            self.error("unexpected end of a flow collection", no)
        c = s[pos]
        if c == "[":
            return self.flow_sequence(s, pos + 1, no)
        if c == "{":
            return self.flow_mapping(s, pos + 1, no)
        if c in "'\"":
            return _quoted(s, pos, no)
        if c in "&*":
            self.error("anchors and aliases are not supported", no)
        tag = None
        if c == "!":
            end = pos
            while end < len(s) and s[end] not in " \t" + _FLOW_STOP:
                end += 1
            tag, pos = s[pos:end], _skip_spaces(s, end)
            if pos < len(s) and s[pos] in "[{'\"":
                value, pos = self.flow_node(s, pos, no)
                kind = "mapping" if isinstance(value, dict) else "sequence" if isinstance(value, list) else "scalar"
                return self.tagged(tag, kind, value, no), pos
        if pos < len(s) and s[pos] in _FLOW_STOP:
            if tag is not None:
                return self.tagged(tag, "scalar", "", no), pos
            self.error(f"an empty entry before {s[pos]!r}", no)
        _check_plain_start(s, pos, True, no)
        end = _plain_end(s, pos, flow=True)
        plain = s[pos:end].rstrip()
        if tag is not None:
            return self.tagged(tag, "scalar", plain, no), end
        return resolve_plain(plain), end

    def flow_sequence(self, s: str, pos: int, no: int) -> tuple[list, int]:
        out: list = []
        while True:
            pos = _skip_spaces(s, pos)
            if s[pos:pos + 1] == "]":
                return out, pos + 1
            value, pos = self.flow_node(s, pos, no)
            pos = _skip_spaces(s, pos)
            c = s[pos:pos + 1]
            if c == ":":
                self.error("single-pair mappings inside a flow sequence are not supported", no)
            out.append(value)
            if c == ",":
                pos += 1
            elif c != "]":
                self.error("expected ',' or ']' in a flow sequence", no)

    def flow_mapping(self, s: str, pos: int, no: int) -> tuple[dict, int]:
        out: dict = {}
        while True:
            pos = _skip_spaces(s, pos)
            if s[pos:pos + 1] == "}":
                return out, pos + 1
            if s[pos:pos + 1] in ("[", "{", "?"):
                self.error("complex keys are not supported", no)
            key, pos = self.flow_node(s, pos, no)
            pos = _skip_spaces(s, pos)
            value = None
            if s[pos:pos + 1] == ":":
                pos = _skip_spaces(s, pos + 1)
                if s[pos:pos + 1] not in (",", "}"):
                    value, pos = self.flow_node(s, pos, no)
                    pos = _skip_spaces(s, pos)
            out[key] = value
            c = s[pos:pos + 1]
            if c == ",":
                pos += 1
            elif c != "}":
                self.error("expected ',' or '}' in a flow mapping", no)


def load(text: str, construct: Construct | None = None) -> Any:
    """One YAML document (the subset above) -> Python values."""
    return _Reader(text, construct).document()
