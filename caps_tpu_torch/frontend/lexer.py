"""openCypher tokenizer.

Hand-written scanner producing a flat token stream: identifiers (plus
backtick-quoted), case-insensitive keywords, integer/float literals, string
literals with escapes, parameters, multi-char operators, and ``//`` and
``/* */`` comments.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class CypherSyntaxError(Exception):
    def __init__(self, message: str, query: str = "", pos: int = 0):
        self.message = message
        self.pos = pos
        if query:
            line = query.count("\n", 0, pos) + 1
            col = pos - (query.rfind("\n", 0, pos) + 1) + 1
            snippet = query[max(0, pos - 30):pos + 30].replace("\n", " ")
            message = f"{message} (line {line}, column {col}, near ...{snippet!r}...)"
        super().__init__(message)


KEYWORDS = frozenset({
    "MATCH", "OPTIONAL", "WHERE", "WITH", "RETURN", "ORDER", "BY", "SKIP",
    "LIMIT", "UNWIND", "AS", "UNION", "ALL", "DISTINCT", "CREATE", "MERGE",
    "SET", "DELETE", "DETACH", "REMOVE", "AND", "OR", "XOR", "NOT", "IN",
    "STARTS", "ENDS", "CONTAINS", "IS", "NULL", "TRUE", "FALSE", "CASE",
    "WHEN", "THEN", "ELSE", "END", "ASC", "ASCENDING", "DESC", "DESCENDING",
    "FROM", "GRAPH", "CONSTRUCT", "CLONE", "NEW", "ON", "CATALOG", "STORE",
    "USE", "CALL", "YIELD",
})

# EXPLAIN / PROFILE are *prefix markers*, not reserved words: no valid
# statement starts with a bare identifier, so a leading IDENT spelled
# like one of these is unambiguous — and `explain`/`profile` stay usable
# as variable/alias/property names everywhere else (obs/).
QUERY_MODES = frozenset({"EXPLAIN", "PROFILE"})

# Token kinds
IDENT = "IDENT"
KEYWORD = "KEYWORD"
INT = "INT"
FLOAT = "FLOAT"
STRING = "STRING"
SYM = "SYM"
EOF = "EOF"

_SYMBOLS = (
    "<=", ">=", "<>", "=~", "..", "->", "<-", "+=",
    "(", ")", "[", "]", "{", "}", ",", ":", ";", ".", "|", "=",
    "<", ">", "+", "-", "*", "/", "%", "^", "$",
)

_ESCAPES = {
    "\\": "\\", "'": "'", '"': '"', "n": "\n", "t": "\t", "r": "\r",
    "b": "\b", "f": "\f", "0": "\0",
}


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str
    text: str          # keywords normalized to upper-case
    value: object      # parsed value for literals; text otherwise
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def tokenize(query: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(query)
    while i < n:
        c = query[i]
        if c.isspace():
            i += 1
            continue
        if c == "/" and i + 1 < n and query[i + 1] == "/":
            j = query.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and query[i + 1] == "*":
            j = query.find("*/", i + 2)
            if j < 0:
                raise CypherSyntaxError("unterminated block comment", query, i)
            i = j + 2
            continue
        if c in "'\"":
            s, j = _scan_string(query, i)
            out.append(Token(STRING, query[i:j], s, i))
            i = j
            continue
        if c == "`":
            j = query.find("`", i + 1)
            if j < 0:
                raise CypherSyntaxError("unterminated backtick identifier", query, i)
            out.append(Token(IDENT, query[i + 1:j], query[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and query[i + 1].isdigit()
                           and _prev_allows_number(out)):
            tok, j = _scan_number(query, i)
            out.append(tok)
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (query[j].isalnum() or query[j] == "_"):
                j += 1
            word = query[i:j]
            upper = word.upper()
            if upper in KEYWORDS:
                out.append(Token(KEYWORD, upper, word, i))
            else:
                out.append(Token(IDENT, word, word, i))
            i = j
            continue
        for sym in _SYMBOLS:
            if query.startswith(sym, i):
                # '..' must not eat the dot of a float like `0..3`
                out.append(Token(SYM, sym, sym, i))
                i += len(sym)
                break
        else:
            raise CypherSyntaxError(f"unexpected character {c!r}", query, i)
    out.append(Token(EOF, "", None, n))
    return out


def _prev_allows_number(out: List[Token]) -> bool:
    """A leading-dot float (`.5`) is only a float when the previous token
    cannot end a property access (e.g. after `(` or an operator)."""
    if not out:
        return True
    prev = out[-1]
    if prev.kind in (IDENT, INT, FLOAT, STRING):
        return False
    if prev.kind == SYM and prev.text in (")", "]", "}"):
        return False
    return True


def _scan_string(query: str, i: int) -> Tuple[str, int]:
    quote = query[i]
    j = i + 1
    buf: List[str] = []
    n = len(query)
    while j < n:
        c = query[j]
        if c == "\\":
            if j + 1 >= n:
                break
            e = query[j + 1]
            if e == "u" and j + 5 < n:
                buf.append(chr(int(query[j + 2:j + 6], 16)))
                j += 6
                continue
            buf.append(_ESCAPES.get(e, e))
            j += 2
            continue
        if c == quote:
            return "".join(buf), j + 1
        buf.append(c)
        j += 1
    raise CypherSyntaxError("unterminated string literal", query, i)


def _scan_number(query: str, i: int) -> Tuple[Token, int]:
    n = len(query)
    j = i
    is_float = False
    if query.startswith("0x", i) or query.startswith("0X", i):
        j = i + 2
        while j < n and query[j] in "0123456789abcdefABCDEF":
            j += 1
        return Token(INT, query[i:j], int(query[i:j], 16), i), j
    while j < n and query[j].isdigit():
        j += 1
    # Disambiguate `1..3` (range) from `1.3` (float)
    if j < n and query[j] == "." and not query.startswith("..", j):
        if j + 1 < n and query[j + 1].isdigit():
            is_float = True
            j += 1
            while j < n and query[j].isdigit():
                j += 1
    if j < n and query[j] in "eE":
        k = j + 1
        if k < n and query[k] in "+-":
            k += 1
        if k < n and query[k].isdigit():
            is_float = True
            j = k
            while j < n and query[j].isdigit():
                j += 1
    text = query[i:j]
    if is_float or text.startswith("."):
        return Token(FLOAT, text, float(text), i), j
    return Token(INT, text, int(text), i), j
