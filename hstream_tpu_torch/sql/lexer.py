"""SQL tokenizer (a copy of hstream_tpu/sql/lexer.py;
only its imports differ).

Token kinds: IDENT, RAWCOL (`backticked`), NUMBER, STRING ("double"),
SSTRING ('single' — JSON payload in INSERT), symbols, EOF. Keywords are
recognized case-insensitively at the parser level (the reference's BNFC
grammar demands exact-case keywords; we accept any case and canonicalize).
Comments: // line and /* block */ (SQL.cf `comment` pragmas).
"""

from __future__ import annotations

from dataclasses import dataclass

from hstream_tpu_torch.common.errors import SQLParseError

SYMBOLS = [
    "<>", "<=", ">=", "||", "&&",
    "(", ")", "[", "]", "{", "}", ",", ";", ":", ".", "=", "<", ">",
    "+", "-", "*", "/", "%",
]


@dataclass(frozen=True)
class Token:
    kind: str      # IDENT RAWCOL NUMBER STRING SSTRING SYM EOF
    text: str
    value: object  # parsed value for NUMBER/STRING
    line: int
    col: int

    @property
    def upper(self) -> str:
        return self.text.upper()


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i, line, col = 0, 1, 1
    n = len(src)

    def err(msg: str):
        raise SQLParseError(msg, (line, col))

    while i < n:
        c = src[i]
        if c == "\n":
            i += 1
            line += 1
            col = 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                err("unterminated block comment")
            skipped = src[i:end + 2]
            line += skipped.count("\n")
            col = 1 if "\n" in skipped else col + len(skipped)
            i = end + 2
            continue
        start_line, start_col = line, col
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and (src[j].isdigit() or src[j] == "."):
                if src[j] == ".":
                    if is_float:
                        break
                    is_float = True
                j += 1
            if j < n and src[j] in "eE":
                k = j + 1
                if k < n and src[k] in "+-":
                    k += 1
                if k < n and src[k].isdigit():
                    is_float = True
                    j = k
                    while j < n and src[j].isdigit():
                        j += 1
            text = src[i:j]
            value = float(text) if is_float else int(text)
            toks.append(Token("NUMBER", text, value, start_line, start_col))
            col += j - i
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            text = src[i:j]
            toks.append(Token("IDENT", text, text, start_line, start_col))
            col += j - i
            i = j
            continue
        if c == "`":
            j = src.find("`", i + 1)
            if j < 0:
                err("unterminated `raw column`")
            text = src[i + 1:j]
            toks.append(Token("RAWCOL", text, text, start_line, start_col))
            col += j + 1 - i
            i = j + 1
            continue
        if c in "\"'":
            quote = c
            j = i + 1
            buf = []
            while j < n and src[j] != quote:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\",
                                quote: quote}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                err("unterminated string literal")
            kind = "STRING" if quote == '"' else "SSTRING"
            toks.append(Token(kind, src[i:j + 1], "".join(buf),
                              start_line, start_col))
            col += j + 1 - i
            i = j + 1
            continue
        for sym in SYMBOLS:
            if src.startswith(sym, i):
                toks.append(Token("SYM", sym, sym, start_line, start_col))
                i += len(sym)
                col += len(sym)
                break
        else:
            err(f"unexpected character {c!r}")
    toks.append(Token("EOF", "", None, line, col))
    return toks
