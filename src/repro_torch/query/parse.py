"""BlendQL parser: SQL-ish string form of the logical IR.

Grammar (case-insensitive keywords)::

    query   := SELECT [TOP INT] [TABLES] WHERE expr
    expr    := or_e
    or_e    := sub_e (OR sub_e)*                 -> union
    sub_e   := and_e (EXCEPT and_e)*             -> difference (left-assoc)
    and_e   := atom (AND atom)*                  -> intersect
    atom    := '(' expr ')' | call
    call    := sc(lit, ..., k=N) | kw(lit, ..., k=N)
             | mc((lit, ...), ..., k=N)
             | corr([lit, ...], [num, ...], k=N, h=N, sampling='conv')
             | counter(expr, ..., k=N)

String literals use single quotes with ``''`` escaping; bare numbers are
int/float literals.  ``Expr.to_sql()`` emits exactly this grammar, so every
expression round-trips: ``parse(e.to_sql())`` is structurally equal to ``e``
(modulo the TOP clause, which becomes the root limit).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

from repro_torch.query import logical as L

_TOKEN = re.compile(r"""
      (?P<STRING>'(?:[^']|'')*')
    | (?P<NUMBER>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<NAME>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<PUNCT>[(),\[\]=])
    | (?P<WS>\s+)
""", re.VERBOSE)

_SEEKERS = {"sc", "kw", "mc", "corr"}


class BlendQLError(ValueError):
    """Raised on any lexical or syntactic error, with position context."""


@dataclass
class _Tok:
    kind: str
    text: str
    pos: int


def _lex(text: str) -> list:
    toks, i = [], 0
    while i < len(text):
        m = _TOKEN.match(text, i)
        if m is None:
            raise BlendQLError(f"unexpected character {text[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "WS":
            continue
        toks.append(_Tok(kind, m.group(), m.start()))
    toks.append(_Tok("EOF", "", len(text)))
    return toks


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = _lex(text)
        self.i = 0

    # ---------------------------------------------------------------- stream
    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _is_kw(self, word: str) -> bool:
        t = self.peek()
        return t.kind == "NAME" and t.text.lower() == word

    def expect_kw(self, word: str):
        if not self._is_kw(word):
            t = self.peek()
            raise BlendQLError(f"expected {word.upper()} at {t.pos}, "
                               f"got {t.text!r}")
        return self.next()

    def expect(self, text: str):
        t = self.peek()
        if t.text != text:
            raise BlendQLError(f"expected {text!r} at {t.pos}, got {t.text!r}")
        return self.next()

    # --------------------------------------------------------------- grammar
    def query(self) -> L.Expr:
        self.expect_kw("select")
        top = None
        if self._is_kw("top"):
            self.next()
            t = self.next()
            if t.kind != "NUMBER" or "." in t.text:
                raise BlendQLError(f"TOP expects an integer at {t.pos}")
            top = int(t.text)
        if self._is_kw("tables"):
            self.next()
        self.expect_kw("where")
        e = self.or_expr()
        if self.peek().kind != "EOF":
            t = self.peek()
            raise BlendQLError(f"trailing input at {t.pos}: {t.text!r}")
        if top is not None:
            e = e.top(min(top, e.k)) if isinstance(e, L.Seek) else e.top(top)
        return e

    def or_expr(self) -> L.Expr:
        kids = [self.sub_expr()]
        while self._is_kw("or"):
            self.next()
            kids.append(self.sub_expr())
        return kids[0] if len(kids) == 1 else L.Or(tuple(kids))

    def sub_expr(self) -> L.Expr:
        e = self.and_expr()
        while self._is_kw("except"):
            self.next()
            e = L.Sub(e, self.and_expr())
        return e

    def and_expr(self) -> L.Expr:
        kids = [self.atom()]
        while self._is_kw("and"):
            self.next()
            kids.append(self.atom())
        return kids[0] if len(kids) == 1 else L.And(tuple(kids))

    def atom(self) -> L.Expr:
        t = self.peek()
        if t.text == "(":
            self.next()
            e = self.or_expr()
            self.expect(")")
            return e
        if t.kind == "NAME":
            name = t.text.lower()
            if name in _SEEKERS:
                return self.seeker_call(name)
            if name == "counter":
                return self.counter_call()
        raise BlendQLError(f"expected seeker/counter call or '(' at {t.pos}, "
                           f"got {t.text!r}")

    # ----------------------------------------------------------------- calls
    def counter_call(self) -> L.Expr:
        self.next()                     # 'counter'
        self.expect("(")
        kids, kwargs = [], {}
        while True:
            if self._at_kwarg():
                kwargs.update([self.kwarg()])
            else:
                kids.append(self.or_expr())
            if self.peek().text == ",":
                self.next()
                continue
            break
        self.expect(")")
        bad = set(kwargs) - {"k"}
        if bad:
            raise BlendQLError(f"counter() got unknown options {sorted(bad)}")
        if len(kids) < 2:
            raise BlendQLError("counter() needs >= 2 input expressions")
        return L.Counter(tuple(kids), kwargs.get("k"))

    def seeker_call(self, name: str) -> L.Expr:
        tok = self.next()               # seeker name
        self.expect("(")
        args, kwargs = [], {}
        while self.peek().text != ")":
            if self._at_kwarg():
                kwargs.update([self.kwarg()])
            else:
                args.append(self.value())
            if self.peek().text == ",":
                self.next()
        self.expect(")")
        allowed = {"sc": {"k"}, "kw": {"k"}, "mc": {"k"},
                   "corr": {"k", "h", "sampling"}}[name]
        bad = set(kwargs) - allowed
        if bad:
            raise BlendQLError(f"{name}() got unknown options {sorted(bad)} "
                               f"at {tok.pos}")
        if not args:
            raise BlendQLError(f"{name}() needs at least one query value "
                               f"at {tok.pos}")
        k = kwargs.get("k", 100)
        if name == "sc":
            return L.sc(args, k=k)
        if name == "kw":
            return L.kw(args, k=k)
        if name == "mc":
            if not all(isinstance(a, tuple) for a in args):
                raise BlendQLError("mc() takes tuple arguments: mc(('a','b'))")
            return L.mc(args, k=k)
        # corr
        if len(args) != 2 or not all(isinstance(a, list) for a in args):
            raise BlendQLError("corr() takes two bracketed lists: "
                               "corr(['j1','j2'], [1.0, 2.0])")
        return L.corr(args[0], args[1], k=k, h=kwargs.get("h", 256),
                      sampling=kwargs.get("sampling", "conv"))

    def _at_kwarg(self) -> bool:
        return (self.peek().kind == "NAME"
                and self.toks[self.i + 1].text == "=")

    def kwarg(self):
        name = self.next().text.lower()
        self.expect("=")
        val = self.literal()
        return name, val

    def value(self):
        """literal | '(' literal, ... ')' | '[' literal, ... ']'"""
        t = self.peek()
        if t.text == "(":
            self.next()
            items = [self.literal()]
            while self.peek().text == ",":
                self.next()
                items.append(self.literal())
            self.expect(")")
            return tuple(items)
        if t.text == "[":
            self.next()
            items = [self.literal()]
            while self.peek().text == ",":
                self.next()
                items.append(self.literal())
            self.expect("]")
            return list(items)
        return self.literal()

    def literal(self):
        t = self.next()
        if t.kind == "STRING":
            return t.text[1:-1].replace("''", "'")
        if t.kind == "NUMBER":
            return float(t.text) if ("." in t.text or "e" in t.text.lower()) \
                else int(t.text)
        if t.kind == "NAME":            # bare word: treat as string value
            return t.text
        raise BlendQLError(f"expected a literal at {t.pos}, got {t.text!r}")


def parse(text: str) -> L.Expr:
    """Parse one BlendQL statement into a logical expression."""
    return _Parser(text).query()
