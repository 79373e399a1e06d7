"""GBNF (llama.cpp grammar format) parser + incremental matcher for
constrained decoding (llama-server `grammar` field — the reference's
BitNet.cpp backend surface, SURVEY.md §0 backend 2).

Grammar model (llama.cpp llama-grammar semantics):
  rule    ::= name "::=" alternates
  alt     ::= sequence ("|" sequence)*
  element ::= "literal" | [char-class] | rule-name | ( alternates )
              with ?, *, +, {m}, {m,}, {m,n} postfixes; # comments

The matcher keeps a SET of parse stacks (each a tuple of pending
elements, terminal-expanded lazily) and advances them char-by-char —
the same possible-stacks algorithm llama.cpp uses. `advance` reports
"ok" (still matchable), "dead" (no stack survives), or "complete"
(matched and no continuation possible). `completable` is True when some
stack has fully matched but others could still consume input — the
engine then allows EOS (engine/engine.py _select_constrained).

A copy of ``wrinklefree_tpu/engine/gbnf.py`` (pure Python).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# element kinds:
#   ("c", ranges, neg)  — char terminal: tuple of (lo, hi) codepoint
#                         ranges; neg=True for [^...]
#   ("r", name)         — rule reference
Element = tuple
Alternates = List[List[Element]]  # list of sequences


class GbnfError(ValueError):
    pass


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


class _P:
    def __init__(self, text: str):
        self.s = text
        self.i = 0
        self.rules: Dict[str, Alternates] = {}
        self.gen = 0  # generated-rule counter (repetition desugaring)

    def err(self, msg):
        line = self.s.count("\n", 0, self.i) + 1
        raise GbnfError(f"GBNF parse error (line {line}): {msg}")

    def ws(self, newlines=True):
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == "#":  # comment to EOL
                while self.i < len(self.s) and self.s[self.i] != "\n":
                    self.i += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.i += 1
            else:
                break

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else ""

    def name(self) -> str:
        j = self.i
        while self.i < len(self.s) and (
            self.s[self.i].isalnum() or self.s[self.i] in "-_"
        ):
            self.i += 1
        if self.i == j:
            self.err("expected rule name")
        return self.s[j:self.i]

    def _escape(self) -> str:
        c = self.s[self.i]
        self.i += 1
        if c != "\\":
            return c
        e = self.s[self.i]
        self.i += 1
        simple = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
                  "/": "/", "'": "'", "[": "[", "]": "]"}
        if e in simple:
            return simple[e]
        if e in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[e]
            h = self.s[self.i:self.i + n]
            self.i += n
            return chr(int(h, 16))
        self.err(f"bad escape \\{e}")

    def literal(self) -> List[Element]:
        assert self.peek() == '"'
        self.i += 1
        out = []
        while self.peek() != '"':
            if not self.peek():
                self.err("unterminated literal")
            ch = self._escape()
            out.append(("c", ((ord(ch), ord(ch)),), False))
        self.i += 1
        return out

    def char_class(self) -> Element:
        assert self.peek() == "["
        self.i += 1
        neg = False
        if self.peek() == "^":
            neg = True
            self.i += 1
        ranges = []
        while self.peek() != "]":
            if not self.peek():
                self.err("unterminated char class")
            lo = self._escape()
            hi = lo
            if self.peek() == "-" and self.s[self.i + 1:self.i + 2] != "]":
                self.i += 1
                hi = self._escape()
            ranges.append((ord(lo), ord(hi)))
        self.i += 1
        if not ranges and not neg:
            self.err("empty char class")
        return ("c", tuple(ranges), neg)

    def _fresh(self, base: str) -> str:
        self.gen += 1
        return f"{base}__{self.gen}"

    def _rep(self, base_rule: str, elems: List[Element], lo: int, hi) -> List[Element]:
        """Desugar e{lo,hi} (hi=None for unbounded) into rules."""
        out = list(elems) * lo
        if hi is None:
            star = self._fresh(base_rule)
            # star: elems star | ε
            self.rules[star] = [list(elems) + [("r", star)], []]
            out.append(("r", star))
        else:
            for _ in range(hi - lo):
                opt = self._fresh(base_rule)
                self.rules[opt] = [list(elems), []]
                out.append(("r", opt))
        return out

    def element(self, rule: str) -> List[Element]:
        self.ws(newlines=False)
        c = self.peek()
        if c == '"':
            elems = self.literal()
        elif c == "[":
            elems = [self.char_class()]
        elif c == "(":
            self.i += 1
            alts = self.alternates(rule)
            self.ws()
            if self.peek() != ")":
                self.err("expected )")
            self.i += 1
            grp = self._fresh(rule)
            self.rules[grp] = alts
            elems = [("r", grp)]
        else:
            elems = [("r", self.name())]
        # postfix
        self.ws(newlines=False)
        p = self.peek()
        if p and p in "*+?":
            self.i += 1
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[p]
            return self._rep(rule, elems, lo, hi)
        if p == "{":
            self.i += 1
            j = self.i
            while self.peek() not in ",}":
                self.i += 1
            lo = int(self.s[j:self.i] or 0)
            hi = lo
            if self.peek() == ",":
                self.i += 1
                j = self.i
                while self.peek() != "}":
                    self.i += 1
                t = self.s[j:self.i].strip()
                hi = int(t) if t else None
            if self.peek() != "}":
                self.err("expected }")
            self.i += 1
            return self._rep(rule, elems, lo, hi)
        return elems

    def sequence(self, rule: str) -> List[Element]:
        out = []
        while True:
            self.ws(newlines=False)
            c = self.peek()
            if not c or c in "|)\r\n":
                return out
            # a name followed by ::= starts the NEXT rule
            if c.isalnum() or c in "-_":
                save = self.i
                self.name()
                k = self.i
                while k < len(self.s) and self.s[k] in " \t":
                    k += 1
                if self.s[k:k + 3] == "::=":
                    self.i = save
                    return out
                self.i = save
            out.extend(self.element(rule))

    def alternates(self, rule: str) -> Alternates:
        alts = [self.sequence(rule)]
        while True:
            self.ws()
            if self.peek() == "|":
                self.i += 1
                alts.append(self.sequence(rule))
            else:
                return alts

    def parse(self) -> Dict[str, Alternates]:
        while True:
            self.ws()
            if self.i >= len(self.s):
                break
            rule = self.name()
            self.ws(newlines=False)
            if self.s[self.i:self.i + 3] != "::=":
                self.err("expected ::=")
            self.i += 3
            self.rules[rule] = self.alternates(rule)
        if "root" not in self.rules:
            raise GbnfError("grammar has no root rule")
        for alts in list(self.rules.values()):
            for seq in alts:
                for el in seq:
                    if el[0] == "r" and el[1] not in self.rules:
                        raise GbnfError(f"undefined rule: {el[1]}")
        return self.rules


def parse_gbnf(text: str) -> Dict[str, Alternates]:
    return _P(text).parse()


# ---------------------------------------------------------------------------
# incremental matcher
# ---------------------------------------------------------------------------

_MAX_STACKS = 512  # ambiguous-grammar explosion guard
_MAX_DEPTH = 256  # nullable/recursive expansion guard


def _matches(el: Element, ch: str) -> bool:
    _, ranges, neg = el
    cp = ord(ch)
    inside = any(lo <= cp <= hi for lo, hi in ranges)
    return inside != neg


class GbnfValidator:
    """Same interface as JsonPrefixValidator: advance/clone/complete.

    A state is a set of stacks; stack[0] is the next element to match.
    """

    __slots__ = ("rules", "stacks", "matched")

    def __init__(self, rules_or_text):
        if isinstance(rules_or_text, str):
            rules_or_text = parse_gbnf(rules_or_text)
        self.rules = rules_or_text
        self.matched = False  # some stack fully matched the input so far
        self.stacks = self._expand((("r", "root"),))
        self.matched = any(not s for s in self.stacks)
        self.stacks = [s for s in self.stacks if s]

    def clone(self) -> "GbnfValidator":
        v = GbnfValidator.__new__(GbnfValidator)
        v.rules = self.rules  # immutable, shared
        v.stacks = list(self.stacks)
        v.matched = self.matched
        return v

    def _expand(self, stack: tuple, depth=0) -> List[tuple]:
        """Stacks equivalent to `stack` whose top is a terminal (or that
        are empty = fully matched)."""
        if depth > _MAX_DEPTH:
            raise GbnfError("grammar expansion too deep (left recursion?)")
        if not stack or stack[0][0] == "c":
            return [stack]
        out = []
        rest = stack[1:]
        for seq in self.rules[stack[0][1]]:
            out.extend(self._expand(tuple(seq) + rest, depth + 1))
        return out

    def _advance_char(self, ch: str) -> bool:
        new = []
        seen = set()
        matched = False
        for st in self.stacks:
            if _matches(st[0], ch):
                for nxt in self._expand(st[1:]):
                    if not nxt:
                        matched = True
                    elif nxt not in seen:
                        seen.add(nxt)
                        new.append(nxt)
                        if len(new) >= _MAX_STACKS:
                            raise GbnfError("grammar too ambiguous")
        self.stacks = new
        self.matched = matched
        return bool(new) or matched

    def advance(self, text: str) -> str:
        for ch in text:
            if not self._advance_char(ch):
                self.stacks = []
                self.matched = False
                return "dead"
        if self.matched and not self.stacks:
            return "complete"  # matched, nothing can extend
        return "ok"

    @property
    def complete(self) -> bool:
        return self.matched and not self.stacks

    @property
    def completable(self) -> bool:
        """Input fully matches root, but longer matches exist — the
        engine may accept EOS here (llama.cpp: EOS legal when a stack
        is empty)."""
        return self.matched
