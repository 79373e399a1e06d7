"""Incremental JSON-prefix validator for constrained decoding
(OpenAI `response_format: {"type": "json_object"}`; the llama-server
grammar surface of the reference's BitNet.cpp backend — SURVEY.md §0).

`JsonPrefixValidator.advance(text)` consumes text character-by-character
and reports whether the accumulated output is still a valid *prefix* of
a JSON object ("ok"), can never become one ("dead"), or already is a
complete object ("complete"). The engine checks candidate tokens against
a cloned validator and feeds back only accepted ones
(engine/engine.py constrained decode path).

A copy of ``wrinklefree_tpu/engine/json_constraint.py`` (pure Python).
"""

from __future__ import annotations

WS = " \t\n\r"
DIGITS = "0123456789"
# number states from which a value may legally end at a delimiter
_NUM_ENDABLE = {"num_zero", "num_int", "num_frac", "num_exp"}
_LITERALS = {"t": "true", "f": "false", "n": "null"}


class JsonPrefixValidator:
    """State machine over characters; top-level value must be an object.

    States:
      start      — expect '{' (after optional ws)
      value      — expect any JSON value
      str / str_esc / str_u0..str_u3 — inside a string (value or key)
      num_*      — inside a number
      lit        — inside true/false/null (self.lit, self.lit_i)
      obj_first  — after '{': expect key or '}'
      obj_key    — after ',': expect key
      obj_colon  — after key: expect ':'
      obj_after  — after a member value: expect ',' or '}'
      arr_first  — after '[': expect value or ']'
      arr_after  — after an element: expect ',' or ']'
      done       — complete (trailing ws allowed)
      dead       — unrecoverable
    """

    __slots__ = ("state", "stack", "in_key", "lit", "lit_i", "u_left")

    def __init__(self):
        self.state = "start"
        self.stack = []  # 'o' | 'a'
        self.in_key = False
        self.lit = ""
        self.lit_i = 0
        self.u_left = 0

    def clone(self) -> "JsonPrefixValidator":
        v = JsonPrefixValidator.__new__(JsonPrefixValidator)
        v.state = self.state
        v.stack = list(self.stack)
        v.in_key = self.in_key
        v.lit = self.lit
        v.lit_i = self.lit_i
        v.u_left = self.u_left
        return v

    # ------------------------------------------------------------------

    def _end_value(self):
        if not self.stack:
            self.state = "done"
        elif self.stack[-1] == "o":
            self.state = "obj_after"
        else:
            self.state = "arr_after"

    def _close_container(self, ch):
        want = "o" if ch == "}" else "a"
        if not self.stack or self.stack[-1] != want:
            self.state = "dead"
            return
        self.stack.pop()
        self._end_value()

    def _char(self, ch):  # noqa: C901 — one branch per automaton state
        s = self.state
        if s == "dead":
            return
        if s == "done":
            if ch not in WS:
                self.state = "dead"
            return
        if s == "start":
            if ch in WS:
                return
            if ch == "{":
                self.stack.append("o")
                self.state = "obj_first"
            else:
                self.state = "dead"
            return
        if s == "str":
            if ch == '"':
                if self.in_key:
                    self.in_key = False
                    self.state = "obj_colon"
                else:
                    self._end_value()
            elif ch == "\\":
                self.state = "str_esc"
            elif ch < " ":
                self.state = "dead"
            return
        if s == "str_esc":
            if ch in '"\\/bfnrt':
                self.state = "str"
            elif ch == "u":
                self.state = "str_u"
                self.u_left = 4
            else:
                self.state = "dead"
            return
        if s == "str_u":
            if ch in "0123456789abcdefABCDEF":
                self.u_left -= 1
                if self.u_left == 0:
                    self.state = "str"
            else:
                self.state = "dead"
            return
        if s == "lit":
            want = self.lit
            if self.lit_i < len(want) and ch == want[self.lit_i]:
                self.lit_i += 1
                if self.lit_i == len(want):
                    self._end_value()
            else:
                self.state = "dead"
            return
        if s.startswith("num"):
            self._num_char(ch)
            return
        if s == "value":
            self._value_start(ch)
            return
        if s in ("obj_first", "obj_key"):
            if ch in WS:
                return
            if ch == '"':
                self.in_key = True
                self.state = "str"
            elif ch == "}" and s == "obj_first":
                self._close_container(ch)
            else:
                self.state = "dead"
            return
        if s == "obj_colon":
            if ch in WS:
                return
            if ch == ":":
                self.state = "value"
            else:
                self.state = "dead"
            return
        if s == "obj_after":
            if ch in WS:
                return
            if ch == ",":
                self.state = "obj_key"
            elif ch == "}":
                self._close_container(ch)
            else:
                self.state = "dead"
            return
        if s == "arr_first":
            if ch in WS:
                return
            if ch == "]":
                self._close_container(ch)
            else:
                self._value_start(ch)
            return
        if s == "arr_after":
            if ch in WS:
                return
            if ch == ",":
                self.state = "value"
            elif ch == "]":
                self._close_container(ch)
            else:
                self.state = "dead"
            return
        self.state = "dead"

    def _value_start(self, ch):
        if ch in WS:
            return
        if ch == '"':
            self.state = "str"
        elif ch == "{":
            self.stack.append("o")
            self.state = "obj_first"
        elif ch == "[":
            self.stack.append("a")
            self.state = "arr_first"
        elif ch == "-":
            self.state = "num_sign"
        elif ch == "0":
            self.state = "num_zero"
        elif ch in "123456789":
            self.state = "num_int"
        elif ch in _LITERALS:
            self.state = "lit"
            self.lit = _LITERALS[ch]
            self.lit_i = 1
        else:
            self.state = "dead"

    def _num_char(self, ch):
        s = self.state
        if s == "num_sign":
            if ch == "0":
                self.state = "num_zero"
            elif ch in "123456789":
                self.state = "num_int"
            else:
                self.state = "dead"
            return
        if s in ("num_zero", "num_int"):
            if ch in DIGITS and s == "num_int":
                return
            if ch == ".":
                self.state = "num_dot"
            elif ch in "eE":
                self.state = "num_e"
            elif ch in DIGITS and s == "num_zero":
                self.state = "dead"  # no leading zeros
            else:
                self._number_delim(ch)
            return
        if s == "num_dot":
            if ch in DIGITS:
                self.state = "num_frac"
            else:
                self.state = "dead"
            return
        if s == "num_frac":
            if ch in DIGITS:
                return
            if ch in "eE":
                self.state = "num_e"
            else:
                self._number_delim(ch)
            return
        if s == "num_e":
            if ch in "+-":
                self.state = "num_esign"
            elif ch in DIGITS:
                self.state = "num_exp"
            else:
                self.state = "dead"
            return
        if s == "num_esign":
            if ch in DIGITS:
                self.state = "num_exp"
            else:
                self.state = "dead"
            return
        if s == "num_exp":
            if ch in DIGITS:
                return
            self._number_delim(ch)
            return
        self.state = "dead"

    def _number_delim(self, ch):
        """A delimiter ends the number, then is re-processed."""
        self._end_value()
        self._char(ch)

    # ------------------------------------------------------------------

    def advance(self, text: str) -> str:
        """Consume `text`; returns "ok", "dead", or "complete"."""
        for ch in text:
            self._char(ch)
            if self.state == "dead":
                return "dead"
        # numbers can't complete at top level here (top level is an
        # object), so 'done' is the only complete state
        return "complete" if self.state == "done" else "ok"

    @property
    def complete(self) -> bool:
        return self.state == "done"
