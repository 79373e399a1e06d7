"""JSON Schema -> GBNF compiler (llama.cpp `json_schema_to_grammar`
analog) for enforced structured output: OpenAI
`response_format: {"type": "json_schema", ...}` and llama.cpp
`json_schema` compile to a grammar enforced by engine/gbnf.py.

Supported subset: type object/array/string/number/integer/boolean/null,
`properties` (+ `required` — unlisted properties are omitted from the
output grammar; all listed-and-required emit in declaration order,
optional ones may be skipped), `items`, `minItems`/`maxItems`, `enum`,
`const`, `anyOf`/`oneOf`. Unsupported keywords (patterns, formats,
additionalProperties, $ref) are ignored — the grammar is as strict as
the supported subset allows.

A copy of ``wrinklefree_tpu/engine/schema_to_gbnf.py`` (pure Python).
"""

from __future__ import annotations

import json
from typing import Dict

_PRIMITIVES = """
ws ::= [ \\t\\n\\r]{0,8}
string ::= "\\"" strchar* "\\""
strchar ::= [^"\\\\\\x00-\\x1f] | "\\\\" (["\\\\/bfnrt] | "u" hex hex hex hex)
hex ::= [0-9a-fA-F]
number ::= "-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [+-]? [0-9]+)?
integer ::= "-"? ("0" | [1-9] [0-9]*)
boolean ::= "true" | "false"
null ::= "null"
value ::= anyobject | anyarray | string | number | boolean | null
anyobject ::= "{" ws ( string ws ":" ws value ( ws "," ws string ws ":" ws value )* )? ws "}"
anyarray ::= "[" ws ( value ( ws "," ws value )* )? ws "]"
"""


def _gbnf_literal(text: str) -> str:
    out = text.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\t", "\\t").replace("\r", "\\r")
    return f'"{out}"'


class _Compiler:
    def __init__(self):
        self.rules: Dict[str, str] = {}
        self.n = 0

    def fresh(self, base: str) -> str:
        self.n += 1
        return f"{base}{self.n}"

    def compile(self, schema: dict) -> str:
        root = self.visit(schema if isinstance(schema, dict) else {}, "r")
        lines = [f"root ::= ws {root} ws"]
        for name, body in self.rules.items():
            lines.append(f"{name} ::= {body}")
        return "\n".join(lines) + _PRIMITIVES

    def visit(self, schema: dict, hint: str) -> str:
        """Returns a rule name / inline expression for `schema`."""
        if "const" in schema:
            return _gbnf_literal(json.dumps(schema["const"]))
        if "enum" in schema:
            name = self.fresh(hint)
            self.rules[name] = " | ".join(
                _gbnf_literal(json.dumps(v)) for v in schema["enum"]
            )
            return name
        for key in ("anyOf", "oneOf"):
            if key in schema:
                name = self.fresh(hint)
                self.rules[name] = " | ".join(
                    f"( {self.visit(s, hint)} )" for s in schema[key]
                )
                return name
        t = schema.get("type")
        if isinstance(t, list):
            name = self.fresh(hint)
            self.rules[name] = " | ".join(
                self.visit({**schema, "type": x}, hint) for x in t
            )
            return name
        if t == "object" and "properties" in schema:
            return self._object(schema, hint)
        if t == "object":
            return "anyobject"
        if t == "array":
            return self._array(schema, hint)
        if t == "string":
            return "string"
        if t == "number":
            return "number"
        if t == "integer":
            return "integer"
        if t == "boolean":
            return "boolean"
        if t == "null":
            return "null"
        return "value"  # untyped

    def _object(self, schema: dict, hint: str) -> str:
        props = schema["properties"]
        required = set(schema.get("required", list(props)))
        kvs = []  # (kv_expr, optional)
        for pname, pschema in props.items():
            v = self.visit(pschema if isinstance(pschema, dict) else {},
                           f"{hint}_{self.n}")
            key = _gbnf_literal(json.dumps(pname))
            kvs.append((f'{key} ws ":" ws {v}', pname not in required))
        name = self.fresh(hint)
        self.rules[name] = f'"{{" ws {self._members(kvs, hint)} ws "}}"'
        return name

    def _members(self, kvs, hint) -> str:
        """Member list where optional properties may be skipped but comma
        placement stays valid: build right-to-left —
        rest(i) = ("," ws kv_i)? rest(i+1) for optional,
        rest(i) = "," ws kv_i rest(i+1) for required (after the first)."""
        if not kvs:
            return '""'
        # first emitted member can't have a leading comma: enumerate each
        # possible first member (required members stop the enumeration).
        # tail() is memoized by index — each optional property mints ONE
        # rule, not one per enclosing alternative.
        memo = {}

        def tail(i):
            if i in memo:
                return memo[i]
            if i >= len(kvs):
                memo[i] = ""
                return ""
            kv, opt = kvs[i]
            rest = tail(i + 1)
            seg = f'ws "," ws {kv} {rest}'.rstrip()
            if opt:
                r = self.fresh(f"{hint}o")
                self.rules[r] = f"( {seg} ) | {rest}" if rest else f'( ws "," ws {kv} ) | ""'
                memo[i] = r
                return r
            memo[i] = seg
            return seg

        alts = []
        for i, (kv, opt) in enumerate(kvs):
            alts.append(f"( {kv} {tail(i + 1)} )".rstrip())
            if not opt:
                break
        else:
            alts.append('""')  # every property optional: empty object ok
        r = self.fresh(f"{hint}m")
        self.rules[r] = " | ".join(alts)
        return r

    def _array(self, schema: dict, hint: str) -> str:
        item = self.visit(
            schema.get("items", {}) if isinstance(schema.get("items", {}), dict)
            else {},
            f"{hint}i",
        )
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        name = self.fresh(hint)
        more = f'( ws "," ws {item} )'
        if hi is not None and int(hi) == 0:
            self.rules[name] = '"[" ws "]"'
            return name
        if hi is None:
            if lo == 0:
                body = f'"[" ws ( {item} {more}* )? ws "]"'
            else:
                body = f'"[" ws {item} {more}{{{lo - 1},}} ws "]"'
        else:
            hi = int(hi)
            if lo == 0:
                body = f'"[" ws ( {item} {more}{{0,{max(hi - 1, 0)}}} )? ws "]"'
            else:
                body = f'"[" ws {item} {more}{{{lo - 1},{hi - 1}}} ws "]"'
        self.rules[name] = body
        return name


def schema_to_gbnf(schema: dict) -> str:
    """Compile a JSON Schema (supported subset) to GBNF text."""
    return _Compiler().compile(schema)
