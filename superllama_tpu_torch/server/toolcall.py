"""Tool-call (function calling) support: grammar construction + output parsing.

Counterpart of the reference's common/chat.cpp tool-call machinery
(format-specific grammars + streaming parsers for generic/hermes/llama3/
mistral/deepseek styles; see also common/chat-parser.cpp). The flow:

1. `plan_tools(body, template_text)` inspects the request's `tools` /
   `tool_choice` and the model's chat template to pick a ToolFormat.
2. The plan carries a GBNF grammar (lazy, trigger-activated, unless
   tool_choice=="required") built from the tools' JSON-schema parameters.
3. `parse_tool_calls(plan, text)` splits the generation into plain content +
   OpenAI-style tool_calls entries.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Any

from ..grammar.json_schema import SchemaConverter

FORMAT_GENERIC = "generic"
FORMAT_HERMES = "hermes"        # <tool_call>{...}</tool_call>
FORMAT_LLAMA3 = "llama3"        # {"name": ..., "parameters": {...}}
FORMAT_MISTRAL = "mistral"      # [TOOL_CALLS][{...}, ...]
FORMAT_DEEPSEEK_R1 = "deepseek-r1"    # <｜tool▁call▁begin｜>fn<｜tool▁sep｜>…
FORMAT_COMMAND_R7B = "command-r7b"    # <|START_ACTION|>[{...}]<|END_ACTION|>
FORMAT_GRANITE = "granite"            # <|tool_call|>[{...}]
FORMAT_GLM45 = "glm-4.5"              # <tool_call>NAME <arg_key>… XML-ish
FORMAT_QWEN3_CODER = "qwen3-coder"    # <function=NAME><parameter=K>V
FORMAT_GPT_OSS = "gpt-oss"            # harmony channels
FORMAT_SEED_OSS = "seed-oss"          # <seed:tool_call><function=NAME>…
FORMAT_NEMOTRON_V2 = "nemotron-v2"    # <TOOLCALL>[{...}]</TOOLCALL>
FORMAT_KIMI_K2 = "kimi-k2"            # <|tool_call_begin|>functions.N:i…
FORMAT_MINIMAX_M2 = "minimax-m2"      # <minimax:tool_call><invoke name=…
FORMAT_LFM2 = "lfm2"                  # <|tool_call_start|>[{...}]
FORMAT_APERTUS = "apertus"            # <|tools_prefix|>[{NAME: args}]
FORMAT_MIMO = "tool-calls-array"      # <tool_calls>[{...}]</tool_calls>
                                      # (xiaomi-mimo + apriel-1.5)
FORMAT_FUNCTIONARY_V32 = "functionary-v3.2"   # name\n{args}>>>name\n{args}
FORMAT_FIREFUNCTION = "firefunction-v2"       # functools[{...}]
FORMAT_DEEPSEEK_V31 = "deepseek-v3.1"  # NAME<｜tool▁sep｜>{json} (no fence)

# formats whose streaming path buffers the whole call scope then emits
# (XML-ish / multi-marker syntaxes; common/chat-parser.cpp equivalents
# stream these too — buffered emission keeps syntax out of content without
# per-format incremental parsers)
_SCOPED = {
    FORMAT_DEEPSEEK_R1: ("<｜tool▁calls▁begin｜>", "<｜tool▁calls▁end｜>"),
    FORMAT_COMMAND_R7B: ("<|START_ACTION|>", "<|END_ACTION|>"),
    FORMAT_GRANITE: ("<|tool_call|>", None),
    FORMAT_GLM45: ("<tool_call>", "</tool_call>"),
    FORMAT_QWEN3_CODER: ("<tool_call>", "</tool_call>"),
    FORMAT_GPT_OSS: ("<|channel|>", None),
    FORMAT_SEED_OSS: ("<seed:tool_call>", "</seed:tool_call>"),
    FORMAT_NEMOTRON_V2: ("<TOOLCALL>", "</TOOLCALL>"),
    FORMAT_KIMI_K2: ("<|tool_calls_section_begin|>",
                     "<|tool_calls_section_end|>"),
    FORMAT_MINIMAX_M2: ("<minimax:tool_call>", "</minimax:tool_call>"),
    FORMAT_LFM2: ("<|tool_call_start|>", "<|tool_call_end|>"),
    FORMAT_APERTUS: ("<|tools_prefix|>", "<|tools_suffix|>"),
    FORMAT_MIMO: ("<tool_calls>", "</tool_calls>"),
    FORMAT_FUNCTIONARY_V32: (">>>", None),
    FORMAT_FIREFUNCTION: (" functools[", None),
    FORMAT_DEEPSEEK_V31: ("<｜tool▁call▁begin｜>", "<｜tool▁call▁end｜>"),
}

# reasoning block markers per format; None key = default <think> pair
_REASONING_MARKS = [
    ("<think>", "</think>"),
    ("<thinking>", "</thinking>"),
    ("<|START_THINKING|>", "<|END_THINKING|>"),
    ("<seed:think>", "</seed:think>"),
    ("[THINK]", "[/THINK]"),          # magistral
]


def split_reasoning(text: str, forced_open: bool = False) -> tuple[str, str]:
    """Extract leading reasoning blocks (common/chat.cpp reasoning syntax
    handling): returns (reasoning_content, rest). Only blocks at the start
    of the generation count — mirrors the reference's forced-open/leading
    `<think>` semantics, including an UNCLOSED leading block (whole text is
    reasoning)."""
    if forced_open and not text.lstrip().startswith("<think>"):
        text = "<think>" + text
    reasoning: list[str] = []
    rest = text
    progressed = True
    while progressed:
        progressed = False
        stripped = rest.lstrip()
        for open_m, close_m in _REASONING_MARKS:
            if stripped.startswith(open_m):
                body = stripped[len(open_m):]
                end = body.find(close_m)
                if end < 0:
                    reasoning.append(body.strip())
                    return "\n".join(reasoning), ""
                reasoning.append(body[:end].strip())
                rest = body[end + len(close_m):]
                progressed = True
                break
    return "\n".join(reasoning), rest.lstrip("\n")


@dataclass
class ToolPlan:
    fmt: str
    grammar: str | None = None
    grammar_lazy: bool = True
    triggers: list[str] = field(default_factory=list)
    forced: bool = False            # tool_choice == "required" / named
    tool_names: list[str] = field(default_factory=list)
    extra_stops: list[str] = field(default_factory=list)


# format-specific stop words (the reference's additional_stops)
_EXTRA_STOPS = {
    FORMAT_GLM45: ["<|user|>", "<|observation|>"],
    FORMAT_KIMI_K2: ["<|im_end|>", "<|im_middle|>"],
}


def _call_schema(tool: dict, args_key: str = "arguments") -> dict:
    fn = tool.get("function", tool)
    params = fn.get("parameters") or {"type": "object"}
    return {
        "type": "object",
        "properties": {"name": {"const": fn["name"]}, args_key: params},
        "required": ["name", args_key],
        "additionalProperties": False,
    }


def _calls_gbnf(tools: list[dict], wrap: str, args_key: str = "arguments") -> str:
    """One grammar whose root matches a tool call in the given wrapping.

    wrap: 'bare' — the JSON call object alone;
          'hermes' — one or more <tool_call>…</tool_call> blocks;
          'mistral' — [TOOL_CALLS] prefix + JSON array of calls.
    """
    any_call = {"anyOf": [_call_schema(t, args_key) for t in tools]}
    conv = SchemaConverter(any_call)
    call_ref = conv.visit(any_call, "toolcall")
    conv._prim("space")
    lines = []
    if wrap == "bare":
        lines.append(f"root ::= {call_ref}")
    elif wrap == "hermes":
        lines.append(
            f'root ::= tcblock+\n'
            f'tcblock ::= "<tool_call>" space {call_ref} "</tool_call>" space')
    elif wrap == "mistral":
        lines.append(
            f'root ::= "[TOOL_CALLS]" space "[" space {call_ref} '
            f'("," space {call_ref})* "]" space')
    for name, body in conv.rules.items():
        lines.append(f"{name} ::= {body}")
    from ..grammar.json_schema import PRIMITIVES
    for prim in sorted(conv._prims):
        lines.append(PRIMITIVES[prim])
    return "\n".join(lines)


def detect_format(template_text: str | None) -> str:
    """Template → tool-call format (common_chat_templates_apply detection
    cascade, common/chat.cpp:2916-3010 — ordering matters: several formats
    share the <tool_call> wrapper)."""
    t = template_text or ""
    if "message['prefix'] is defined and message['prefix'] and thinking" in t:
        return FORMAT_DEEPSEEK_V31
    if "<｜tool▁calls▁begin｜>" in t:
        return FORMAT_DEEPSEEK_R1
    if "<|END_THINKING|><|START_ACTION|>" in t:
        return FORMAT_COMMAND_R7B
    if "elif thinking" in t and "<|tool_call|>" in t:
        return FORMAT_GRANITE
    if "<arg_key>" in t and "<arg_value>" in t:
        return FORMAT_GLM45
    if "<seed:think>" in t or "<seed:tool_call>" in t:
        return FORMAT_SEED_OSS
    if "<function=" in t and "<parameter=" in t:
        return FORMAT_QWEN3_CODER
    if "<|tool_calls_section_begin|>" in t:
        return FORMAT_KIMI_K2
    if "<minimax:tool_call>" in t:
        return FORMAT_MINIMAX_M2
    if "<TOOLCALL>" in t or "<SPECIAL_10>" in t:
        return FORMAT_NEMOTRON_V2
    if "<|tool_list_start|>" in t and "<|tool_list_end|>" in t:
        return FORMAT_LFM2
    if "<|tools_prefix|>" in t:
        return FORMAT_APERTUS
    if "<tool_calls>[" in t and "]</tool_calls>" in t:
        return FORMAT_MIMO            # xiaomi-mimo / apriel-1.5
    if ">>>all" in t:
        return FORMAT_FUNCTIONARY_V32
    if " functools[" in t:
        return FORMAT_FIREFUNCTION
    if "<tool_call>" in t or "tool_call" in t and "<|im_start|>" in t:
        return FORMAT_HERMES
    if "<|channel|>" in t:
        return FORMAT_GPT_OSS
    if "[TOOL_CALLS]" in t:
        return FORMAT_MISTRAL
    if "<|start_header_id|>" in t or "<|python_tag|>" in t:
        return FORMAT_LLAMA3
    return FORMAT_GENERIC


def plan_tools(body: dict, template_text: str | None = None) -> ToolPlan | None:
    """Build the constrained-decoding plan for a request with tools."""
    tools = body.get("tools") or []
    choice = body.get("tool_choice", "auto")
    if not tools or choice == "none":
        return None
    if isinstance(choice, dict):  # {"type":"function","function":{"name":...}}
        want = choice.get("function", {}).get("name")
        tools = [t for t in tools
                 if (t.get("function", t)).get("name") == want] or tools
        choice = "required"

    fmt = detect_format(template_text)
    names = [(t.get("function", t))["name"] for t in tools]
    plan = ToolPlan(fmt=fmt, tool_names=names, forced=choice == "required")

    if fmt == FORMAT_HERMES:
        plan.grammar = _calls_gbnf(tools, "hermes")
        plan.triggers = [r"<tool_call>"]
    elif fmt == FORMAT_MISTRAL:
        plan.grammar = _calls_gbnf(tools, "mistral")
        plan.triggers = [r"\[TOOL_CALLS\]"]
    elif fmt == FORMAT_LLAMA3:
        plan.grammar = _calls_gbnf(tools, "bare", args_key="parameters")
        plan.triggers = [r'\{\s*"name"\s*:']
    elif fmt in _SCOPED:
        plan.grammar = _scoped_gbnf(tools, fmt)
        open_lit = _SCOPED[fmt][0]
        plan.triggers = [re.escape(open_lit)]
    else:  # generic: a bare JSON call object
        plan.grammar = _calls_gbnf(tools, "bare")
        plan.triggers = [r'\{\s*"name"\s*:']
    plan.grammar_lazy = not plan.forced
    plan.extra_stops = list(_EXTRA_STOPS.get(fmt, []))
    return plan


def _scoped_gbnf(tools: list[dict], fmt: str) -> str:
    """Grammar for the scoped (marker-delimited) formats. JSON-argument
    formats constrain args with the tools' schemas; XML-parameter formats
    constrain structure with free-text values ([^<]*) — the same shape the
    reference's build_grammar_xml_tool_call produces."""
    names = [(t.get("function", t))["name"] for t in tools]
    name_alt = " | ".join(f'"{n}"' for n in names)
    conv = SchemaConverter({})
    arg_refs = {}
    for t in tools:
        fn = t.get("function", t)
        params = fn.get("parameters") or {"type": "object"}
        arg_refs[fn["name"]] = conv.visit(params, f"args-{fn['name']}")
    conv._prim("space")
    lines = []
    if fmt == FORMAT_DEEPSEEK_V31:
        calls = " | ".join(
            f'"<｜tool▁call▁begin｜>{n}<｜tool▁sep｜>" {arg_refs[n]} '
            f'"<｜tool▁call▁end｜>"' for n in names)
        lines.append(f'root ::= call+ space\ncall ::= ({calls})')
    elif fmt == FORMAT_DEEPSEEK_R1:
        calls = " | ".join(
            f'"<｜tool▁call▁begin｜>function<｜tool▁sep｜>{n}\\n```json\\n" '
            f'{arg_refs[n]} "\\n```<｜tool▁call▁end｜>"' for n in names)
        lines.append(f'root ::= "<｜tool▁calls▁begin｜>" call+ '
                     f'"<｜tool▁calls▁end｜>" space\ncall ::= ({calls})')
    elif fmt in (FORMAT_COMMAND_R7B, FORMAT_GRANITE, FORMAT_NEMOTRON_V2,
                 FORMAT_LFM2, FORMAT_MIMO, FORMAT_FIREFUNCTION):
        opens = {FORMAT_COMMAND_R7B: '"<|START_ACTION|>"',
                 FORMAT_GRANITE: '"<|tool_call|>"',
                 FORMAT_NEMOTRON_V2: '"<TOOLCALL>"',
                 FORMAT_LFM2: '"<|tool_call_start|>"',
                 FORMAT_MIMO: '"<tool_calls>"',
                 FORMAT_FIREFUNCTION: '" functools"'}[fmt]
        closes = {FORMAT_COMMAND_R7B: '"<|END_ACTION|>"',
                  FORMAT_GRANITE: '""',
                  FORMAT_NEMOTRON_V2: '"</TOOLCALL>"',
                  FORMAT_LFM2: '"<|tool_call_end|>"',
                  FORMAT_MIMO: '"</tool_calls>"',
                  FORMAT_FIREFUNCTION: '""'}[fmt]
        key = "parameters" if fmt == FORMAT_COMMAND_R7B else "arguments"
        calls = " | ".join(
            f'"{{" space "\\"{"tool_name" if fmt == FORMAT_COMMAND_R7B else "name"}\\"" space ":" space "\\"{n}\\"" space '
            f'"," space "\\"{key}\\"" space ":" space {arg_refs[n]} space "}}"'
            for n in names)
        lines.append(f'root ::= {opens} space "[" space call ("," space call)* '
                     f'"]" space {closes} space\ncall ::= ({calls})')
    elif fmt == FORMAT_APERTUS:
        calls = " | ".join(
            f'"{{" space "\\"{n}\\"" space ":" space {arg_refs[n]} space "}}"'
            for n in names)
        lines.append('root ::= "<|tools_prefix|>" space "[" space call '
                     '("," space call)* "]" space "<|tools_suffix|>" space\n'
                     f'call ::= ({calls})')
    elif fmt == FORMAT_FUNCTIONARY_V32:
        calls = " | ".join(f'"{n}\\n" {arg_refs[n]}' for n in names)
        lines.append(f'root ::= call (">>>" call)* space\ncall ::= ({calls})')
    elif fmt == FORMAT_KIMI_K2:
        calls = " | ".join(
            f'"<|tool_call_begin|>functions.{n}:" [0-9]+ '
            f'"<|tool_call_argument_begin|>" {arg_refs[n]} "<|tool_call_end|>"'
            for n in names)
        lines.append('root ::= "<|tool_calls_section_begin|>" call+ '
                     '"<|tool_calls_section_end|>" space\n'
                     f'call ::= ({calls})')
    elif fmt == FORMAT_GPT_OSS:
        calls = " | ".join(
            f'" to=functions.{n}" " <|constrain|>json"? "<|message|>" '
            f'{arg_refs[n]}' for n in names)
        lines.append('root ::= "<|channel|>commentary" call "<|call|>"?\n'
                     f'call ::= ({calls})')
    else:  # XML-parameter forms: glm-4.5 / qwen3-coder / seed-oss / minimax
        forms = {
            FORMAT_GLM45: ('"<tool_call>{n}\\n" ',
                           '"<arg_key>" pkey "</arg_key>\\n"'
                           ' "<arg_value>" pval "</arg_value>\\n"',
                           '"</tool_call>"'),
            FORMAT_QWEN3_CODER: ('"<tool_call>\\n<function={n}>\\n" ',
                                 '"<parameter=" pkey ">\\n" pval '
                                 '"\\n</parameter>\\n"',
                                 '"</function>\\n</tool_call>"'),
            FORMAT_SEED_OSS: ('"<seed:tool_call>\\n<function={n}>\\n" ',
                              '"<parameter=" pkey ">" pval "</parameter>\\n"',
                              '"</function>\\n</seed:tool_call>"'),
            FORMAT_MINIMAX_M2: ('"<minimax:tool_call>\\n<invoke name=\\"{n}\\">\\n" ',
                                '"<parameter name=\\"" pkey "\\">" pval '
                                '"</parameter>\\n"',
                                '"</invoke>\\n</minimax:tool_call>"'),
        }[fmt]
        heads = " | ".join(forms[0].replace("{n}", n) for n in names)
        lines.append(f'root ::= ({heads}) param* {forms[2]} space\n'
                     f'param ::= {forms[1]}\n'
                     'pkey ::= [a-zA-Z0-9_-]+\n'
                     'pval ::= [^<]*')
    for name, body in conv.rules.items():
        lines.append(f"{name} ::= {body}")
    from ..grammar.json_schema import PRIMITIVES
    for prim in sorted(conv._prims):
        lines.append(PRIMITIVES[prim])
    return "\n".join(lines)


def _mk_call(name: str, args: Any) -> dict:
    return {
        "id": "call_" + uuid.uuid4().hex[:16],
        "type": "function",
        "function": {"name": name,
                     "arguments": json.dumps(args) if not isinstance(args, str) else args},
    }


def _json_objects(text: str) -> list[tuple[Any, int, int]]:
    """All top-level JSON values decodable at '{' or '[' starts."""
    dec = json.JSONDecoder()
    out = []
    i = 0
    while i < len(text):
        if text[i] in "{[":
            try:
                val, end = dec.raw_decode(text, i)
                out.append((val, i, end))
                i = end
                continue
            except json.JSONDecodeError:
                pass
        i += 1
    return out


class StreamingToolCallParser:
    """Incremental stream splitter: content deltas vs tool-call deltas.

    Counterpart of the reference's streaming chat parsers
    (common/chat-parser.cpp + common/json-partial.cpp): feeds of generated
    text pieces are split into

      {"ev": "content",  "text": str}
      {"ev": "tc_start", "index": i, "id": "call_…", "name": str}
      {"ev": "tc_args",  "index": i, "delta": str}   # raw-JSON fragment

    Tool-call syntax never leaks into content events, and content that might
    be the start of a trigger marker is held back until disambiguated.
    ``arguments`` deltas are raw spans of the source buffer (monotonic across
    feeds), so their concatenation is exactly the model's argument JSON.
    """

    def __init__(self, plan: ToolPlan):
        self.plan = plan
        self.buf = ""
        self.pos = 0                 # consumed prefix (emitted or skipped)
        self.mode = "content"        # content | lead | call | close | scope
        self.args_key = ("parameters" if plan.fmt == FORMAT_LLAMA3
                         else "arguments")
        self.index = -1
        self.call_start = 0
        self.name_emitted = False
        self.args_emitted = 0
        self.ids: list[str] = []
        self.scoped = (None if plan.fmt == FORMAT_GPT_OSS
                       else _SCOPED.get(plan.fmt))
        self.scope_start = 0
        # gpt-oss harmony channel machine
        self.harmony = plan.fmt == FORMAT_GPT_OSS
        self.h_state = "content"     # content | hdr | body
        self.h_kind = "content"      # body routing: content|reasoning|call
        self.h_fn = None

    _H_ENDS = ("<|end|>", "<|call|>", "<|channel|>", "<|start|>",
               "<|return|>")

    def _harmony_feed(self) -> list[dict]:
        """Incremental harmony-channel splitter (gpt-oss): analysis bodies
        stream as reasoning, final bodies as content, commentary
        to=functions.N bodies buffer into one call (chat.cpp gpt-oss
        parser's streaming behavior)."""
        evs: list[dict] = []
        progressing = True
        while progressing:
            progressing = False
            s, p = self.buf, self.pos
            pending = s[p:]
            if self.h_state == "content":
                marks = ("<|channel|>", "<|start|>", "<|end|>", "<|return|>")
                hits = [(pending.find(mk), mk) for mk in marks]
                hits = [(i, mk) for i, mk in hits if i >= 0]
                if hits:
                    i, mk = min(hits)
                    if pending[:i]:
                        evs.append({"ev": "content", "text": pending[:i]})
                    self.pos = p + i + len(mk)
                    if mk == "<|channel|>":
                        self.h_state = "hdr"
                    elif mk == "<|start|>":
                        self.h_state = "skipword"   # role name follows
                    progressing = True
                else:
                    keep = 0
                    for mk in marks:
                        for k in range(min(len(mk) - 1, len(pending)), 0, -1):
                            if mk.startswith(pending[-k:]):
                                keep = max(keep, k)
                                break
                    emit = pending[: len(pending) - keep]
                    if emit:
                        evs.append({"ev": "content", "text": emit})
                        self.pos = p + len(emit)
            elif self.h_state == "skipword":
                m = re.match(r"\w*[^\w]", pending)
                if m:
                    self.pos = p + m.end() - 1    # keep the non-word char
                    self.h_state = "content"
                    progressing = True
                else:
                    break                         # role name may continue
            elif self.h_state == "hdr":
                end = pending.find("<|message|>")
                if end < 0:
                    break
                hdr = pending[:end]
                m = re.match(r"\s*(\w+)(?:\s+to=functions\.([\w.\-]+))?", hdr)
                ch = m.group(1) if m else ""
                self.h_fn = m.group(2) if m else None
                if self.h_fn is None:
                    m2 = re.search(r"to=functions\.([\w.\-]+)", hdr)
                    self.h_fn = m2.group(1) if m2 else None
                if self.h_fn:
                    self.h_kind = "call"
                    self.index += 1
                    cid = "call_" + uuid.uuid4().hex[:16]
                    self.ids.append(cid)
                    evs.append({"ev": "tc_start", "index": self.index,
                                "id": cid, "name": self.h_fn})
                elif ch == "analysis":
                    self.h_kind = "reasoning"
                else:
                    self.h_kind = "content"
                self.pos = p + end + len("<|message|>")
                self.h_state = "body"
                progressing = True
            elif self.h_state == "body":
                hits = [(pending.find(mk), mk) for mk in self._H_ENDS]
                hits = [(i, mk) for i, mk in hits if i >= 0]
                if hits:
                    i, mk = min(hits)
                    body = pending[:i]
                    if body:
                        evs.extend(self._h_body(body))
                    self.pos = p + i + (0 if mk in ("<|channel|>", "<|start|>")
                                        else len(mk))
                    self.h_state = "content"
                    progressing = True
                else:
                    keep = 0
                    for mk in self._H_ENDS:
                        for k in range(min(len(mk) - 1, len(pending)), 0, -1):
                            if mk.startswith(pending[-k:]):
                                keep = max(keep, k)
                                break
                    emit = pending[: len(pending) - keep]
                    if emit:
                        evs.extend(self._h_body(emit))
                        self.pos = p + len(emit)
        return evs

    def _h_body(self, text: str) -> list[dict]:
        if self.h_kind == "call":
            return [{"ev": "tc_args", "index": self.index, "delta": text}]
        if self.h_kind == "reasoning":
            return [{"ev": "reasoning", "text": text}]
        return [{"ev": "content", "text": text}]

    def _emit_scope(self, chunk: str) -> list[dict]:
        """Parse a complete call scope and emit whole-call events."""
        _, calls = _parse_scoped(self.plan.fmt, chunk)
        evs = []
        for c in calls:
            self.index += 1
            self.ids.append(c["id"])
            evs.append({"ev": "tc_start", "index": self.index,
                        "id": c["id"], "name": c["function"]["name"]})
            evs.append({"ev": "tc_args", "index": self.index,
                        "delta": c["function"]["arguments"]})
        return evs

    # ------------------------------------------------------------- helpers

    def _lit(self) -> str | None:
        return {"hermes": "<tool_call>", "mistral": "[TOOL_CALLS]"}.get(
            self.plan.fmt)

    def _holdback(self, text: str) -> int:
        """Length of the tail of `text` that could still become a trigger."""
        lit = self._lit()
        if lit is not None:
            for k in range(min(len(lit) - 1, len(text)), 0, -1):
                if lit.startswith(text[-k:]):
                    return k
            return 0
        # generic/llama3: a bare `{ "name" :` object start
        brace = text.rfind("{")
        if brace == -1:
            return 0
        squeezed = "".join(text[brace:].split())
        if '{"name":'.startswith(squeezed) or squeezed.startswith('{"name":'):
            return len(text) - brace
        return 0

    def _events_for_call(self) -> list[dict]:
        """Emit name/args deltas for the call object at self.call_start."""
        from .json_partial import object_items, scan_value, skip_ws

        evs: list[dict] = []
        s = self.buf
        start = skip_ws(s, self.call_start)
        if start >= len(s) or s[start] != "{":
            return evs
        self.call_start = start
        for key, vs, ve, vok in object_items(s, start):
            if key == "name" and not self.name_emitted and vok:
                name = json.loads(s[vs:ve])
                cid = "call_" + uuid.uuid4().hex[:16]
                self.ids.append(cid)
                evs.append({"ev": "tc_start", "index": self.index,
                            "id": cid, "name": name})
                self.name_emitted = True
            elif key == self.args_key and self.name_emitted:
                raw = s[vs:ve]
                if len(raw) > self.args_emitted:
                    evs.append({"ev": "tc_args", "index": self.index,
                                "delta": raw[self.args_emitted:]})
                    self.args_emitted = len(raw)
        end, complete = scan_value(s, start)
        if complete:
            self.pos = end
            self.mode = "close"
        return evs

    # --------------------------------------------------------------- feeds

    def feed(self, piece: str) -> list[dict]:
        self.buf += piece
        evs: list[dict] = []
        from .json_partial import skip_ws

        if self.harmony:
            return self._harmony_feed()
        progressing = True
        while progressing:
            progressing = False
            s, p = self.buf, self.pos
            if self.scoped is not None:
                open_lit, close_lit = self.scoped
                if self.mode == "content":
                    pending = s[p:]
                    hit = pending.find(open_lit)
                    if hit >= 0:
                        if pending[:hit]:
                            evs.append({"ev": "content",
                                        "text": pending[:hit]})
                        self.pos = p + hit
                        self.scope_start = self.pos
                        self.mode = "scope"
                        progressing = True
                    else:
                        keep = 0
                        for k in range(min(len(open_lit) - 1, len(pending)),
                                       0, -1):
                            if open_lit.startswith(pending[-k:]):
                                keep = k
                                break
                        emit = pending[: len(pending) - keep]
                        if emit:
                            evs.append({"ev": "content", "text": emit})
                            self.pos = p + len(emit)
                elif self.mode == "scope" and close_lit is not None:
                    end = s.find(close_lit, self.scope_start + len(open_lit))
                    if end >= 0:
                        end += len(close_lit)
                        evs.extend(self._emit_scope(s[self.scope_start:end]))
                        self.pos = end
                        self.mode = "content"
                        progressing = True
                continue
            if self.mode == "content":
                lit = self._lit()
                pending = s[p:]
                hit = pending.find(lit) if lit else self._generic_hit(pending)
                if hit >= 0:
                    if pending[:hit]:
                        evs.append({"ev": "content", "text": pending[:hit]})
                    self.pos = p + hit
                    self.mode = "lead"
                    progressing = True
                else:
                    keep = self._holdback(pending)
                    emit = pending[: len(pending) - keep]
                    if emit:
                        evs.append({"ev": "content", "text": emit})
                        self.pos = p + len(emit)
            elif self.mode == "lead":
                lit = self._lit()
                if lit:
                    if len(s) - p < len(lit):
                        break
                    p += len(lit)
                j = skip_ws(s, p)
                if self.plan.fmt == FORMAT_MISTRAL:
                    if j < len(s) and s[j] == "[":
                        j = skip_ws(s, j + 1)
                    elif j >= len(s):
                        break
                if j < len(s) and s[j] == "{":
                    self.index += 1
                    self.call_start = j
                    self.name_emitted = False
                    self.args_emitted = 0
                    self.mode = "call"
                    self.pos = j
                    progressing = True
                elif j < len(s):
                    # false trigger (e.g. bare '{' that never forms a call):
                    # emit the lead verbatim as content
                    self.mode = "content"
                    evs.append({"ev": "content", "text": s[self.pos:j or None]})
                    self.pos = max(j, self.pos + 1)
                    progressing = True
            elif self.mode == "call":
                got = self._events_for_call()
                evs.extend(got)
                progressing = self.mode == "close"
            elif self.mode == "close":
                j = skip_ws(s, p)
                if self.plan.fmt == FORMAT_HERMES:
                    tail = "</tool_call>"
                    if s.startswith(tail, j):
                        self.pos = j + len(tail)
                        self.mode = "content"
                        progressing = True
                    elif len(s) - j >= len(tail) or not tail.startswith(
                            s[j:j + len(tail)]):
                        self.mode = "content"  # malformed close; move on
                        progressing = True
                elif self.plan.fmt == FORMAT_MISTRAL:
                    if j < len(s) and s[j] == ",":
                        k = skip_ws(s, j + 1)
                        if k < len(s) and s[k] == "{":
                            self.index += 1
                            self.call_start = k
                            self.name_emitted = False
                            self.args_emitted = 0
                            self.mode = "call"
                            self.pos = k
                            progressing = True
                    elif j < len(s) and s[j] == "]":
                        self.pos = j + 1
                        self.mode = "content"
                        progressing = True
                    elif j < len(s):
                        self.mode = "content"
                        progressing = True
                else:
                    self.mode = "content"
                    progressing = True
        return evs

    def _generic_hit(self, pending: str) -> int:
        m = re.search(r'\{\s*"name"\s*:', pending)
        return m.start() if m else -1

    def finish(self) -> list[dict]:
        """Flush: held-back content, and any still-open call's raw args."""
        evs: list[dict] = []
        if self.harmony:
            evs = self._harmony_feed()
            if self.h_state == "body" and self.pos < len(self.buf):
                evs.extend(self._h_body(self.buf[self.pos:]))
                self.pos = len(self.buf)
            return evs
        if self.scoped is not None:
            if self.mode == "scope":
                chunk = self.buf[self.scope_start:]
                content, _ = _parse_scoped(self.plan.fmt, chunk)
                evs.extend(self._emit_scope(chunk))
                if content:
                    evs.append({"ev": "content", "text": content})
            elif self.pos < len(self.buf):
                evs.append({"ev": "content", "text": self.buf[self.pos:]})
            self.pos = len(self.buf)
            return evs
        if self.mode == "call":
            evs.extend(self._events_for_call())
            if self.mode == "call" and self.name_emitted:
                # stream whatever raw args text exists past the last span end
                from .json_partial import object_items
                for key, vs, ve, _ in object_items(self.buf, self.call_start):
                    if key == self.args_key and ve - vs > self.args_emitted:
                        evs.append({"ev": "tc_args", "index": self.index,
                                    "delta": self.buf[vs + self.args_emitted:ve]})
                        self.args_emitted = ve - vs
            self.pos = len(self.buf)
        if self.mode == "content" and self.pos < len(self.buf):
            evs.append({"ev": "content", "text": self.buf[self.pos:]})
            self.pos = len(self.buf)
        return evs


def _coerce(v: str) -> Any:
    """XML parameter value → JSON value when it parses, else raw string
    (the reference coerces against the tool schema; JSON-or-string covers
    the same surface for well-formed outputs)."""
    try:
        return json.loads(v)
    except json.JSONDecodeError:
        return v


def _parse_xml_params(body: str, pat: str) -> dict:
    return {m.group(1): _coerce(m.group(2).strip("\n"))
            for m in re.finditer(pat, body, re.S)}


def _parse_scoped(fmt: str, text: str) -> tuple[str, list[dict]]:
    """content/tool_calls split for the scoped formats (the per-format
    parsers in common/chat.cpp; syntax documented at each branch)."""
    calls: list[dict] = []
    spans: list[tuple[int, int]] = []

    def arr_calls(m, name_key, args_key):
        try:
            items = json.loads(m.group(1))
        except json.JSONDecodeError:
            return
        for it in items if isinstance(items, list) else [items]:
            if isinstance(it, dict) and name_key in it:
                calls.append(_mk_call(it[name_key], it.get(args_key, {})))
        spans.append((m.start(), m.end()))

    if fmt == FORMAT_DEEPSEEK_V31:
        for m in re.finditer(
                r"<｜tool▁call▁begin｜>([\w.\-]+)<｜tool▁sep｜>(.*?)"
                r"<｜tool▁call▁end｜>", text, re.S):
            calls.append(_mk_call(m.group(1), _coerce(m.group(2).strip())))
            spans.append((m.start(), m.end()))
    elif fmt == FORMAT_DEEPSEEK_R1:
        for m in re.finditer(
                r"<｜tool▁call▁begin｜>(?:function<｜tool▁sep｜>)?([\w.\-]+)"
                r"\s*\n```json\n(.*?)```<｜tool▁call▁end｜>", text, re.S):
            calls.append(_mk_call(m.group(1), _coerce(m.group(2).strip())))
        m = re.search(r"<｜tool▁calls▁begin｜>.*?(<｜tool▁calls▁end｜>|$)",
                      text, re.S)
        if m:
            spans.append((m.start(), m.end()))
    elif fmt == FORMAT_COMMAND_R7B:
        for m in re.finditer(
                r"<\|START_ACTION\|>\s*(\[.*?\])\s*(<\|END_ACTION\|>|$)",
                text, re.S):
            arr_calls(m, "tool_name", "parameters")
        r = re.search(r"<\|START_RESPONSE\|>(.*?)(<\|END_RESPONSE\|>|$)",
                      text, re.S)
        if r:
            content = r.group(1)
            return content.strip(), calls
    elif fmt == FORMAT_GRANITE:
        for m in re.finditer(r"<\|tool_call\|>\s*(\[.*?\])\s*$", text, re.S):
            arr_calls(m, "name", "arguments")
        if not spans:  # unterminated array: take everything after the tag
            m = re.search(r"<\|tool_call\|>\s*(\[.*)", text, re.S)
            if m:
                arr_calls(m, "name", "arguments")
    elif fmt == FORMAT_NEMOTRON_V2:
        for m in re.finditer(r"<TOOLCALL>\s*(\[.*?\])\s*(</TOOLCALL>|$)",
                             text, re.S):
            arr_calls(m, "name", "arguments")
    elif fmt == FORMAT_KIMI_K2:
        for m in re.finditer(
                r"<\|tool_call_begin\|>\s*functions\.([\w.\-]+):\d+\s*"
                r"<\|tool_call_argument_begin\|>(.*?)<\|tool_call_end\|>",
                text, re.S):
            calls.append(_mk_call(m.group(1), _coerce(m.group(2).strip())))
        m = re.search(r"<\|tool_calls_section_begin\|>.*?"
                      r"(<\|tool_calls_section_end\|>|$)", text, re.S)
        if m:
            spans.append((m.start(), m.end()))
    elif fmt == FORMAT_GPT_OSS:
        # harmony channels: analysis→reasoning (handled by caller via
        # split), commentary to=functions.N→call, final→content
        content_parts: list[str] = []
        for m in re.finditer(
                r"<\|channel\|>(\w+)(?:\s+to=functions\.([\w.\-]+))?"
                r"(?:\s*<\|constrain\|>\w+)?<\|message\|>(.*?)"
                r"(?=<\|end\|>|<\|call\|>|<\|channel\|>|<\|start\|>|$)",
                text, re.S):
            ch, fn, body = m.group(1), m.group(2), m.group(3)
            if fn:
                calls.append(_mk_call(fn, _coerce(body.strip())))
            elif ch == "final":
                content_parts.append(body)
        if re.search(r"<\|channel\|>", text):
            return "".join(content_parts).strip(), calls
        return text.strip(), calls
    elif fmt == FORMAT_GLM45:
        for m in re.finditer(r"<tool_call>\s*([\w.\-]+)\s*\n(.*?)</tool_call>",
                             text, re.S):
            args = _parse_xml_params(
                m.group(2), r"<arg_key>(.*?)</arg_key>\s*"
                            r"<arg_value>(.*?)</arg_value>")
            calls.append(_mk_call(m.group(1), args))
            spans.append((m.start(), m.end()))
    elif fmt in (FORMAT_QWEN3_CODER, FORMAT_SEED_OSS):
        tag = ("tool_call" if fmt == FORMAT_QWEN3_CODER
               else "seed:tool_call")
        for m in re.finditer(
                rf"<{tag}>\s*<function=([\w.\-]+)>(.*?)</function>\s*"
                rf"</{tag}>", text, re.S):
            args = _parse_xml_params(
                m.group(2), r"<parameter=([\w.\-]+)>(.*?)</parameter>")
            calls.append(_mk_call(m.group(1), args))
            spans.append((m.start(), m.end()))
    elif fmt == FORMAT_LFM2:
        for m in re.finditer(
                r"<\|tool_call_start\|>\s*(\[.*?\])\s*(<\|tool_call_end\|>|$)",
                text, re.S):
            arr_calls(m, "name", "arguments")
    elif fmt == FORMAT_MIMO:
        for m in re.finditer(r"<tool_calls>\s*(\[.*?\])\s*(</tool_calls>|$)",
                             text, re.S):
            arr_calls(m, "name", "arguments")
    elif fmt == FORMAT_FIREFUNCTION:
        for m in re.finditer(r" functools\s*(\[.*?\])\s*$", text, re.S):
            arr_calls(m, "name", "arguments")
    elif fmt == FORMAT_APERTUS:
        for m in re.finditer(
                r"<\|tools_prefix\|>\s*(\[.*?\])\s*(<\|tools_suffix\|>|$)",
                text, re.S):
            try:
                items = json.loads(m.group(1))
            except json.JSONDecodeError:
                continue
            for it in items if isinstance(items, list) else [items]:
                if isinstance(it, dict):
                    for k, v in it.items():   # {NAME: args} items
                        calls.append(_mk_call(k, v))
            spans.append((m.start(), m.end()))
    elif fmt == FORMAT_FUNCTIONARY_V32:
        # name\n{args} segments separated by >>>; "all" segment = content
        content_parts = []
        for seg in re.split(r">>>", text):
            if not seg.strip():
                continue
            head, _, body = seg.partition("\n")
            name = head.strip()
            if name == "all" or not re.fullmatch(r"[\w.\-]+", name or " "):
                content_parts.append(body if name == "all" else seg)
            else:
                calls.append(_mk_call(name, _coerce(body.strip())))
        return "".join(content_parts).strip(), calls
    elif fmt == FORMAT_MINIMAX_M2:
        for m in re.finditer(
                r'<invoke name="([\w.\-]+)">(.*?)</invoke>', text, re.S):
            args = _parse_xml_params(
                m.group(2), r'<parameter name="([\w.\-]+)">(.*?)</parameter>')
            calls.append(_mk_call(m.group(1), args))
        m = re.search(r"<minimax:tool_call>.*?(</minimax:tool_call>|$)",
                      text, re.S)
        if m:
            spans.append((m.start(), m.end()))

    content = text
    strip_pats = {
        FORMAT_COMMAND_R7B: r"<\|START_ACTION\|>.*?(<\|END_ACTION\|>|$)",
        FORMAT_GRANITE: r"<\|tool_call\|>.*$",
        FORMAT_NEMOTRON_V2: r"<TOOLCALL>.*?(</TOOLCALL>|$)",
        FORMAT_LFM2: r"<\|tool_call_start\|>.*?(<\|tool_call_end\|>|$)",
        FORMAT_MIMO: r"<tool_calls>.*?(</tool_calls>|$)",
        FORMAT_FIREFUNCTION: r" functools\s*\[.*$",
    }
    if fmt in strip_pats:
        # array formats: strip the tagged block(s)
        content = re.sub(strip_pats[fmt], "", content, flags=re.S)
    else:
        for s, e in sorted(spans, reverse=True):
            content = content[:s] + content[e:]
    return content.strip(), calls


def parse_tool_calls(plan: ToolPlan, text: str) -> tuple[str, list[dict]]:
    """Split generated text into (content, tool_calls)."""
    calls: list[dict] = []
    content = text

    if plan.fmt in _SCOPED:
        return _parse_scoped(plan.fmt, text)
    if plan.fmt == FORMAT_HERMES:
        spans = []
        for m in re.finditer(r"<tool_call>\s*(.*?)\s*(</tool_call>|$)", text, re.S):
            try:
                obj = json.loads(m.group(1))
                calls.append(_mk_call(obj["name"], obj.get("arguments", {})))
                spans.append((m.start(), m.end()))
            except (json.JSONDecodeError, KeyError):
                continue
        for s, e in reversed(spans):
            content = content[:s] + content[e:]
    elif plan.fmt == FORMAT_MISTRAL:
        m = re.search(r"\[TOOL_CALLS\]\s*", text)
        if m:
            for val, _, _ in _json_objects(text[m.end():]):
                items = val if isinstance(val, list) else [val]
                for it in items:
                    if isinstance(it, dict) and "name" in it:
                        calls.append(_mk_call(it["name"], it.get("arguments", {})))
                break
            content = text[:m.start()]
    else:  # llama3 + generic: bare JSON object(s) with name/arguments|parameters
        args_key = "parameters" if plan.fmt == FORMAT_LLAMA3 else "arguments"
        spans = []
        for val, s, e in _json_objects(text):
            items = val if isinstance(val, list) else [val]
            got = False
            for it in items:
                if isinstance(it, dict) and "name" in it and \
                        (args_key in it or "arguments" in it):
                    calls.append(_mk_call(
                        it["name"], it.get(args_key, it.get("arguments", {}))))
                    got = True
            if got:
                spans.append((s, e))
        for s, e in reversed(spans):
            content = content[:s] + content[e:]

    return content.strip(), calls


class ReasoningStream:
    """Incremental leading-reasoning splitter (the streaming side of
    split_reasoning): feed(piece) → [(kind, text)] with kind
    'reasoning' | 'content'. Only blocks at the start of the generation
    (possibly several, whitespace-separated) count as reasoning."""

    def __init__(self, forced_open: bool = False):
        self.buf = ""
        self.state = "start"     # start | inside | content
        self.close = ""
        if forced_open:
            # the PROMPT already opened a <think> block (deepseek-r1-style
            # templates end with it): generation starts inside reasoning
            self.state = "inside"
            self.close = "</think>"

    def _feed_start(self, out):
        stripped = self.buf.lstrip()
        for open_m, close_m in _REASONING_MARKS:
            if stripped.startswith(open_m):
                self.buf = stripped[len(open_m):]
                self.close = close_m
                self.state = "inside"
                return True
            if open_m.startswith(stripped):
                return False        # still ambiguous: hold
        self.state = "content"
        return True

    def feed(self, piece: str) -> list[tuple[str, str]]:
        self.buf += piece
        out: list[tuple[str, str]] = []
        progressing = True
        while progressing and self.buf:
            progressing = False
            if self.state == "start":
                progressing = self._feed_start(out)
            elif self.state == "inside":
                end = self.buf.find(self.close)
                if end >= 0:
                    if self.buf[:end]:
                        out.append(("reasoning", self.buf[:end]))
                    self.buf = self.buf[end + len(self.close):]
                    self.state = "start"   # allow stacked leading blocks
                    progressing = True
                else:
                    # hold back a potential close-marker prefix
                    keep = 0
                    for k in range(min(len(self.close) - 1, len(self.buf)),
                                   0, -1):
                        if self.close.startswith(self.buf[-k:]):
                            keep = k
                            break
                    emit = self.buf[: len(self.buf) - keep]
                    if emit:
                        out.append(("reasoning", emit))
                        self.buf = self.buf[len(emit):]
            else:
                out.append(("content", self.buf))
                self.buf = ""
        return out

    def finish(self) -> list[tuple[str, str]]:
        if not self.buf:
            return []
        kind = "reasoning" if self.state == "inside" else "content"
        out = [(kind, self.buf)]
        self.buf = ""
        return out
