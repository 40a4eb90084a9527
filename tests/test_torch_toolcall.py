"""The port's tool-call planning and parsing, reasoning splitting and
partial-JSON scanning against the JAX package's, on the same inputs (pure
Python; no model):

 - ``detect_format`` and ``plan_tools`` (grammar, triggers, extra stops,
   forced, lazy, tool names) for every format ``detect_format`` knows, with
   ``tool_choice`` auto, required and named; every plan's grammar parses;
 - ``parse_tool_calls`` and ``StreamingToolCallParser`` fed in chunks of 1
   and 3 characters and whole, over the corpus of
   ``tests/test_toolcall_stream.py``, tool call ids excluded (they are
   random);
 - ``split_reasoning`` and ``ReasoningStream``, with and without a forced
   open ``<think>``;
 - ``scan_value``, ``parse_partial`` and ``object_items`` of
   ``json_partial``.
"""

import dataclasses

import pytest

from superllama_tpu.server import json_partial as jjp
from superllama_tpu.server import toolcall as jtc
from superllama_tpu_torch.grammar.gbnf import parse_gbnf
from superllama_tpu_torch.server import json_partial as tjp
from superllama_tpu_torch.server import toolcall as ttc

TOOLS = [{"type": "function",
          "function": {"name": "get_weather",
                       "parameters": {"type": "object",
                                      "properties": {"city": {"type": "string"}},
                                      "required": ["city"]}}},
         {"type": "function",
          "function": {"name": "add",
                       "parameters": {"type": "object",
                                      "properties": {"a": {"type": "number"},
                                                     "b": {"type": "number"}}}}}]

# a template text detect_format maps to each format
TEMPLATES = {
    "generic": "{{ messages }}",
    "hermes": "<|im_start|>{{ messages }}<tool_call></tool_call>",
    "llama3": "<|start_header_id|>{{ messages }}",
    "mistral": "[TOOL_CALLS]{{ messages }}",
    "deepseek-r1": "...<｜tool▁calls▁begin｜>...",
    "command-r7b": "<|END_THINKING|><|START_ACTION|>",
    "granite": "{% elif thinking %}<|tool_call|>",
    "glm-4.5": "[gMASK]<sop><arg_key><arg_value>",
    "qwen3-coder": "<function=..><parameter=..>",
    "gpt-oss": "<|channel|>analysis",
    "seed-oss": "<seed:think>",
    "nemotron-v2": "<SPECIAL_10>",
    "kimi-k2": "<|tool_calls_section_begin|>",
    "minimax-m2": "<minimax:tool_call>",
    "lfm2": "List of tools: <|tool_list_start|>[...]<|tool_list_end|>",
    "apertus": "<|tools_prefix|>",
    "tool-calls-array": "<tool_calls>[...]</tool_calls>",
    "functionary-v3.2": "... >>>all ...",
    "firefunction-v2": "x functools[ y",
    "deepseek-v3.1": "x message['prefix'] is defined and message['prefix'] and thinking y",
}
CHOICES = {"auto": "auto", "required": "required",
           "named": {"type": "function", "function": {"name": "add"}}}


@pytest.mark.parametrize("choice", list(CHOICES))
@pytest.mark.parametrize("fmt", list(TEMPLATES))
def test_plan_tools_matches_jax(fmt, choice):
    tmpl = TEMPLATES[fmt]
    assert ttc.detect_format(tmpl) == jtc.detect_format(tmpl) == fmt
    body = {"tools": TOOLS, "tool_choice": CHOICES[choice]}
    got, ref = ttc.plan_tools(body, tmpl), jtc.plan_tools(body, tmpl)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.forced == (choice != "auto") and got.grammar_lazy == (choice == "auto")
    parse_gbnf(got.grammar)


def test_no_plan_without_tools():
    for mod in (ttc, jtc):
        assert mod.plan_tools({}, TEMPLATES["hermes"]) is None
        assert mod.plan_tools({"tools": TOOLS, "tool_choice": "none"}, None) is None


# (format, generated text): the corpus of tests/test_toolcall_stream.py
CORPUS = {
    "hermes": ("hermes", 'Let me check. <tool_call>{"name": "get_weather", "arguments": '
               '{"city": "Par\\"is"}}</tool_call> done'),
    "hermes2": ("hermes", '<tool_call>{"name": "add", "arguments": {"a": 1, "b": 2.5}}'
                '</tool_call><tool_call>{"name": "get_weather", "arguments": '
                '{"city": "Oslo"}}</tool_call>'),
    "hermes_truncated": ("hermes", '<tool_call>{"name": "get_weather", "arguments": '
                         '{"city": "Pa'),
    "hermes_holdback": ("hermes", 'hello <tool_call>{"name": "add", "arguments": {}}'
                        "</tool_call>"),
    "mistral": ("mistral", 'Sure. [TOOL_CALLS][{"name": "add", "arguments": {"a": 3, "b": 4}}, '
                '{"name": "get_weather", "arguments": {"city": "Rome"}}]'),
    "generic": ("generic", '{"name": "get_weather", "arguments": {"city": "Lima"}}'),
    "generic_brace": ("generic", "The set {1, 2} has two elements."),
    "llama3": ("llama3", '{"name": "add", "parameters": {"a": 1}}'),
    "deepseek-r1": ("deepseek-r1",
                    "ok<｜tool▁calls▁begin｜><｜tool▁call▁begin｜>function<｜tool▁sep｜>"
                    "get_weather\n```json\n{\"city\": \"Paris\"}\n```<｜tool▁call▁end｜>"
                    "<｜tool▁calls▁end｜>"),
    "command-r7b": ("command-r7b", '<|START_ACTION|>[{"tool_call_id": "0", "tool_name": "ping", '
                    '"parameters": {"host": "a"}}]<|END_ACTION|>'),
    "granite": ("granite", 'sure<|tool_call|>[{"name": "f", "arguments": {"x": 1}}]'),
    "nemotron-v2": ("nemotron-v2", 'hello <TOOLCALL>[{"name": "f", "arguments": {"x": 1}}]'
                    "</TOOLCALL> bye"),
    "kimi-k2": ("kimi-k2", "<|tool_calls_section_begin|><|tool_call_begin|>functions.add:0"
                "<|tool_call_argument_begin|>{\"a\": 1, \"b\": 2}<|tool_call_end|>"
                "<|tool_calls_section_end|>"),
    "gpt-oss": ("gpt-oss", "<|channel|>analysis<|message|>thinking hard<|end|>"
                "<|start|>assistant<|channel|>commentary to=functions.run"
                " <|constrain|>json<|message|>{\"cmd\": \"ls\"}<|call|>"
                "<|start|>assistant<|channel|>final<|message|>all done"),
    "glm-4.5": ("glm-4.5", "<tool_call>search\n<arg_key>q</arg_key>\n<arg_value>cats"
                "</arg_value>\n</tool_call>"),
    "qwen3-coder": ("qwen3-coder", "go <tool_call>\n<function=run>\n<parameter=cmd>\nls\n"
                    "</parameter>\n</function>\n</tool_call> done"),
    "minimax-m2": ("minimax-m2", '<minimax:tool_call>\n<invoke name="go">\n'
                   '<parameter name="dir">up</parameter>\n</invoke>\n</minimax:tool_call>'),
    "seed-oss": ("seed-oss", "<seed:tool_call>\n<function=f>\n<parameter=k>v</parameter>\n"
                 "</function>\n</seed:tool_call>"),
    "lfm2": ("lfm2", '<|tool_call_start|>[{"name": "f", "arguments": {"x": 1}}]'
             "<|tool_call_end|>ok"),
    "tool-calls-array": ("tool-calls-array",
                         'pre<tool_calls>[{"name": "g", "arguments": {}}]</tool_calls>'),
    "firefunction-v2": ("firefunction-v2",
                        'sure functools[{"name": "h", "arguments": {"q": "x"}}]'),
    "apertus": ("apertus", '<|tools_prefix|>[{"ping": {"host": "a"}}]<|tools_suffix|>'),
    "functionary-v3.2": ("functionary-v3.2", 'all\nHere you go>>>get_weather\n{"city": "Oslo"}'),
    "deepseek-v3.1": ("deepseek-v3.1", "sure<｜tool▁call▁begin｜>get_time<｜tool▁sep｜>"
                      "{\"tz\": \"UTC\"}<｜tool▁call▁end｜>"),
}


def _plans(fmt: str):
    """The port's and the JAX plan of a format, from a request with TOOLS."""
    body = {"tools": TOOLS}
    return ttc.plan_tools(body, TEMPLATES[fmt]), jtc.plan_tools(body, TEMPLATES[fmt])


def _no_ids(calls: list[dict]) -> list[dict]:
    assert all(c["id"].startswith("call_") for c in calls)
    return [{k: v for k, v in c.items() if k != "id"} for c in calls]


@pytest.mark.parametrize("case", list(CORPUS))
def test_parse_tool_calls_matches_jax(case):
    fmt, text = CORPUS[case]
    plan, jplan = _plans(fmt)
    content, calls = ttc.parse_tool_calls(plan, text)
    jcontent, jcalls = jtc.parse_tool_calls(jplan, text)
    assert content == jcontent
    assert _no_ids(calls) == _no_ids(jcalls)


def _stream(mod, plan, text: str, chunk: int) -> list[dict]:
    p = mod.StreamingToolCallParser(plan)
    evs = []
    step = chunk or len(text)
    for i in range(0, len(text), step):
        evs += p.feed(text[i:i + step])
    evs += p.finish()
    return [{k: v for k, v in e.items() if k != "id"} for e in evs]


@pytest.mark.parametrize("chunk", [1, 3, 0], ids=["chunk1", "chunk3", "whole"])
@pytest.mark.parametrize("case", list(CORPUS))
def test_stream_matches_jax(case, chunk):
    fmt, text = CORPUS[case]
    plan, jplan = _plans(fmt)
    assert _stream(ttc, plan, text, chunk) == _stream(jtc, jplan, text, chunk)


REASONING = [
    ("<think>plan</think>answer", False),
    ("<think>unclosed ...", False),
    ("no reasoning here", False),
    ("[THINK]deep[/THINK]out", False),
    ("already thinking</think>answer", True),
    ("<seed:think>s</seed:think>rest", False),
    ("  <think>\nmulti\nline\n</think>\n\ntail", False),
]


@pytest.mark.parametrize("chunk", [1, 3, 0], ids=["chunk1", "chunk3", "whole"])
@pytest.mark.parametrize("text,forced", REASONING, ids=[str(i) for i in range(len(REASONING))])
def test_reasoning_matches_jax(text, forced, chunk):
    assert (ttc.split_reasoning(text, forced_open=forced)
            == jtc.split_reasoning(text, forced_open=forced))
    runs = []
    for mod in (ttc, jtc):
        rs = mod.ReasoningStream(forced_open=forced)
        step = chunk or len(text)
        evs = []
        for i in range(0, len(text), step):
            evs += rs.feed(text[i:i + step])
        runs.append(evs + rs.finish())
    assert runs[0] == runs[1]


PARTIAL = ['{"a": 1}', '{"a": 1', '{"a": "x', "[1, 2, 3]", "[1, 2,", '"hello"', '"hel',
           "tru", "true", "12.5e3", "12.5 ", '{"a": {"c": [1, 2', '{"a": "he\\nl',
           '{"a": "x\\\\', '[{"k": 1}, {"k": 2', '{"name": "f", "arguments": {"x": [1, 2']


@pytest.mark.parametrize("doc", PARTIAL, ids=[str(i) for i in range(len(PARTIAL))])
def test_json_partial_matches_jax(doc):
    assert tjp.scan_value(doc, 0) == jjp.scan_value(doc, 0)
    assert tjp.parse_partial(doc) == jjp.parse_partial(doc)
    if doc.startswith("{"):
        assert list(tjp.object_items(doc, 0)) == list(jjp.object_items(doc, 0))
