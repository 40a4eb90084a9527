"""Chat template application (counterpart of common/chat.cpp + minja: the GGUF
``tokenizer.chat_template`` jinja string applied to OpenAI-style messages;
built-in fallbacks + content-based detection mirror src/llama-chat.cpp's
template zoo for models without embedded templates)."""

from __future__ import annotations

import json
from typing import Any

import jinja2

_ENV = jinja2.Environment(loader=jinja2.BaseLoader(), keep_trailing_newline=True)
_ENV.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(jinja2.TemplateError(msg))
_ENV.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
_ENV.policies["json.dumps_kwargs"] = {"ensure_ascii": False}

# built-in fallback templates (formats from src/llama-chat.cpp's zoo)
BUILTIN_TEMPLATES = {
    "chatml": (
        "{% for message in messages %}"
        "<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
        "{% endfor %}"
        "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
    ),
    "llama2": (
        "{% for message in messages %}"
        "{% if message.role == 'system' %}[INST] <<SYS>>\n{{ message.content }}\n<</SYS>>\n\n"
        "{% elif message.role == 'user' %}{% if loop.first or messages[loop.index0-1].role != 'system' %}[INST] {% endif %}{{ message.content }} [/INST]"
        "{% elif message.role == 'assistant' %} {{ message.content }} </s>"
        "{% endif %}{% endfor %}"
    ),
    "llama3": (
        "{% for message in messages %}"
        "<|start_header_id|>{{ message.role }}<|end_header_id|>\n\n{{ message.content }}<|eot_id|>"
        "{% endfor %}"
        "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}"
    ),
    "mistral-v3": (
        "{% for message in messages %}"
        "{% if message.role == 'user' %}[INST] {{ message.content }}[/INST]"
        "{% elif message.role == 'assistant' %} {{ message.content }}</s>"
        "{% endif %}{% endfor %}"
    ),
    "mistral-v7": (
        "{% for message in messages %}"
        "{% if message.role == 'system' %}[SYSTEM_PROMPT] {{ message.content }}[/SYSTEM_PROMPT]"
        "{% elif message.role == 'user' %}[INST] {{ message.content }}[/INST]"
        "{% else %} {{ message.content }}</s>{% endif %}{% endfor %}"
    ),
    "gemma": (
        "{% for message in messages %}"
        "<start_of_turn>{{ 'model' if message.role == 'assistant' else 'user' }}\n"
        "{{ message.content }}<end_of_turn>\n{% endfor %}"
        "{% if add_generation_prompt %}<start_of_turn>model\n{% endif %}"
    ),
    "phi3": (
        "{% for message in messages %}"
        "<|{{ message.role }}|>\n{{ message.content }}<|end|>\n{% endfor %}"
        "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
    ),
    "zephyr": (
        "{% for message in messages %}"
        "<|{{ message.role }}|>\n{{ message.content }}<|endoftext|>\n{% endfor %}"
        "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
    ),
    "deepseek3": (
        "{% for message in messages %}"
        "{% if message.role == 'system' %}{{ message.content }}\n\n"
        "{% elif message.role == 'user' %}<｜User｜>{{ message.content }}"
        "{% else %}<｜Assistant｜>{{ message.content }}<｜end▁of▁sentence｜>{% endif %}"
        "{% endfor %}"
        "{% if add_generation_prompt %}<｜Assistant｜>{% endif %}"
    ),
    "command-r": (
        "{% for message in messages %}"
        "<|START_OF_TURN_TOKEN|>{% if message.role == 'system' %}<|SYSTEM_TOKEN|>"
        "{% elif message.role == 'user' %}<|USER_TOKEN|>{% else %}<|CHATBOT_TOKEN|>{% endif %}"
        "{{ message.content }}<|END_OF_TURN_TOKEN|>{% endfor %}"
        "{% if add_generation_prompt %}<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>{% endif %}"
    ),
    "falcon3": (
        "{% for message in messages %}"
        "<|{{ message.role }}|>\n{{ message.content }}\n{% endfor %}"
        "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
    ),
    "vicuna": (
        "{% for message in messages %}"
        "{% if message.role == 'system' %}{{ message.content }}\n\n"
        "{% elif message.role == 'user' %}USER: {{ message.content }}\n"
        "{% else %}ASSISTANT: {{ message.content }}</s>\n{% endif %}{% endfor %}"
        "{% if add_generation_prompt %}ASSISTANT:{% endif %}"
    ),
    "openchat": (
        "{% for message in messages %}"
        "GPT4 Correct {{ message.role | capitalize }}: {{ message.content }}<|end_of_turn|>"
        "{% endfor %}"
        "{% if add_generation_prompt %}GPT4 Correct Assistant:{% endif %}"
    ),
    "granite": (
        "{% for message in messages %}"
        "<|start_of_role|>{{ message.role }}<|end_of_role|>{{ message.content }}<|end_of_text|>\n"
        "{% endfor %}"
        "{% if add_generation_prompt %}<|start_of_role|>assistant<|end_of_role|>{% endif %}"
    ),
    "glm4": (
        "[gMASK]<sop>{% for message in messages %}"
        "<|{{ message.role }}|>\n{{ message.content }}{% endfor %}"
        "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
    ),
    "minicpm": (
        "{% for message in messages %}"
        "{% if message.role == 'user' %}<用户>{{ message.content }}<AI>"
        "{% else %}{{ message.content }}{% endif %}{% endfor %}"
    ),
}

# marker substring → builtin key (llm_chat_detect_template counterpart:
# detection by distinctive tokens in the embedded template or model name)
_DETECT = [
    ("<|im_start|>", "chatml"),
    ("<|start_header_id|>", "llama3"),
    ("[SYSTEM_PROMPT]", "mistral-v7"),
    ("<<SYS>>", "llama2"),
    ("[INST]", "mistral-v3"),
    ("<start_of_turn>", "gemma"),
    ("<|end|>", "phi3"),
    ("<|endoftext|>", "zephyr"),
    ("<｜User｜>", "deepseek3"),
    ("<|START_OF_TURN_TOKEN|>", "command-r"),
    ("<|start_of_role|>", "granite"),
    ("[gMASK]", "glm4"),
    ("<|end_of_turn|>", "openchat"),
    ("<用户>", "minicpm"),
    ("USER:", "vicuna"),
]


def detect_builtin(template_text: str | None) -> str:
    """Pick the closest builtin format for a template string (or chatml)."""
    if template_text:
        for marker, key in _DETECT:
            if marker in template_text:
                return key
    return "chatml"


class ChatTemplate:
    def __init__(self, template: str | None = None, fallback: str = "chatml",
                 bos_token: str = "", eos_token: str = ""):
        self.source = template or BUILTIN_TEMPLATES[fallback]
        self._tmpl = _ENV.from_string(self.source)
        self.bos_token = bos_token
        self.eos_token = eos_token

    def apply(self, messages: list[dict[str, Any]],
              add_generation_prompt: bool = True,
              tools: list[dict] | None = None, **extra) -> str:
        # native pass first: modern templates render role="tool" and
        # message.tool_calls themselves (common_chat_templates_apply) —
        # only flatten those shapes when the template can't
        for msgs in ([_flatten_content(m) for m in messages],
                     [_normalize_message(m) for m in messages]):
            try:
                return self._tmpl.render(
                    messages=msgs,
                    add_generation_prompt=add_generation_prompt,
                    bos_token=self.bos_token,
                    eos_token=self.eos_token,
                    tools=tools,
                    **extra,
                )
            except jinja2.TemplateError:
                continue
        # template can't handle this message shape (e.g. tools): degrade
        # to the detected builtin with tools described in the system turn
        msgs = [_normalize_message(m) for m in messages]
        fb = ChatTemplate(None, fallback=detect_builtin(self.source),
                          bos_token=self.bos_token, eos_token=self.eos_token)
        if tools:
            msgs = _inject_tools_system(msgs, tools)
        return fb._tmpl.render(messages=msgs,
                               add_generation_prompt=add_generation_prompt,
                               bos_token=self.bos_token,
                               eos_token=self.eos_token)


def _flatten_content(m: dict) -> dict:
    """Minimal normalization: OpenAI content-parts → text, None → ""; tool
    roles and tool_calls pass through for native template rendering.
    tool_call arguments are parsed to objects (templates tojson them)."""
    out = dict(m)
    c = m.get("content")
    if isinstance(c, list):
        out["content"] = "".join(
            p.get("text", "") for p in c if isinstance(p, dict))
    elif c is None:
        out["content"] = ""
    if m.get("tool_calls"):
        tcs = []
        for tc in m["tool_calls"]:
            tc = dict(tc)
            fn = dict(tc.get("function", {}))
            if isinstance(fn.get("arguments"), str):
                try:
                    fn["arguments"] = json.loads(fn["arguments"])
                except json.JSONDecodeError:
                    pass
            tc["function"] = fn
            tcs.append(tc)
        out["tool_calls"] = tcs
    return out


def _normalize_message(m: dict) -> dict:
    """Flatten OpenAI content-parts and tool-result messages to plain text."""
    out = dict(m)
    c = m.get("content")
    if isinstance(c, list):
        out["content"] = "".join(
            p.get("text", "") for p in c if isinstance(p, dict))
    elif c is None:
        out["content"] = ""
    if m.get("role") == "assistant" and m.get("tool_calls") and not out["content"]:
        out["content"] = json.dumps([tc.get("function", tc)
                                     for tc in m["tool_calls"]])
    if m.get("role") == "tool":
        name = m.get("name", "tool")
        out["role"] = "user"
        out["content"] = f"<tool_response name={name}>{out['content']}</tool_response>"
    return out


def _inject_tools_system(msgs: list[dict], tools: list[dict]) -> list[dict]:
    desc = ("You have access to the following tools. To call a tool, respond "
            "with a JSON object {\"name\": <tool>, \"arguments\": {...}}.\n"
            + json.dumps(tools, indent=2))
    if msgs and msgs[0].get("role") == "system":
        msgs = [dict(msgs[0], content=msgs[0]["content"] + "\n\n" + desc)] + msgs[1:]
    else:
        msgs = [{"role": "system", "content": desc}] + msgs
    return msgs


def template_for_model(model) -> ChatTemplate:
    """Build a ChatTemplate from a LoadedModel's GGUF metadata."""
    tok = model.tokenizer
    tmpl = model.metadata.get("tokenizer.chat_template")
    bos = eos = ""
    if tok is not None:
        v = tok.vocab
        bos = v.tokens[v.bos_id] if v.bos_id >= 0 else ""
        eos = v.tokens[v.eos_id] if v.eos_id >= 0 else ""
    try:
        return ChatTemplate(tmpl, bos_token=bos, eos_token=eos)
    except jinja2.TemplateError:
        return ChatTemplate(None, fallback=detect_builtin(tmpl),
                            bos_token=bos, eos_token=eos)
