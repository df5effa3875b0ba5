"""OpenAI wire protocol: request validation + response/SSE shapes (port
of `solvingpapers_tpu/serve/openai.py`).

Pure JSON-dict mapping, no HTTP and no engine — `serve/api.py` owns the
sockets and threads, this module owns the contract: what a
`/v1/completions` / `/v1/chat/completions` body means, how it maps onto
`Request` + `SamplingParams`, and what the response objects (full and
streamed chunk) look like. Keeping it transport-free makes every
validation rule unit-testable without opening a port.

Errors raise `ApiError`, which carries the HTTP status and renders the
OpenAI error envelope::

    {"error": {"message": ..., "type": ..., "param": ..., "code": ...}}

`submit`-side `ValueError`s (prompt too long, top_k over the cap, ...)
are wrapped into the same envelope by the front door, so every client
failure mode is a structured 400/503 — never a traceback over a socket.

Prompts may be a string (tokenized by the server's `encode`) or a list
of token ids (the raw-id path the bench and token-exactness tests use —
the OpenAI completions API allows token arrays too). Chat messages are
flattened by `chat_prompt` (a minimal ``role: content`` template — the
char-level bench models have no chat template to honor).

`response_format {"type": "json_object"}` attaches a
`serve.grammar.JsonStepper` built over the server's token table; a
vocabulary that cannot express JSON yields a structured 400.
"""

from __future__ import annotations

import time

from solvingpapers_tpu_torch.serve.sampling import SamplingParams

# OpenAI finish_reason values; engine reasons outside the standard set
# ("timeout") pass through as extensions — a client that only switches
# on "stop"/"length" treats them as an unknown terminal state, which is
# exactly what they are. "error" maps EXPLICITLY (not by fallthrough):
# it is the engine's failure-isolation contract — a quarantined or
# engine-failed stream ends with finish_reason "error" plus a
# structured error event (see `error_event` and serve/api.py's SSE
# error protocol), never a silently dropped connection.
_FINISH_MAP = {"eos": "stop", "stop": "stop", "length": "length",
               "error": "error"}


class ApiError(Exception):
    """Structured client error -> OpenAI error envelope + HTTP status."""

    def __init__(self, message: str, status: int = 400,
                 err_type: str = "invalid_request_error",
                 param: str | None = None, code: str | None = None):
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.param = param
        self.code = code

    def body(self) -> dict:
        return {
            "error": {
                "message": str(self),
                "type": self.err_type,
                "param": self.param,
                "code": self.code,
            }
        }


def finish_reason(engine_reason: str | None) -> str | None:
    if engine_reason is None:
        return None
    return _FINISH_MAP.get(engine_reason, engine_reason)


def error_event(message: str, err_type: str = "server_error",
                code: str | None = "engine_error") -> dict:
    """Mid-stream SSE error payload: the OpenAI error envelope as a
    `data:` event. Sent when a stream that already holds a 200 + SSE
    headers fails server-side (engine quarantine, engine-loop death, a
    rendering bug) — the client gets a STRUCTURED terminal error, then
    the finish chunk with ``finish_reason: "error"`` and ``[DONE]``,
    instead of a connection that just drops."""
    return {
        "error": {
            "message": message,
            "type": err_type,
            "param": None,
            "code": code,
        }
    }


def _field(body: dict, name: str, types, default, param=None):
    val = body.get(name, default)
    if val is default:
        return default
    if not isinstance(val, types) or isinstance(val, bool) and bool not in (
        types if isinstance(types, tuple) else (types,)
    ):
        raise ApiError(
            f"{name} must be {getattr(types, '__name__', types)}, got "
            f"{type(val).__name__}", param=param or name,
        )
    return val


def parse_sampling(body: dict) -> tuple[SamplingParams, int, float | None]:
    """The sampling-relevant fields of a completion/chat body ->
    (SamplingParams, max_tokens, timeout_s). OpenAI defaults:
    temperature 1.0 (pass 0 for greedy), top_p 1.0, max_tokens 16.
    `top_k` / `min_p` / `timeout_s` are accepted extensions (vLLM serves
    them). The reference's `slo` class tag needs SLO accounting, which
    the port does not serve yet (ROADMAP A4): a body that sets it is
    refused, as the reference refuses it on a server without SLO classes;
    OpenAI's `service_tier` is ignored, as there."""
    if _field(body, "n", int, 1) != 1:
        raise ApiError("only n=1 is supported", param="n")
    if _field(body, "best_of", int, 1) != 1:
        raise ApiError("only best_of=1 is supported", param="best_of")
    if body.get("echo"):
        raise ApiError("echo is not supported", param="echo")
    max_tokens = _field(body, "max_tokens", int, 16)
    lp = body.get("logprobs")
    if lp not in (None, False, True, 0, 1):
        raise ApiError(
            "only the chosen token's logprob is available (logprobs must "
            "be null, 0 or 1)", param="logprobs",
        )
    stop = body.get("stop")
    if stop is None:
        stop = ()
    elif isinstance(stop, str):
        stop = (stop,)
    elif isinstance(stop, list) and all(isinstance(s, str) for s in stop):
        stop = tuple(stop)
    else:
        raise ApiError("stop must be a string or a list of strings",
                       param="stop")
    if len(stop) > 4:
        raise ApiError("at most 4 stop sequences are supported",
                       param="stop")
    timeout_s = body.get("timeout_s")
    if timeout_s is not None and (
        not isinstance(timeout_s, (int, float)) or timeout_s <= 0
    ):
        raise ApiError("timeout_s must be a positive number",
                       param="timeout_s")
    seed = body.get("seed")
    if seed is not None and not isinstance(seed, int):
        raise ApiError("seed must be an integer", param="seed")
    if body.get("slo") is not None:
        raise ApiError("SLO classes are not served here (no SLO "
                       "accounting on this server)", param="slo")
    try:
        params = SamplingParams(
            temperature=float(_field(body, "temperature", (int, float), 1.0)),
            top_p=float(_field(body, "top_p", (int, float), 1.0)),
            top_k=_field(body, "top_k", int, 0),
            min_p=float(_field(body, "min_p", (int, float), 0.0)),
            seed=seed,
            max_tokens=max_tokens,
            stop=stop,
            logprobs=bool(lp),
        )
    except ValueError as e:
        raise ApiError(str(e)) from None
    return params, max_tokens, timeout_s


def wants_json(body: dict, json_mode_ok: bool) -> bool:
    """Interpret `response_format`; 400 on unknown types or when the
    server has json_mode disabled."""
    fmt = body.get("response_format")
    if fmt is None:
        return False
    if not isinstance(fmt, dict) or fmt.get("type") not in (
        "text", "json_object"
    ):
        raise ApiError(
            'response_format must be {"type": "text"} or '
            '{"type": "json_object"}', param="response_format",
        )
    if fmt["type"] == "text":
        return False
    if not json_mode_ok:
        raise ApiError(
            "json_object mode is disabled on this server "
            "(ServeConfig.json_mode)", param="response_format",
        )
    return True


def parse_prompt(body: dict, encode, vocab_size: int):
    """`prompt` -> 1-D int token id list. Strings go through the
    server's `encode`; token-id arrays pass through validated (the
    OpenAI completions API accepts both)."""
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        if encode is None:
            raise ApiError(
                "this server has no tokenizer: send the prompt as a "
                "list of token ids", param="prompt",
            )
        try:
            return [int(t) for t in encode(prompt)]
        except KeyError as e:
            raise ApiError(
                f"prompt contains characters outside the model's "
                f"vocabulary: {e}", param="prompt",
            ) from None
    if isinstance(prompt, list) and prompt and all(
        isinstance(t, int) and not isinstance(t, bool) for t in prompt
    ):
        bad = [t for t in prompt if not 0 <= t < vocab_size]
        if bad:
            raise ApiError(
                f"prompt token ids out of range [0, {vocab_size}): "
                f"{bad[:5]}", param="prompt",
            )
        return prompt
    raise ApiError(
        "prompt must be a string or a non-empty list of token ids",
        param="prompt",
    )


def chat_prompt(body: dict) -> str:
    """Flatten chat `messages` to a prompt string: a minimal
    ``role: content`` template ending with the assistant cue — the
    char-level bench models have no trained chat format, so the
    template only needs to be deterministic and reversible by eye."""
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ApiError("messages must be a non-empty list",
                       param="messages")
    parts = []
    for i, m in enumerate(messages):
        if not isinstance(m, dict) or not isinstance(m.get("role"), str) \
                or not isinstance(m.get("content"), str):
            raise ApiError(
                "each message needs string 'role' and 'content' fields",
                param=f"messages[{i}]",
            )
        parts.append(f"{m['role']}: {m['content']}\n")
    parts.append("assistant:")
    return "".join(parts)


def _base(kind: str, rid: str, model: str) -> dict:
    return {
        "id": rid,
        "object": kind,
        "created": int(time.time()),
        "model": model,
    }


def usage_block(req) -> dict:
    return {
        "prompt_tokens": int(req.prompt.size),
        "completion_tokens": len(req.tokens),
        "total_tokens": int(req.prompt.size) + len(req.tokens),
    }


def logprobs_block(token_ids, logprobs) -> dict:
    """The `logprobs` object of a completion choice: the chosen tokens'
    logprobs and, beside OpenAI's `token_logprobs`, their `token_ids`
    (the exact stream, which text cannot always give back)."""
    return {"token_logprobs": [round(v, 6) for v in logprobs],
            "token_ids": [int(t) for t in token_ids]}


def completion_chunk(rid: str, model: str, text: str,
                     reason: str | None = None,
                     usage: dict | None = None,
                     logprobs: dict | None = None) -> dict:
    out = _base("text_completion", rid, model)
    out["choices"] = [
        {"index": 0, "text": text, "logprobs": logprobs,
         "finish_reason": finish_reason(reason)}
    ]
    if usage is not None:
        out["usage"] = usage
    return out


def chat_chunk(rid: str, model: str, content: str | None,
               reason: str | None = None, role: bool = False,
               usage: dict | None = None) -> dict:
    delta: dict = {}
    if role:
        delta["role"] = "assistant"
    if content is not None:
        delta["content"] = content
    out = _base("chat.completion.chunk", rid, model)
    out["choices"] = [
        {"index": 0, "delta": delta, "finish_reason": finish_reason(reason)}
    ]
    if usage is not None:
        out["usage"] = usage
    return out


def completion_response(rid: str, model: str, req, text: str) -> dict:
    out = _base("text_completion", rid, model)
    out["choices"] = [{
        "index": 0,
        "text": text,
        "logprobs": (logprobs_block(req.tokens, req.logprobs)
                     if req.params.logprobs else None),
        "finish_reason": finish_reason(req.finish_reason),
    }]
    out["usage"] = usage_block(req)
    return out


def chat_response(rid: str, model: str, req, text: str) -> dict:
    out = _base("chat.completion", rid, model)
    out["choices"] = [{
        "index": 0,
        "message": {"role": "assistant", "content": text},
        "finish_reason": finish_reason(req.finish_reason),
    }]
    out["usage"] = usage_block(req)
    return out


# JSON structural characters, most essential first: when a char-level
# vocabulary has spare ids (model vocab_size > corpus charset — e.g.
# gpt_shakespeare reserves 65 ids over a 50-char corpus), `cli serve`
# maps the spares to these so json_object mode is expressible. Digits
# beyond the first are optional — the grammar only needs ONE digit to
# express numbers.
_JSON_CHARS = '{}":,0[]-123456789. \n'


def extend_token_table(table: list, vocab_size: int) -> list:
    """Grow a token id -> string table to `vocab_size`, assigning spare
    ids to missing JSON structural characters (priority order above).
    Existing entries are never changed; leftover spares stay None
    (never legal)."""
    table = list(table) + [None] * (vocab_size - len(table))
    have = set()
    for t in table:
        if t:
            have.update(t)
    missing = [c for c in _JSON_CHARS if c not in have]
    for i in range(len(table)):
        if table[i] is None and missing:
            table[i] = missing.pop(0)
    return table
