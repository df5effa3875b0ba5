"""The port's OpenAI wire protocol (`serve/openai.py`) against the JAX
package's: on a table of request bodies `parse_sampling`, `wants_json`,
`parse_prompt` and `chat_prompt` give the same values, or the same
`ApiError` status, type and param; the response shapes, the finish
reason map and `extend_token_table` agree too, the `slo` class tag and
its `service_tier` alias included (a server without SLO classes refuses
a tag at submit: `test_torch_slo.py`)."""

import numpy as np
import pytest

from solvingpapers_tpu.serve import openai as joai
from solvingpapers_tpu.serve.scheduler import Request as JRequest
from solvingpapers_tpu_torch.serve import openai as oai
from solvingpapers_tpu_torch.serve.sampling import SamplingParams
from solvingpapers_tpu_torch.serve.scheduler import Request

STOI = {c: i for i, c in enumerate("abcdefgh {}")}


def _encode(s):
    return [STOI[c] for c in s]


BODIES = [
    {},
    {"temperature": 0, "max_tokens": 7},
    {"temperature": 0.7, "top_p": 0.9, "top_k": 5, "min_p": 0.1, "seed": 3},
    {"stop": "x", "logprobs": 1, "timeout_s": 2.5},
    {"stop": ["a", "bc"], "logprobs": True, "timeout_s": 1},
    {"logprobs": 0, "stop": None},
    {"n": 2}, {"best_of": 3}, {"echo": True}, {"n": "1"},
    {"max_tokens": "9"}, {"max_tokens": 0}, {"logprobs": 2},
    {"stop": 5}, {"stop": ["a", 1]}, {"stop": ["a", "b", "c", "d", "e"]},
    {"stop": [""]}, {"timeout_s": 0}, {"timeout_s": "1"}, {"seed": 1.5},
    {"seed": -1}, {"temperature": -0.1}, {"temperature": True},
    {"top_p": 0}, {"top_p": 1.5}, {"min_p": 2}, {"top_k": -1},
    {"top_k": 2.0}, {"service_tier": "flex"}, {"slo": "interactive"},
    {"slo": ""}, {"slo": 3},
]


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except (oai.ApiError, joai.ApiError) as e:
        return "error", (e.status, e.err_type, e.param, e.code)


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_parse_sampling_matches_the_reference(body):
    kind, ours = _outcome(oai.parse_sampling, body)
    jkind, theirs = _outcome(joai.parse_sampling, body)
    assert kind == jkind
    if kind == "error":
        assert ours == theirs
        return
    (p, max_tokens, timeout_s), (jp, jmax, jtimeout) = ours, theirs
    assert (max_tokens, timeout_s) == (jmax, jtimeout)
    for field in ("temperature", "top_k", "top_p", "min_p", "seed",
                  "max_tokens", "stop", "stop_token_ids", "logprobs", "slo"):
        assert getattr(p, field) == getattr(jp, field), field


def test_slo_tag_is_refused():
    """A malformed `slo` tag is a 400 on `slo` in both packages; a class
    name passes through (the engine refuses a class it does not track),
    and `service_tier` becomes the class only where the server has it."""
    for bad in ({"slo": ""}, {"slo": 3}, {"slo": ["batch"]}):
        with pytest.raises(oai.ApiError) as e:
            oai.parse_sampling(bad)
        with pytest.raises(joai.ApiError) as je:
            joai.parse_sampling(bad)
        assert (e.value.param, e.value.status) == ("slo", 400)
        assert (e.value.param, e.value.status) == (je.value.param,
                                                   je.value.status)
    classes = {"interactive", "standard", "batch"}
    for body, want in (({"slo": "batch"}, "batch"),
                       ({"service_tier": "batch"}, "batch"),
                       ({"service_tier": "flex"}, None)):
        got = oai.parse_sampling(body, slo_classes=classes)[0].slo
        assert got == want == joai.parse_sampling(body, slo_classes=classes)[0].slo
    assert oai.parse_sampling({"service_tier": "batch"})[0].slo is None


@pytest.mark.parametrize("body,ok", [
    ({}, True), ({"response_format": {"type": "text"}}, True),
    ({"response_format": {"type": "json_object"}}, True),
    ({"response_format": {"type": "json_object"}}, False),
    ({"response_format": {"type": "xml"}}, True),
    ({"response_format": "json"}, True),
])
def test_wants_json_matches_the_reference(body, ok):
    assert _outcome(oai.wants_json, body, ok) == _outcome(joai.wants_json,
                                                          body, ok)


@pytest.mark.parametrize("body", [
    {"prompt": "abc"}, {"prompt": "a~"}, {"prompt": [1, 2, 3]},
    {"prompt": []}, {"prompt": [1, True]}, {"prompt": [0, 64]},
    {"prompt": [-1]}, {"prompt": 5}, {},
], ids=range(9))
@pytest.mark.parametrize("encode", [_encode, None], ids=["encode", "ids-only"])
def test_parse_prompt_matches_the_reference(body, encode):
    assert (_outcome(oai.parse_prompt, body, encode, 64)
            == _outcome(joai.parse_prompt, body, encode, 64))


@pytest.mark.parametrize("body", [
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "hi"}]},
    {"messages": []}, {"messages": "hi"}, {},
    {"messages": [{"role": "user"}]},
    {"messages": [{"role": "user", "content": "a"}, "b"]},
], ids=range(6))
def test_chat_prompt_matches_the_reference(body):
    assert _outcome(oai.chat_prompt, body) == _outcome(joai.chat_prompt, body)


def test_shapes_finish_reasons_and_token_table_match_the_reference():
    for reason in (None, "eos", "stop", "length", "error", "timeout",
                   "cancelled"):
        assert oai.finish_reason(reason) == joai.finish_reason(reason)
    table = ["a", None, "b", "{", None, None, None, None, None, None]
    assert oai.extend_token_table(table, 30) == joai.extend_token_table(table, 30)
    prompt = np.arange(4)
    ours = Request(prompt=prompt, max_new_tokens=3, eos_id=None,
                   params=SamplingParams(logprobs=True))
    theirs = JRequest(prompt=prompt, max_new_tokens=3, eos_id=None)
    for r in (ours, theirs):
        r.tokens, r.logprobs, r.finish_reason = [5, 6], [-0.5, -1.25], "eos"
    assert oai.usage_block(ours) == joai.usage_block(theirs)
    drop = lambda d: {k: v for k, v in d.items() if k != "created"}  # noqa: E731
    assert (drop(oai.chat_response("r", "m", ours, "xy"))
            == drop(joai.chat_response("r", "m", theirs, "xy")))
    assert (drop(oai.chat_chunk("r", "m", "x", reason="length", role=True))
            == drop(joai.chat_chunk("r", "m", "x", reason="length", role=True)))
    assert (drop(oai.completion_chunk("r", "m", "x", reason="stop"))
            == drop(joai.completion_chunk("r", "m", "x", reason="stop")))
    doc = oai.completion_response("r", "m", ours, "xy")
    assert doc["choices"][0]["logprobs"] == {"token_logprobs": [-0.5, -1.25],
                                             "token_ids": [5, 6]}
    assert doc["choices"][0]["finish_reason"] == "stop"
    assert oai.error_event("x") == joai.error_event("x")
