"""The port's serving microbench (`serve/kernel_bench.py`, `cli
kernel-bench`) against the JAX package's, on the CPU at `gpt_tiny`.

* `paged_decode_decomposition`'s arithmetic equals the reference's on
  the same walls: `fenced_wall_s` is replaced in both packages by the
  same fixed walls (gather, one scatter, dequant, in the order both
  measure them), unquantized and int8, with walls whose shares sum past
  100 (the clamped, rescaled case);
* `fenced_wall_s` keeps the minimum of its fenced repetitions, after one
  warm-up call outside the timing;
* `cli kernel-bench --device cpu --reps 1` at a tiny size writes the
  reference's four grid entries with the reference's literal keys, every
  family's wall finite and above 0.
"""

import json
import math

import numpy as np
import pytest

from solvingpapers_tpu.configs import registry as jreg
from solvingpapers_tpu.models.gpt import GPT as JGPT
from solvingpapers_tpu.serve import kernel_bench as jkb
from solvingpapers_tpu_torch import cli
from solvingpapers_tpu_torch.configs import get_config
from solvingpapers_tpu_torch.models import GPT
from solvingpapers_tpu_torch.serve import kernel_bench as kb
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

SHAPE = dict(n_slots=2, max_len=32, page_size=16, decode_block=16)


def _walls(values):
    """A `fenced_wall_s` stand-in returning `values` in call order."""
    it = iter(values)

    def fenced(fn, args=(), **kw):
        return next(it)

    return fenced


@pytest.mark.parametrize("kv_quant,step,walls", [
    (None, 2e-3, (1.5e-4, 2.5e-5)),
    ("int8", 2e-3, (3e-4, 4e-5, 1e-4)),
    ("int8", 1e-4, (3e-4, 4e-5, 5e-4)),  # dequant > gather, clamped
    (None, 1e-4, (2e-4, 3e-5)),  # clamped
])
def test_paged_decode_decomposition_equals_reference(monkeypatch, kv_quant,
                                                     step, walls):
    monkeypatch.setattr(kb, "fenced_wall_s", _walls(walls))
    monkeypatch.setattr(jkb, "fenced_wall_s", _walls(walls))
    got = kb.paged_decode_decomposition(
        GPT(get_config("gpt_tiny").model, device="cpu"), **SHAPE,
        step_wall_s=step, kv_quant=kv_quant, reps=1)
    want = jkb.paged_decode_decomposition(
        JGPT(jreg.get_config("gpt_tiny").model), **SHAPE, step_wall_s=step,
        kv_quant=kv_quant, reps=1)
    assert got == want
    assert ("decomposition_clamped" in got) == (step == 1e-4)
    with pytest.raises(ValueError, match="step_wall_s"):
        kb.paged_decode_decomposition(None, **SHAPE, step_wall_s=0.0)


def test_fenced_wall_s_keeps_the_minimum_after_a_warm_up():
    calls = []
    ticks = iter([0.0, 5.0, 10.0, 12.0, 20.0, 24.0])
    wall = kb.fenced_wall_s(lambda a: calls.append(a), (7,), reps=3,
                            clock=lambda: next(ticks))
    assert wall == 2.0 and calls == [7, 7, 7, 7]


# the reference's entry (kernel_bench.py:429-468) and its detail keys
ENTRY = {"metric", "value", "unit", "detail"}
DETAIL = {"workload", "config", "pool", "kv_quant", "kv_dtype", "n_slots",
          "max_len", "page_size", "quant_block", "sample_cap", "spec_k",
          "decode_block", "reps", "lane_view_bytes", "pool_bytes",
          "gather_gbps", *{f"{f}_wall_us" for f in jkb.OP_FAMILIES}}


def test_cli_kernel_bench_writes_the_reference_grid(tmp_path, capsys):
    assert kb.OP_FAMILIES == jkb.OP_FAMILIES
    assert (kb.POOL_LAYOUTS, kb.KV_QUANTS) == (jkb.POOL_LAYOUTS, jkb.KV_QUANTS)
    out = tmp_path / "k.jsonl"
    assert cli.main(["kernel-bench", "--config", "gpt_tiny", "--device", "cpu",
                     "--reps", "1", "--slots", "2", "--max-len", "40",
                     "--out", str(out)]) == 0
    printed = capsys.readouterr().out.splitlines()
    lines = out.read_text().splitlines()
    assert printed == lines and len(lines) == 4
    entries = [json.loads(line) for line in lines]
    assert [e["detail"]["workload"] for e in entries] == [
        "kernels-lane-f32", "kernels-lane-int8", "kernels-paged-f32",
        "kernels-paged-int8"]
    for e in entries:
        assert set(e) - {"schema_version", "provenance"} == ENTRY
        d = e["detail"]
        assert set(d) == DETAIL
        assert d["max_len"] == 32  # rounded down to the 16-token grain
        assert d["config"] == "gpt_tiny@s2l32p16b16c64k4"
        assert d["kv_dtype"] == (d["kv_quant"] or "float32")
        for f in kb.OP_FAMILIES:
            assert math.isfinite(d[f"{f}_wall_us"]) and d[f"{f}_wall_us"] > 0
        assert e["value"] == d["gather_gbps"] > 0
    # int8 codes and scales take less than the float32 pool
    by = {e["detail"]["workload"]: e["detail"]["pool_bytes"] for e in entries}
    assert by["kernels-lane-int8"] < by["kernels-lane-f32"]
    assert by["kernels-paged-int8"] < by["kernels-paged-f32"]
    assert np.all([e["provenance"] == entries[0]["provenance"]
                   for e in entries])
