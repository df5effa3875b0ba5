"""Probe of the float32 dq kernel's forms on one NVIDIA card, in one
process: `flash_bwd_dq_tf32` in the forms of `probes/flash_dq_variants.cu`
(at D 16 to 64 its own 64-row kv tiles and 32-row ones; at D 128, with
and without dropout, the score products' k-steps in unrolled runs of 8,
4 or 2 and dQ += dS K in passes of 4 or 2 k-steps), each checked against
the plain backward (max |err| / max |plain| within chip_smoke's
F32_BWD_TOL, two calls bit-identical), then timed in turns (first
design, forms, forms reversed, first design) beside the first design
(`probes/flash_f32_fma_first.cu`), at phase 6's and 7's step shapes
(phase 7's also at rate 0; CUDA events) and at llama3_long_smoke's
attention at D 16 and 32 (device time under torch.profiler). The build
lines give each form's registers and spills, and the SASS around any
spill inside a form's tile loop goes to chiprun_out/flash_dq_spills.txt.
The port's own dq is timed by chip_smoke.py's `time_f32_kernels`.

    python3 probes/flash_dq_ab.py

Needs a CUDA card and nvcc; prints one line per measurement and a JSON
object last, also written to chiprun_out/flash_dq_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from solvingpapers_tpu_torch.kernels.flash_attention import (  # noqa: E402
    _DROPOUT_ARGTYPES,
    _bwd_kernel_inputs,
    _launch_args,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_delta,
)

OUT = ROOT / "chiprun_out"
FORMS = {16: ("tkv64", "tkv32"), 32: ("tkv64", "tkv32"), 64: ("tkv64", "tkv32"),
         128: ("run8_pass4", "run4_pass4", "run8_pass2", "run4_pass2", "run2_pass2")}
# (name, b, s, n, n_kv, d, rate, timer); at n_kv 1 v is k (MLA's latent)
SHAPES = [("train_f32_step", 1, 2048, 16, 8, 64, 0.0, "events"),
          ("dsv3_f32_step", 1, 2048, 8, 1, 128, 0.1, "events"),
          ("dsv3_f32_step_rate0", 1, 2048, 8, 1, 128, 0.0, "events"),
          ("smoke_d16", *smoke.SMOKE_SHAPE[:2], *smoke.SMOKE_SHAPE[3:], 16, 0.0, "device"),
          ("smoke_d32", *smoke.SMOKE_SHAPE[:2], *smoke.SMOKE_SHAPE[3:], 32, 0.0, "device")]


class Forms:
    """`flash_bwd_dq_variant` behind the port's argument handling."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))
        self.lib.flash_bwd_dq_variant.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int] + _DROPOUT_ARGTYPES
            + [ctypes.c_void_p])
        self.lib.flash_bwd_dq_variant.restype = ctypes.c_int

    def __call__(self, form, q, k, v, do, lse, delta, rate):
        q, k, v, do, lse, delta = _bwd_kernel_inputs(q, k, v, do, lse, delta)
        args, _ = _launch_args(q, k, None, True, rate, smoke.DROPOUT_SEED)
        dq = torch.empty_like(q)
        err = self.lib.flash_bwd_dq_variant(
            form, q.shape[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *args, torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd_dq_variant {form} failed: error {err}")
        return dq


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_dq_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(card, flush=True)
    wait_forms = smoke.build_probe("flash_dq_variants.cu", "flash_dq_variants")
    wait_first = smoke.build_probe("flash_f32_fma_first.cu", "flash_f32_fma_first")
    path, log = wait_forms()
    for line in smoke.build_summary(log)[0]:
        print(f"build flash_dq_variants: {line}", flush=True)
    funcs = smoke.sass_functions(path)
    context = []
    for kernel, (n, inside) in smoke.sass_spills(funcs).items():
        if "dq_tf32" not in kernel:
            continue
        print(f"build flash_dq_variants: {kernel}: {n} spill instructions, "
              f"{inside} inside its tile loop", flush=True)
        lines = funcs[kernel]
        for i, line in enumerate(lines):
            if inside and ("STL" in line or "LDL" in line):
                context += [f"== {kernel} line {i}"] + lines[max(0, i - 12):i + 6]
    OUT.mkdir(exist_ok=True)
    (OUT / "flash_dq_spills.txt").write_text("\n".join(context))
    forms = Forms(path)
    first = smoke.FirstF32(wait_first()[0])
    out = {"card": card, "shapes": []}
    for name, b, s, n, n_kv, d, rate, timer in SHAPES:
        g = torch.Generator(device=dev).manual_seed(smoke.SEED + 30)
        kv = "k_is_v" if n_kv == 1 else "own"
        q, k, v, do = smoke.small_d_inputs(g, b, s, s, n, n_kv, d, kv, dev)
        kw = dict(causal=True, dropout_rate=rate, dropout_seed=smoke.DROPOUT_SEED)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        delta = flash_delta(do, o)
        args = (q, k, v, do, lse, delta)
        ref = flash_attention_bwd_reference(*args, **kw)[0]
        calls = {"first": lambda: first.dq(*args, **kw)}
        errs = {}
        for form, label in enumerate(FORMS[d]):
            calls[label] = lambda form=form: forms(form, *args, rate)
            x, y = calls[label](), calls[label]()
            errs[label] = smoke.rel_err(x, ref)
            if errs[label] > smoke.F32_BWD_TOL or not torch.equal(x, y):
                raise AssertionError(f"{label} at {name}: err {errs[label]:.3e}, "
                                     f"bit-identical {torch.equal(x, y)}")
        if timer == "events":
            turns = smoke.in_turns(calls, smoke.cuda_time_ms)
        else:
            turns = smoke.in_turns({k: (lambda f=f: smoke.device_ms(f))
                                    for k, f in calls.items()},
                                   lambda timer: timer())
        bound_ms, _, flops, _ = smoke.attention_bound(
            "flash_bwd_dq", b, s, s, n, n_kv, d, torch.float32)
        rec = dict(shape=f"B{b} S{s} N{n} Nkv{n_kv} D{d} float32 causal rate "
                   f"{rate} ({name})",
                   timer=timer, bound_ms=bound_ms,
                   cuda_core_ms=smoke.cuda_core_ms(flops), max_rel_err=errs,
                   ms_turns=turns)
        out["shapes"].append(rec)
        print(f"dq forms at {rec['shape']} [{card}], {timer}: "
              + ", ".join(f"{k} {t[0]:.4f} / {t[1]:.4f} ms" for k, t in turns.items())
              + f"; bound {bound_ms:.4f} ms, at 67 TFLOP/s "
              f"{rec['cuda_core_ms']:.4f} ms; errors "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()), flush=True)
        del q, k, v, do, o, lse, delta, args, ref
    (OUT / "flash_dq_ab.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
