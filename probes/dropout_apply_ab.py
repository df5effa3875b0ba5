"""Probe of the redesigned dropout apply kernel on one NVIDIA card
(`kernels/csrc/dropout_mask.cu`, apply mode), in one process:

* bit for bit against the plain dropout at its checking shapes, and every
  bf16 and float32 input against IEEE division on the card (the checks of
  `chip_smoke.py`);
* its device time against its first design (`probes/dropout_apply_first.cu`)
  and `torch.nn.functional.dropout` at `chip_smoke.py`'s APPLY_SHAPES, in
  turns (a, b, b, a), beside its bytes, issue and Philox-multiply bounds,
  and the wrapper's host time a call against the first design's wrapper (all
  `chip_smoke.time_dropout`);
* forms the kernel does not take (`probes/dropout_apply_variants.cu`:
  Philox's products as ptxas's IMAD.HI.U32 + IMAD instead of
  IMAD.WIDE.U32, register caps, a resident grid with or without an L2
  prefetch) at the same shapes, beside the kernel and F.dropout, each
  timed twice, in order and in reverse, after an L2 scrub
  (`chip_smoke.cold`), with the SASS multiplies of each;
* the rate at which an SM issues IMAD.HI.U32 (`probes/imad_hi_rate.cu`),
  beside IMAD and IMAD.WIDE.U32 (`probes/int_mul_rate.cu`).

    python3 probes/dropout_apply_ab.py

Needs a CUDA card and nvcc; prints one line per measurement and a JSON
object last, also written to chiprun_out/dropout_apply_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from solvingpapers_tpu_torch.kernels import build  # noqa: E402
from solvingpapers_tpu_torch.kernels.dropout import (  # noqa: E402
    DTYPE_CODES,
    _region,
    apply_args,
    dropout_apply,
)

OUT = ROOT / "chiprun_out"
RATE = 0.1
ITERS = 4096
THREADS, CHAINS, UNROLL = 1024, 8, 4


# (wide, persistent, prefetch, min_blocks): the kernel's forms the probe
# times (probes/dropout_apply_variants.cu's FORM list); a persistent form
# runs on the resident blocks split over the bhs, the others a strip a
# thread; (1, 0, 0, 1) is the kernel's own
FORMS = [(1, 1, 0, 1), (1, 1, 1, 1), (1, 1, 0, 4), (0, 1, 0, 1), (0, 1, 1, 1),
         (1, 0, 0, 1), (1, 0, 0, 4), (0, 0, 0, 1)]


class FormApply:
    """The apply kernel in another form (`dropout_apply_form`)."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))
        self.lib.dropout_apply_form.argtypes = [
            ctypes.c_int] * 5 + [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float,
                                 ctypes.c_float] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 3
        self.lib.dropout_apply_form.restype = ctypes.c_int

    def __call__(self, x, rate, seed, form):
        thr, d, rcp = apply_args(rate)
        y = torch.empty_like(x)
        lead, s, dd = _region(x)
        err = self.lib.dropout_apply_form(
            DTYPE_CODES[x.dtype], *form, seed, thr, d, rcp, lead, s, dd,
            x.data_ptr(), y.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dropout_apply_form launch failed: error {err}")
        return y


def rate_of(fn, sms, dev):
    """Multiplies a clock an SM: median over the blocks (one an SM) of the
    second of two launches of `fn(blocks, iters, cycles, sink, stream)`."""
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    sink = torch.empty(sms * THREADS, dtype=torch.int32, device=dev)
    for _ in range(2):
        err = fn(sms, ITERS, cycles.data_ptr(), sink.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"rate kernel launch failed: CUDA error {err}")
        torch.cuda.synchronize()
    return THREADS * CHAINS * UNROLL * ITERS / statistics.median(cycles.tolist())


def main() -> int:
    if not torch.cuda.is_available():
        print("dropout_apply_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    max_mhz = float(clocks.split(",")[1])
    print(card, f"({sms} SMs; SM clock now, max: {clocks} MHz)", flush=True)

    t0 = time.perf_counter()
    waits = {
        "first": smoke.build_probe("dropout_apply_first.cu", "dropout_apply_first"),
        "forms": smoke.build_probe("dropout_apply_variants.cu", "dropout_apply_forms"),
        "imad_hi": smoke.build_probe("imad_hi_rate.cu", "imad_hi_rate"),
        "int_mul": smoke.build_probe("int_mul_rate.cu", "int_mul_rate"),
    }
    built = build.build_all(["dropout_mask"])["dropout_mask"]
    libs = {k: w() for k, w in waits.items()}
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for label, log in (("dropout_mask", built["log"]), ("forms", libs["forms"][1])):
        for line in smoke.build_summary(log)[0][:-1]:
            print(f"build {label}: {line}", flush=True)

    results = dict(card=card, sms=sms, clocks_mhz=clocks)
    funcs = smoke.sass_functions(built["path"])
    form_funcs = smoke.sass_functions(libs["forms"][0])
    OUT.mkdir(exist_ok=True)
    with open(OUT / "dropout_apply_ab_sass.txt", "w") as f:
        for name, lines in {**form_funcs, **funcs}.items():
            f.write(f"Function : {name}\n" + "\n".join(lines) + "\n")
    # the Philox multiplies of every apply kernel, the fast path's
    # instructions a strip of the kernel's own
    fast = smoke.apply_fast_path(funcs, max_mhz)
    results["sass"] = {
        k: dict(philox=v, fast_path=fast[k][0] if k in fast else None)
        for group in (funcs, form_funcs)
        for k, v in smoke.philox_multiplies(group).items() if "apply" in k}
    print(f"sass: {json.dumps(results['sass'])}", flush=True)

    first = smoke.FirstApply(libs["first"][0])
    results["checks"] = smoke.check_dropout_apply(dev)
    results["every_input"] = smoke.check_dropout_apply_every_input(dev)
    results["times"] = smoke.time_dropout(
        dev, card, smoke.philox_multiplies(funcs),
        smoke.apply_fast_path(funcs, max_mhz), first)["dropout_apply"]

    form = FormApply(libs["forms"][0])
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 8)
    scrub = smoke.l2_scrub(dev)
    results["forms"] = {}
    for name, shape, dtype in smoke.APPLY_SHAPES:
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        want = dropout_apply(x, RATE, 5)
        variants = {"kernel": (smoke.cold(lambda: dropout_apply(x, RATE, 5), scrub),
                               "dropout_apply_kernel"),
                    "library F.dropout": (smoke.cold(
                        lambda: torch.nn.functional.dropout(x, RATE, True), scrub),
                        "dropout")}
        for f in FORMS:
            fn = smoke.cold(lambda f=f: form(x, RATE, 5, f), scrub)
            if not torch.equal(fn().view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"form {f} differs")
            wide, persistent, prefetch, minb = f
            variants[(f"{'wide' if wide else 'ptxas'} "
                      f"{'resident' if persistent else '1 strip'}"
                      f"{' L2 prefetch' if prefetch else ''} min_blocks {minb}")] = (
                fn, "dropout_apply_form_kernel")
        acc = {k: [] for k in variants}
        for order in (list(variants), list(variants)[::-1]):
            for k in order:
                acc[k].append(smoke.device_ms(variants[k][0], variants[k][1]))
        key = f"{name} {tuple(shape)} {str(dtype)[6:]}"
        results["forms"][key] = acc
        print(f"forms {key} [{card}] device ms: " + "; ".join(
            f"{k} {v[0]:.5f} / {v[1]:.5f}" for k, v in acc.items()), flush=True)
        del x, want

    hi = ctypes.CDLL(str(libs["imad_hi"][0]))
    hi.imad_hi_rate.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    mul = ctypes.CDLL(str(libs["int_mul"][0]))
    mul.mul_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    results["mul_rate"] = {
        "IMAD": rate_of(lambda *a: mul.mul_rate(0, *a), sms, dev),
        "IMAD.WIDE.U32": rate_of(lambda *a: mul.mul_rate(1, *a), sms, dev),
        "IMAD.HI.U32": rate_of(hi.imad_hi_rate, sms, dev),
    }
    ops = {}
    for name, lines in smoke.sass_functions(libs["imad_hi"][0]).items():
        for x in lines:
            m = smoke.re.search(r"\b(IMAD(?:\.[A-Z0-9]+)*)\s", x.split(";")[0])
            if m:
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    results["imad_hi_sass"] = ops
    print(f"multiplies a clock an SM [{card}]: {results['mul_rate']} (the "
          f"IMAD.HI probe's SASS: {ops})", flush=True)
    text = json.dumps(results)
    (OUT / "dropout_apply_ab.json").write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
