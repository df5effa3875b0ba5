"""Probe of the dropout kernels on one NVIDIA card, beside what they are
compared with, each pair in one process and in turns (a, b, b, a):

* the keep-mask kernel (`kernels/csrc/dropout_mask.cu`) against its
  earlier design (`probes/dropout_mask_group.cu`: a thread per 2x2 Philox
  group, byte stores) and `bernoulli_`, at DeepSeek-V3's residual dropout
  (1, 16384, 512), rate 0.1: device time under `torch.profiler` and CUDA
  events; both masks bit for bit the plain keep function;
* the apply kernel against `torch.nn.functional.dropout` at that shape
  and at an attention-sized (8, 2048, 1000) region, bf16 and float32;
* the rate at which an SM issues IMAD and IMAD.WIDE.U32, the two
  multiplies Philox compiles to (`probes/int_mul_rate.cu`, clock64);
* each dropout kernel's SASS: its instructions a thread and its Philox
  multiplies, and the issue time that instruction count implies.

    python3 probes/dropout_ab.py

Needs a CUDA card and nvcc; prints one line per measurement and a JSON
object last, also written to chiprun_out/dropout_ab.json with the
kernels' SASS beside it.
"""

from __future__ import annotations

import ctypes
import json
import re
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
    dropout_apply,
    dropout_keep_reference,
    dropout_mask,
    keep_threshold,
)

PROBES = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
SOURCES = {"dropout_mask_group": "dropout_mask_group.cu",
           "int_mul_rate": "int_mul_rate.cu"}
RATE = 0.1
REGIONS = {"residual_path": (1, 16384, 512), "attention": (8, 2048, 1000)}
MUL_ITERS = 4096
MUL_THREADS, MUL_CHAINS, MUL_UNROLL = 1024, 8, 4


def build_probes() -> dict[str, Path]:
    """The probe sources compiled as the port's kernels are (build.NVCC_FLAGS,
    philox.cuh from kernels/csrc), one nvcc each, started together."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        path = build.BUILD_DIR / f"probe-{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(path), str(PROBES / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), path)
    out = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build {name} failed:\n{log}")
        out[name] = path
    return out


def instructions(lines) -> int:
    """SASS instructions of a kernel listing, NOPs (padding) left out."""
    return sum(1 for x in lines
               if re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?[A-Z]", x)
               and " NOP" not in x)


def group_mask(lib, seed, bh, sq, skv, dev):
    out = torch.empty(bh, sq, skv, dtype=torch.bool, device=dev)
    err = lib.dropout_mask_group(seed, keep_threshold(RATE), bh, sq, skv,
                                 out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dropout_mask_group launch failed: CUDA error {err}")
    return out


def turns(a, b, label_a, label_b, kernel_a=None, kernel_b=None):
    """Device ms a call of a and b under the profiler, in turns a, b, b, a,
    and CUDA-event ms over back-to-back calls; each as (min, max)."""
    dev_ms = {label_a: [], label_b: []}
    ev_ms = {label_a: [], label_b: []}
    for fn, label, kernel in ((a, label_a, kernel_a), (b, label_b, kernel_b),
                              (b, label_b, kernel_b), (a, label_a, kernel_a)):
        dev_ms[label].append(smoke.device_ms(fn, kernel))
        ev_ms[label].append(smoke.cuda_time_ms(fn))
    return {label: dict(device_ms=(min(dev_ms[label]), max(dev_ms[label])),
                        events_ms=(min(ev_ms[label]), max(ev_ms[label])))
            for label in dev_ms}


def mul_rates(lib, sms, dev):
    """Multiplies a clock an SM for IMAD and IMAD.WIDE.U32: median over
    the blocks (one an SM) of the second of two launches."""
    out = {}
    for wide, name in ((0, "IMAD"), (1, "IMAD.WIDE.U32")):
        cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
        sink = torch.empty(sms * MUL_THREADS, dtype=torch.int32, device=dev)
        for _ in range(2):
            err = lib.mul_rate(wide, sms, MUL_ITERS, cycles.data_ptr(),
                               sink.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"mul_rate launch failed: CUDA error {err}")
            torch.cuda.synchronize()
        med = statistics.median(cycles.tolist())
        out[name] = MUL_THREADS * MUL_CHAINS * MUL_UNROLL * MUL_ITERS / med
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("dropout_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    max_mhz = float(clocks.split(",")[1])
    print(card, f"({sms} SMs; SM clock now, max: {clocks} MHz)", flush=True)

    t0 = time.perf_counter()
    libs = {"dropout_mask": build.ensure_built("dropout_mask"), **build_probes()}
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    group = ctypes.CDLL(str(libs["dropout_mask_group"]))
    group.dropout_mask_group.argtypes = [ctypes.c_uint64, ctypes.c_uint32] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
    mul = ctypes.CDLL(str(libs["int_mul_rate"]))
    mul.mul_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3

    # SASS: instructions a thread, Philox multiplies, the issue time
    sass = {}
    for lib in ("dropout_mask", "dropout_mask_group", "int_mul_rate"):
        sass.update(smoke.sass_functions(libs[lib]))
    OUT.mkdir(exist_ok=True)
    with open(OUT / "dropout_ab_sass.txt", "w") as f:
        for name, lines in sass.items():
            f.write(f"Function : {name}\n" + "\n".join(lines) + "\n")
    muls = smoke.philox_multiplies(
        {k: v for k, v in sass.items() if k.startswith("dropout_")})
    bh, sq, skv = REGIONS["residual_path"]
    strips = (sq + 15) // 16 * 8 * ((skv + 15) // 16)
    groups = (sq + 15) // 16 * 8 * ((skv + 15) // 16 * 8)
    threads = {"dropout_mask_kernel": strips, "dropout_mask_group_kernel": groups}
    issue = {}
    for name, n in threads.items():
        insts = instructions(sass[name])
        # an SM issues one warp instruction a clock on each of its 4
        # schedulers; every thread runs its kernel's one straight path
        ms = n / 32 * insts / (4 * sms * max_mhz * 1e6) * 1e3
        _, kinds = muls[name]
        per_call = sum(kinds.values()) / (
            smoke.PHILOX_CALLS_PER_THREAD if name == "dropout_mask_kernel" else 1)
        issue[name] = dict(instructions_a_thread=insts, threads=n,
                           philox_multiplies=kinds, multiplies_a_call=per_call,
                           issue_ms_at_max_clock=ms)
        print(f"sass {name}: {insts} instructions a thread, {n} threads at "
              f"({bh}, {sq}, {skv}): {ms:.4f} ms of issue at {max_mhz:.0f} MHz "
              f"on {sms} SMs x 4 schedulers; Philox multiplies {kinds} "
              f"({per_call:g} a call)", flush=True)
    for name in (k for k in sass if "mul_rate_kernel" in k):
        ops = {}
        for x in sass[name]:
            m = re.search(r"\b(IMAD(?:\.[A-Z0-9]+)*)\s", x.split(";")[0])
            if m:
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        print(f"sass {name}: {ops}", flush=True)

    # the masks: both designs bit for bit the plain keep function
    seed = smoke.DROPOUT_SEED
    want = dropout_keep_reference(seed, RATE, bh, sq, skv, device=dev)
    new = dropout_mask(seed, RATE, bh, sq, skv, dev)
    old = group_mask(group, seed, bh, sq, skv, dev)
    differ = (int((new != want).sum()), int((old != want).sum()))
    print(f"mask ({bh}, {sq}, {skv}) rate {RATE}: elements unlike the plain "
          f"mask: strip design {differ[0]}, group design {differ[1]}", flush=True)
    if any(differ):
        raise AssertionError("a mask kernel disagrees with the plain keep function")

    results = dict(card=card, sms=sms, clocks_mhz=clocks, sass=issue)
    results["mask"] = turns(
        lambda: group_mask(group, seed, bh, sq, skv, dev),
        lambda: dropout_mask(seed, RATE, bh, sq, skv, dev),
        "group_design", "strip_design", "dropout_mask_group_kernel",
        "dropout_mask_kernel")
    buf = torch.empty(bh, sq, skv, dtype=torch.bool, device=dev)
    results["mask"]["bernoulli_"] = dict(
        device_ms=smoke.device_ms(lambda: buf.bernoulli_(1 - RATE)))
    print(f"mask ({bh}, {sq}, {skv}) [{card}]: {json.dumps(results['mask'])}",
          flush=True)

    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 7)
    results["apply"] = {}
    for region, shape in REGIONS.items():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(*shape, generator=g, device=dev).to(dtype)
            key = f"{region} {tuple(shape)} {str(dtype)[6:]}"
            results["apply"][key] = turns(
                lambda: dropout_apply(x, RATE, seed),
                lambda: torch.nn.functional.dropout(x, RATE, True),
                "dropout_apply", "F.dropout", "dropout_apply_kernel", None)
            print(f"apply {key} rate {RATE} [{card}]: "
                  f"{json.dumps(results['apply'][key])}", flush=True)
            del x

    results["mul_rate"] = mul_rates(mul, sms, dev)
    print(f"multiplies a clock an SM [{card}]: {results['mul_rate']}", flush=True)
    text = json.dumps(results)
    (OUT / "dropout_ab.json").write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
