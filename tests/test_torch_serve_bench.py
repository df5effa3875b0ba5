"""The port's serving bench (`solvingpapers_tpu_torch/serve/bench.py`),
its build stamp, and the profiler windows of `Trainer` and `ServeEngine`,
on the CPU at `gpt_tiny`.

* the request generators equal the JAX package's element for element,
  `sampling_params_mix` field for field;
* the provenance stamp names torch and CUDA, not jax;
* each of the eleven workloads returns the reference's result keys less
  the documented set that rests on XLA's compile registry (or, on the
  CPU, on the card's allocator; or, for the quant workload, on the
  anatomy arm), plus the port's `arms`; the probe's `decode_step_wall_s`
  is the probe engine's own decode-block wall, and the paged and quant
  workloads' decode decompositions partition it;
* the chaos, journal, replay and fleet workloads' never-flip booleans
  hold at a small size: surviving streams token-exact, recovered and
  migrated streams token-exact, identical-config replays byte-exact,
  every pool drained without a leak;
* the engine arm's greedy streams equal one-shot `generate`'s; the paged
  workload's capacity arm holds more streams than the lane pool's slots
  and its page-sharing hits make no device copy; the HTTP streams equal
  the direct arm's;
* a profiler window writes one Chrome trace, and none without
  `profile_dir`.
"""

import contextlib
import dataclasses
import gc
import glob
import json
import os
import types
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from solvingpapers_tpu.configs import factory as jfactory
from solvingpapers_tpu.configs import registry as jreg
from solvingpapers_tpu.serve import bench as jbench
from solvingpapers_tpu.serve import kv_pool as jkv
from solvingpapers_tpu_torch import cli
from solvingpapers_tpu_torch.buildinfo import build_info
from solvingpapers_tpu_torch.configs import get_config
from solvingpapers_tpu_torch.infer import generate
from solvingpapers_tpu_torch.serve import ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve import bench
from solvingpapers_tpu_torch.serve import kv_pool
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

CFG = "gpt_tiny"
SMALL = dict(config=CFG, n_requests=6, n_slots=4, max_new=4, decode_block=4,
             prompt_lens=(8, 16, 24), device="cpu")

TOP = {"metric", "value", "unit", "vs_baseline", "detail"}
# the reference probe's fields that read XLA's compile registry
# (solvingpapers_tpu/serve/bench.py:373-381): no twin in eager PyTorch.
# Its `decode_step_wall_s` (:386-389) the port takes from the probe
# engine's decode blocks
XLA_PROBE = {"compile_time_s", "compile_programs", "compile_compilations"}
# the port's measured peaks, taken from the card's allocator: absent on
# the CPU (peak_hbm_bytes, bench.py:382; capacity_program_temp_bytes,
# bench.py:909/921)
CARD_ONLY = {"peak_hbm_bytes"}
PORT_ONLY = {"arms"}
KV = {"kv_dtype", "kv_pool_bytes", "greedy_agreement_rate"}  # :233-237
PROBE = XLA_PROBE | CARD_ONLY | {"decode_step_wall_s"}

# the reference's detail keys, workload by workload, with the lines that
# write them
REF_DETAIL = {
    # run_serve_bench :516-546, :567-568 (no prefix cache: no
    # prefix_hit_rate / tokens_prefilled_saved)
    "serve": {"config", "n_requests", "n_slots", "max_new_tokens",
              "decode_block", "prompt_lens", "mean_interarrival_s",
              "engine_requests_per_sec", "engine_tokens_per_sec",
              "mean_ttft_s", "ttft_p95_s", "itl_p95_s", "slot_occupancy",
              "sequential_requests_per_sec", "sequential_mean_ttft_s",
              *KV, *PROBE},
    # run_prefix_bench :673-690, :716-733
    "prefix": {"config", "workload", "n_requests", "n_prefixes", "prefix_len",
               "suffix_len", "n_slots", "max_new_tokens", "decode_block",
               "mean_interarrival_s", "prefix_page",
               *{f"{arm}_{k}" for arm in ("cache_on", "cache_off")
                 for k in ("requests_per_sec", "mean_ttft_s", "ttft_p95_s",
                           "prefix_hit_rate", "prefix_evictions",
                           "tokens_prefilled_saved", "prefix_hbm_bytes")},
               *KV, *PROBE},
    # run_paged_bench :848-868, the decomposition :875-885
    # (kernel_bench.py:556-565), the anatomy arm :888-891 (:330-334),
    # :915-926, :996-1010
    "paged": {"config", "workload", "n_requests", "n_slots", "page_size",
              "max_len", "max_new_tokens", "decode_block", "prompt_lens",
              "mean_interarrival_s", "paged_requests_per_sec",
              "lane_requests_per_sec", "paged_overhead_pct",
              "paged_kv_pool_bytes", "lane_kv_pool_bytes", *KV, *PROBE,
              "gather_wall_s", "dequant_wall_s", "scatter_wall_s",
              "gather_share_pct", "dequant_share_pct", "scatter_share_pct",
              "attention_share_pct", "anatomy_overhead_pct",
              "anatomy_requests_per_sec", "capacity_n_slots",
              "capacity_page_budget", "capacity_max_new_tokens",
              "capacity_peak_active_slots", "capacity_kv_pool_bytes",
              "capacity_program_temp_bytes", "capacity_requests_per_sec",
              "capacity_preemptions", "prefix_len", "suffix_len",
              "n_prefixes", "prefix_n_requests", "paged_prefix_mean_ttft_s",
              "paged_noprefix_mean_ttft_s", "lane_prefix_mean_ttft_s",
              "paged_prefix_ttft_speedup", "paged_vs_lane_prefix_ttft",
              "paged_prefix_hit_rate", "splice_programs_dispatched"},
    # run_sampling_bench :1603-1610, :1636-1651
    "sampling": {"config", "workload", "n_requests", "n_slots",
                 "max_new_tokens", "decode_block", "prompt_lens",
                 "mean_interarrival_s", "sampling_overhead_pct",
                 *{f"{arm}_{k}" for arm in ("greedy", "sampled")
                   for k in ("requests_per_sec", "tokens_per_sec",
                             "mean_ttft_s", "itl_p95_s")},
                 *KV, *PROBE},
    # run_http_bench :1828-1851
    "http": {"config", "workload", "n_requests", "n_clients", "n_slots",
             "max_new_tokens", "decode_block", "prompt_lens",
             "mean_interarrival_s", "reps", "http_requests_per_sec",
             "direct_requests_per_sec", "http_overhead_pct",
             "http_mean_ttft_s", "http_ttft_p95_s", "http_itl_p99_s",
             "stream_token_exact", *KV, *PROBE},
    # run_slo_bench :1971-2008
    "slo": {"config", "workload", "n_requests", "n_slots", "max_new_tokens",
            "decode_block", "prompt_lens", "mean_interarrival_s", "reps",
            "class_cycle", "slo_targets", "slo_overhead_pct",
            "slo_requests_per_sec", "plain_requests_per_sec",
            "goodput_tokens_per_s", "tokens_per_sec", "goodput_ratio",
            "attainment_by_class", "goodput_tokens", "ttft_p95_s",
            "itl_p95_s", "e2e_p95_s", *KV, *PROBE},
}
# the post-drain leak facts (`_zero_leak_fields` :2076-2100): the paged
# pool's page facts only on a paged pool
LEAK = {"slots_clean", "zero_leak"}
PAGE_LEAK = {"pages_free", "page_budget", "refcount_sum"}
REF_DETAIL.update({
    # run_chaos_bench :2226-2297
    "chaos": {"config", "workload", "n_requests", "n_slots", "max_new_tokens",
              "decode_block", "prompt_lens", "mean_interarrival_s", "reps",
              "fault_plan", "streams_survived", "streams_admitted",
              "streams_quarantined", "streams_shed_off_arm",
              "survivors_token_exact", "faults_injected", "fault_retries",
              "fault_recovery_s", "watchdog_stalls",
              "journal_degraded_exercised", *LEAK, *PAGE_LEAK,
              "ladder_zero_leak", "goodput_ladder_on", "goodput_ladder_off",
              "goodput_ladder_ratio", "ladder_max_shed", "ladder_rung_final",
              "ladder_transitions", "fault_overhead_pct",
              "armed_requests_per_sec", "plain_requests_per_sec", *KV,
              *PROBE},
    # run_journal_bench :2444-2481
    "journal": {"config", "workload", "n_requests", "n_slots",
                "max_new_tokens", "decode_block", "prompt_lens",
                "mean_interarrival_s", "reps", "journal_overhead_pct",
                "journal_on_requests_per_sec", "journal_off_requests_per_sec",
                "journal_records", "journal_bytes", "journal_fsyncs",
                "journal_fsync_s", "journal_rotations", "kill_after_steps",
                "finished_before_kill", "live_at_kill", "recovered_requests",
                "recovery_wall_s", "recovered_token_exact", *LEAK, *KV,
                *PROBE},
    # run_replay_bench :2620-2658
    "replay": {"config", "workload", "n_requests", "n_slots",
               "max_new_tokens", "decode_block", "prompt_lens", "train_steps",
               "cut_stride", "replay_byte_exact",
               "replay_byte_exact_rate_lane", "replay_byte_exact_rate_paged",
               "replay_agreement_rate", "replay_agreement_rate_seeded",
               "replay_agreement_rate_all", "identical_agreement_rate",
               "quant_byte_exact_rate", "replay_first_divergence_p50",
               "replay_streams_compared", "replay_streams_skipped",
               "replay_cut_positions", "replay_wall_s", "journal_records",
               "journal_bytes", "journal_rotations", *LEAK, *KV, *PROBE},
    # run_quant_bench :1453-1497, the decomposition :1435-1439
    # (kernel_bench.py:556-565), the anatomy arm :1500-1503 (:330-334)
    "quant": {"config", "workload", "n_requests", "n_slots", "max_new_tokens",
              "decode_block", "page_size", "kv_quant_block", "max_len",
              "train_steps", "prompt_lens", "mean_interarrival_s", "reps",
              "quant_requests_per_sec", "exact_requests_per_sec",
              "quant_overhead_pct", "agreement_cuts", "rollout_agreement_rate",
              "kv_bytes_ratio", "kv_scale_bytes", "exact_kv_pool_bytes",
              "f32_paged_kv_pool_bytes", "quant_page_nbytes",
              "capacity_n_slots", "capacity_page_budget",
              "capacity_n_requests", "capacity_max_new_tokens",
              "capacity_peak_active_slots", "capacity_kv_pool_bytes",
              "capacity_program_temp_bytes", "capacity_requests_per_sec",
              "capacity_preemptions", *KV, *PROBE, "gather_wall_s",
              "dequant_wall_s", "scatter_wall_s", "gather_share_pct",
              "dequant_share_pct", "scatter_share_pct", "attention_share_pct",
              "anatomy_overhead_pct", "anatomy_requests_per_sec"},
    # run_spec_bench :1163-1198
    "spec": {"config", "workload", "n_requests", "n_slots", "max_new_tokens",
             "decode_block", "spec_k", "spec_rounds", "train_steps",
             "prompt_lens", "mean_interarrival_s", "reps",
             "spec_tokens_per_sec", "plain_tokens_per_sec", "spec_speedup",
             "acceptance_rate", "spec_tokens_per_step", "greedy_token_exact",
             "adversarial_spec_tokens_per_sec",
             "adversarial_plain_tokens_per_sec",
             "spec_adversarial_overhead_pct", "adversarial_acceptance_rate",
             *KV, *PROBE},
    # run_fleet_bench :2950-2999 (fleet_trace_out when given)
    "fleet": {"config", "workload", "n_requests", "n_slots", "n_replicas",
              "max_new_tokens", "decode_block", "prompt_lens",
              "mean_interarrival_s", "reps", "router_overhead_pct",
              "fleet_requests_per_sec", "bare_requests_per_sec",
              "fleet_trace_overhead_pct", "fleet_traced_requests_per_sec",
              "fleet_untraced_requests_per_sec", "live_at_drain",
              "migrated_streams", "migration_errors", "migration_wall_s",
              "migrated_token_exact", "fleet_token_exact",
              "zero_leak_drained", "zero_leak_peers", "zero_leak", "routing",
              "trail_partition_ok", "trail_partition_err_pct",
              "trail_partition_streams", "fleet_trace_out", *KV, *PROBE},
})
# `_traced_arm_fields` :296-307 (trace_out when given), and the status
# endpoint's port from the probe :390-391
TRACED = {"trace_overhead_pct", "traced_requests_per_sec", "trace_events",
          "trace_out"}
STATUS = {"status_port"}
# what the port leaves out of each: the XLA set everywhere; the anatomy
# arm and the program temp wait for the compile observatory; the SLO
# workload's e2e_p95_s reads the reference's e2e latency histogram, which
# the port's metrics do not keep
LEFT_OUT = {
    "slo": {"e2e_p95_s"},
    # the program temp and the anatomy arm wait for the compile
    # observatory (A8)
    "quant": set(bench.QUANT_LEFT_OUT),
    "paged": {"anatomy_overhead_pct", "anatomy_requests_per_sec",
              "capacity_program_temp_bytes"},
}
# the decomposition's shares, present with `decode_step_wall_s`
# (kernel_bench.py:556-565); `decomposition_clamped` only when the
# measured shares summed past 100
SHARES = ("gather_share_pct", "dequant_share_pct", "scatter_share_pct",
          "attention_share_pct")


# what the port adds beside `arms`: the replay workload says what it
# left out, and lists the identical-config arms' divergences
PORT_EXTRA = {"replay": {"replay_diverged"}, "quant": {"notes"}}


def _cpu_keys(workload: str) -> set:
    return ((REF_DETAIL[workload] - XLA_PROBE - CARD_ONLY
             - LEFT_OUT.get(workload, set())) | PORT_ONLY
            | PORT_EXTRA.get(workload, set()))


# ------------------------------------------------------------ generators


@pytest.mark.parametrize("kind,seed,vocab,shape", [
    ("poisson", 0, 64, (8, 16, 24, 32)),
    ("poisson", 3, 50257, (256, 512, 1024, 2048)),
    ("poisson", 11, 97, (5,)),
    ("shared", 0, 64, (4, 64, 8)),
    ("shared", 1, 50257, (4, 4080, 8)),
    ("shared", 7, 13, (3, 16, 5)),
])
def test_request_generators_equal_the_reference(kind, seed, vocab, shape):
    if kind == "poisson":
        args = dict(prompt_lens=shape, mean_interarrival_s=0.003, seed=seed)
        got = bench.synthetic_requests(9, vocab, **args)
        want = jbench.synthetic_requests(9, vocab, **args)
    else:
        k, plen, slen = shape
        args = dict(n_prefixes=k, prefix_len=plen, suffix_len=slen,
                    mean_interarrival_s=0.002, seed=seed)
        got = bench.shared_prefix_requests(10, vocab, **args)
        want = jbench.shared_prefix_requests(10, vocab, **args)
    assert len(got) == len(want)
    for (ta, pa), (tb, pb) in zip(got, want):
        assert ta == tb
        assert pa.dtype == pb.dtype and np.array_equal(pa, pb)


def test_sampling_params_mix_equals_the_reference():
    fields = ("temperature", "top_p", "top_k", "min_p", "seed", "max_tokens")
    for i in range(12):
        got, want = bench.sampling_params_mix(i), jbench.sampling_params_mix(i)
        assert ({f: getattr(got, f) for f in fields}
                == {f: getattr(want, f) for f in fields}), i


def test_provenance_names_torch_and_cuda_not_jax():
    stamp = bench.bench_provenance(timestamp=12.34567, git_sha="abc")
    assert stamp["schema_version"] == jbench.BENCH_SCHEMA_VERSION
    prov = stamp["provenance"]
    assert set(prov) == {"git_sha", "timestamp", "torch", "cuda", "python",
                         "platform", "device_kind"}
    assert prov["git_sha"] == "abc" and prov["timestamp"] == 12.346
    assert prov["torch"] == torch.__version__
    info = build_info()
    assert not {"jax", "jaxlib"} & set(info)
    assert info["cuda"] == torch.version.cuda
    if not torch.cuda.is_available():
        assert (info["platform"], info["device_kind"]) == ("cpu", "cpu")


class _Handle:
    """What the helpers read of a request handle."""

    def __init__(self, tokens, admit=None, finish=None):
        self.tokens, self.admit_time, self.finish_time = tokens, admit, finish


def test_small_helpers():
    """`_round_if_present`, `_token_agreement` and `_peak_concurrency`
    give the reference's results on the same inputs."""
    for snap, digits in (({"a": 1.23456}, 2), ({"a": 7.0}, 0), ({}, 3),
                         ({"b": 1.0}, 2)):
        assert (bench._round_if_present(snap, "a", "out", digits)
                == jbench._round_if_present(snap, "a", "out", digits))
    pairs = [([_Handle([1, 2, 3])], [_Handle([1, 5, 3])]),
             ([_Handle([])], [_Handle([])]),
             ([_Handle([4, 4]), _Handle([1])], [_Handle([4]), _Handle([1, 2])])]
    for ref, got in pairs:
        assert (bench._token_agreement(ref, got)
                == jbench._token_agreement(ref, got))
    spans = [_Handle([], 0, 3), _Handle([], 1, 2), _Handle([], 2.5, 4),
             _Handle([], None, 1)]
    assert (bench._peak_concurrency(spans)
            == jbench._peak_concurrency(spans) == 2)


@pytest.mark.parametrize("seed", range(6))
def test_peak_concurrency_equals_the_reference(seed):
    """Seeded [admit, finish) sets on a coarse clock, so that admits and
    finishes tie, with unfinished and unadmitted handles among them: the
    paged workload's headline (`capacity_peak_active_slots`) equals the
    reference's count."""
    rng = np.random.default_rng(seed)
    handles = []
    for _ in range(int(rng.integers(1, 40))):
        admit = float(rng.integers(0, 12))
        finish = admit + float(rng.integers(0, 6))
        kind = rng.integers(0, 6)
        handles.append(_Handle([], None if kind == 0 else admit,
                               None if kind == 1 else finish))
    assert bench._peak_concurrency(handles) == jbench._peak_concurrency(handles)


@pytest.mark.parametrize("config,paged", [
    ("gpt_tiny", False), ("gpt_tiny", True), ("llama3_markov", False),
    ("dsv3_markov", True)])
def test_kv_entry_fields_equal_the_reference(config, paged):
    """The KV triple from the port's pool equals the reference's from its
    own pool of the same shape: dtype name, pool bytes, agreement."""
    jmodel = jfactory.build_model(jreg.get_config(config))
    model, _ = bench.build_serve_model(config, "cpu")
    if paged:
        pools = (jkv.PagedKVPool(jmodel, 3, 32, 16, page_budget=4),
                 kv_pool.PagedKVPool(model, 3, 32, 16, page_budget=4))
    else:
        pools = (jkv.KVSlotPool(jmodel, 3, 32),
                 kv_pool.KVSlotPool(model, 3, 32))
    want, got = (f(types.SimpleNamespace(pool=pool), 0.91234)
                 for f, pool in zip((jbench._kv_entry_fields,
                                     bench._kv_entry_fields), pools))
    assert got == want


def test_paired_runs_keep_the_abba_order(monkeypatch):
    seen = []

    def fake(model, requests, cfg, max_new, params_for=None):
        seen.append(cfg)
        return len(seen), {"n": len(seen)}, {"kv_pool_bytes": cfg}, []

    monkeypatch.setattr(bench, "_engine_arm_stats", fake)
    model = torch.nn.Linear(1, 1)
    model.device = torch.device("cpu")
    arms = bench._Arms(model.device)
    runs, kv = bench._paired_arm_stats(model, [], "on", "off", 4, reps=4,
                                       arms=arms, names=("a", "b"))
    assert seen == ["on", "off", "off", "on", "on", "off", "off", "on"]
    assert [mk for mk, _ in runs["on"]] == [1, 4, 5, 8]
    assert [mk for mk, _ in runs["off"]] == [2, 3, 6, 7]
    assert [snap["n"] for _, snap in runs["on"]] == [1, 4, 5, 8]
    assert kv == {"on": {"kv_pool_bytes": "on"},
                  "off": {"kv_pool_bytes": "off"}}
    assert list(arms.log) == ["a[0]", "b[0]", "b[1]", "a[1]", "a[2]", "b[2]",
                              "b[3]", "a[3]"]


# ------------------------------------------------------------ workloads


@contextlib.contextmanager
def _no_collector():
    """Runs a workload with the cycle collector off and then asserts that
    no engine or pool of it is left: each arm's engine frees when dropped,
    so an arm's peak on the card holds no earlier arm's pool."""
    gc.collect()
    gc.disable()
    try:
        yield
        left = [type(o).__name__ for o in gc.get_objects()
                if isinstance(o, (ServeEngine, kv_pool.KVSlotPool,
                                  kv_pool.PagedKVPool))]
        assert not left, left
    finally:
        gc.enable()


def _detail_keys_hold(result, workload):
    assert set(result) == TOP
    d = result["detail"]
    assert set(d) - {"decomposition_clamped"} == _cpu_keys(workload), workload
    assert d["decode_step_wall_s"] > 0
    if "gather_share_pct" in d:
        # the shares partition the step (clamped or not), up to rounding
        assert abs(sum(d[k] for k in SHARES) - 100.0) < 0.05, d
        assert d.get("decomposition_clamped", True) is True
    json.dumps(result)  # every value serialises (no NaN, no tensors)


def test_poisson_workload_keys_and_its_engine_streams_equal_generate():
    with _no_collector():
        result = bench.run_serve_bench(**SMALL)
    _detail_keys_hold(result, "serve")
    assert set(result["detail"]["arms"]) == {"probe", "engine", "sequential"}

    model, vocab = bench.build_serve_model(CFG, "cpu")
    assert vocab == get_config(CFG).model.vocab_size
    requests = bench.synthetic_requests(6, vocab, prompt_lens=(8, 16, 24),
                                        mean_interarrival_s=0.001)
    cfg = ServeConfig(n_slots=4, max_len=28, decode_block=4, bucket=24,
                      max_prefills_per_step=4)
    _, handles, _ = bench._run_engine_arm(model, requests, cfg, 4)
    for (_, prompt), h in zip(sorted(requests, key=lambda r: r[0]), handles):
        out = generate(model, torch.as_tensor(prompt)[None], max_new_tokens=4,
                       device="cpu")
        assert h.tokens == out[0, len(prompt):].tolist()


def test_prefix_workload_keys_and_hits():
    with _no_collector():
        result = bench.run_prefix_bench(config=CFG, n_requests=8, n_slots=4,
                                        max_new=4, decode_block=4,
                                        n_prefixes=2, device="cpu")
    _detail_keys_hold(result, "prefix")
    d = result["detail"]
    assert d["prefix_len"] == 48  # stretched to gpt_tiny's 64 positions
    assert d["cache_on_prefix_hit_rate"] > 0
    assert d["cache_on_tokens_prefilled_saved"] > 0
    assert d["cache_off_prefix_hit_rate"] == 0


def test_prefix_tree_holds_every_stem():
    """A cap too small for one stem still hits: the bench sizes the tree
    to hold every stem's page-aligned prompt (n_prefixes x prompt pages x
    the model's KV bytes a token)."""
    model, _ = bench.build_serve_model(CFG, "cpu")
    per_token = sum(t.numel() * t.element_size()
                    for c in model.init_caches(1, 1)
                    for t in (c.k, c.v))
    assert bench._tree_bytes(model, 1, 2, 56, 16) == 2 * 64 * per_token
    assert bench._tree_bytes(model, 1 << 30, 2, 56, 16) == 1 << 30
    result = bench.run_prefix_bench(config=CFG, n_requests=8, n_slots=4,
                                    max_new=4, decode_block=4, n_prefixes=2,
                                    prefix_cache_bytes=1, device="cpu")
    d = result["detail"]
    assert d["cache_on_prefix_hit_rate"] > 0
    assert d["cache_on_prefix_evictions"] == 0


def test_paged_workload_capacity_and_zero_copy_hits():
    """The capacity arm books pages, not lanes: with streams longer than
    their prompts (the reference's `cap_new = max(8, max_new // 4)`),
    twice the slots at the lane pool's bytes hold more concurrent
    streams than the lane pool has slots. The paged prefix hits share
    pages: no splice or extract copy, while the lane pool's hits copy."""
    before = dict(kv_pool.PREFIX_COPIES)
    with _no_collector():
        result = bench.run_paged_bench(
            config=CFG, n_requests=6, n_slots=2, max_new=48, decode_block=4,
            prompt_lens=(16,), n_prefixes=2, prefix_requests=6, reps=1,
            device="cpu")
    _detail_keys_hold(result, "paged")
    d = result["detail"]
    assert d["capacity_peak_active_slots"] > d["n_slots"]
    # equal bytes: the lane pool's pages, plus the paged pool's trash page
    budget = d["capacity_page_budget"]
    assert (d["capacity_kv_pool_bytes"] * budget
            == d["lane_kv_pool_bytes"] * (budget + 1))
    assert d["splice_programs_dispatched"] == 0
    assert d["paged_prefix_hit_rate"] > 0
    # the lane cache-on arm of pair B did copy: the counter sees copies
    assert sum(kv_pool.PREFIX_COPIES.values()) > sum(before.values())
    assert result["value"] == d["capacity_peak_active_slots"]


def test_sampling_workload_keys():
    with _no_collector():
        result = bench.run_sampling_bench(**SMALL)
    _detail_keys_hold(result, "sampling")
    assert result["detail"]["greedy_tokens_per_sec"] > 0


def test_slo_workload_keys_and_attainment():
    with _no_collector():
        result = bench.run_slo_bench(**SMALL, reps=1)
    _detail_keys_hold(result, "slo")
    d = result["detail"]
    assert set(d["arms"]) == {"probe", "slo[0]", "plain[0]"}
    assert sum(c["finished"] for c in d["attainment_by_class"].values()) == 6
    assert result["metric"] == "serve_slo_goodput_tokens_per_s"


def test_traced_arm_and_status_port_keys(tmp_path):
    """`trace=True` adds the traced arm's fields and writes its Chrome
    trace; `status_port` keeps the probe engine serving /healthz for the
    run and closes it at the end."""
    out = str(tmp_path / "t.json")
    seen = {}
    real = bench._release_probe

    def release(eng, hold_s=0.0):
        with urllib.request.urlopen(eng.status.url("/healthz"), timeout=30) as r:
            seen["healthz"] = r.status
        real(eng, hold_s)
        seen["closed"] = eng.status is None

    bench._release_probe = release
    try:
        result = bench.run_serve_bench(**SMALL, trace=True, trace_out=out,
                                       status_port=0)
    finally:
        bench._release_probe = real
    assert set(result["detail"]) == _cpu_keys("serve") | TRACED | STATUS
    assert result["detail"]["trace_events"] > 0
    assert json.load(open(out))["traceEvents"]
    assert seen == {"healthz": 200, "closed": True}


def test_http_workload_keys_and_exact_streams():
    with _no_collector():
        result = bench.run_http_bench(**SMALL, reps=1)
    _detail_keys_hold(result, "http")
    d = result["detail"]
    assert d["stream_token_exact"] is True and "stream_first_diff" not in d
    assert set(d["arms"]) == {"probe", "http[0]", "direct[0]"}


def _freed_on_drop(make) -> bool:
    """Whether the pool of the engine `make()` returns (after it served
    two requests that share a prefix), and its prefix tree's nodes, are
    freed as soon as the engine and what `make` returned are dropped,
    with the cycle collector off."""
    model, _ = bench.build_serve_model(CFG, "cpu")
    gc.collect()
    gc.disable()
    try:
        eng, owner = make(model)
        # the second prompt hits the first's cached 16 tokens and splits
        # its 24-token edge
        for prompt in (np.arange(24), np.r_[np.arange(16), 40 + np.arange(8)]):
            eng.submit(prompt, max_new_tokens=4)
            eng.run()
        eng.metrics.snapshot()
        refs = [weakref.ref(eng.pool)]
        if eng.prefix_cache is not None:
            refs += [weakref.ref(n)
                     for n in eng.prefix_cache.root.children.values()]
        del eng, owner
        return all(ref() is None for ref in refs)
    finally:
        gc.enable()


def test_a_dropped_paged_engine_frees_before_the_next_arm():
    """A paged engine frees its pool when dropped: its metrics' gauge
    provider and its scheduler's page gate hold it weakly, so the next
    arm's peak does not hold it."""
    def make(model):
        eng = ServeEngine(model, ServeConfig(n_slots=2, max_len=32, bucket=8,
                                             paged=True, page_size=8),
                          device="cpu")
        return eng, None

    assert _freed_on_drop(make)


@pytest.mark.parametrize("layout", ["lane_prefix", "paged_prefix", "api"])
def test_dropped_engines_free_their_pools(layout):
    """So do a prefix-cache engine (its scheduler's lookup, its tree's
    parent links) and an engine behind a closed front door (the server's
    gauges and handler class)."""
    from solvingpapers_tpu_torch.serve.api import ApiServer

    paged = dict(paged=True, page_size=8) if layout == "paged_prefix" else {}
    tree = dict(prefix_cache=True, prefix_page=8) if "prefix" in layout \
        else {}

    def make(model):
        eng = ServeEngine(model, ServeConfig(n_slots=2, max_len=32, bucket=8,
                                             **paged, **tree), device="cpu")
        if layout != "api":
            return eng, None
        srv = ApiServer(eng)
        srv.close()
        return eng, srv

    assert _freed_on_drop(make)


def test_first_diff_names_request_position_and_tokens():
    class H:
        def __init__(self, tokens):
            self.tokens = tokens

    assert bench._first_diff([[1, 2], [3]], [H([1, 2]), H([3])]) is None
    assert bench._first_diff([[1, 2], [3, 4, 5]], [H([1, 2]), H([3, 9, 5])]) \
        == {"request": 1, "position": 1, "common": [3], "http": 4, "direct": 9}
    assert bench._first_diff([[1]], [H([1, 2])]) == {
        "request": 0, "position": 1, "common": [1], "http": None, "direct": 2}


def test_cli_serve_bench_writes_its_line(tmp_path, capsys):
    out = tmp_path / "bench.jsonl"
    rc = cli.main(["serve-bench", "--config", CFG, "--device", "cpu",
                   "--requests", "4", "--max-new-tokens", "4",
                   "--skip-sequential", "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(printed) == 1
    line = json.loads(out.read_text())
    assert line == json.loads(printed[0])
    assert line["metric"] == "serve_requests_per_sec"
    assert "vs_baseline" not in line and "jax" not in line["provenance"]
    # gpt_tiny's 64 positions keep 16 32 48 of the default cycle
    assert line["detail"]["prompt_lens"] == [16, 32, 48]
    rc = cli.main(["serve-bench", "--config", CFG, "--device", "cpu",
                   "--requests", "4", "--max-new-tokens", "4", "--sampling",
                   "--max-seq-len", "40", "--prompt-lens", "8", "16",
                   "--out", str(out), "--append"])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert rc == 0 and [x["metric"] for x in lines] == [
        "serve_requests_per_sec", "serve_sampling_requests_per_sec"]


@pytest.mark.parametrize("workload", ["chaos", "journal", "replay", "fleet"])
def test_durability_workloads_keys_and_invariants(tmp_path, workload):
    small = dict(SMALL, n_requests=8, max_new=8)
    if workload == "chaos":
        result = bench.run_chaos_bench(**small, stall_s=0.3, reps=1,
                                       mean_interarrival_s=0.001)
        d = result["detail"]
        assert d["survivors_token_exact"] and d["ladder_zero_leak"]
        assert d["journal_degraded_exercised"] in (True, False)
    elif workload == "journal":
        result = bench.run_journal_bench(**small, reps=1)
        d = result["detail"]
        assert d["recovered_token_exact"] and d["live_at_kill"] > 0
        assert d["recovered_requests"] == d["live_at_kill"]
    elif workload == "replay":
        result = bench.run_replay_bench(**{**small, "prompt_lens": (8, 16)},
                                        train_steps=2)
        d = result["detail"]
        assert d["replay_byte_exact"] and d["replay_byte_exact_rate_lane"] == 1.0
        assert d["identical_agreement_rate"] == 1.0 and not d["replay_diverged"]
        # the int8 candidate: graded by its teacher-forced greedy agreement
        assert result["value"] == d["replay_agreement_rate"]
        assert 0.0 <= d["replay_agreement_rate"] <= 1.0
        assert "replay_quant" in d["arms"]
        assert d["replay_streams_compared"] == 8
        assert set(d["arms"]) >= {"train", "record_lane", "record_paged",
                                  "replay_lane", "replay_paged"}
    else:
        trace = str(tmp_path / "fleet.json")
        # two slots a replica: a second wave is still live when a third of
        # the requests have finished
        result = bench.run_fleet_bench(**{**small, "n_slots": 2}, reps=1,
                                       trace_out=trace)
        d = result["detail"]
        assert d["migrated_token_exact"] and d["fleet_token_exact"]
        assert d["migrated_streams"] == d["live_at_drain"] > 0
        assert d["trail_partition_ok"] and d["zero_leak_peers"]
        assert cli.main(["trace-summary", trace, "--fleet"]) == 0
    assert d["zero_leak"] and d.get("slots_clean", True)
    _detail_keys_hold(result, workload)


def test_quant_workload_keys_bytes_and_capacity():
    """`run_quant_bench` at a tiny size: the reference's keys less the
    named left-out set, the quantized pool's bytes analytic (int8 codes
    and scales at most 0.6 of the float32 pool), the capacity arm's pool
    within the plain paged pool's bytes and holding more live streams
    than the exact engine's slots."""
    result = bench.run_quant_bench(**{**SMALL, "max_new": 8}, train_steps=2,
                                   reps=1)
    d = result["detail"]
    assert d["kv_dtype"] == "int8" and d["kv_bytes_ratio"] <= 0.6
    assert d["capacity_kv_pool_bytes"] <= d["f32_paged_kv_pool_bytes"]
    assert d["capacity_peak_active_slots"] > d["n_slots"]
    assert result["value"] == d["capacity_peak_active_slots"]
    assert 0.0 <= d["greedy_agreement_rate"] <= 1.0
    assert all(k in d["notes"] for k in bench.QUANT_LEFT_OUT)
    assert {"quality_quant", "quality_cuts", "capacity"} <= set(d["arms"])
    _detail_keys_hold(result, "quant")


def test_spec_workload_keys_and_exact_streams():
    """`run_spec_bench` at a tiny size: the reference's keys less the
    probe's XLA fields, spec-on greedy streams token-exact with spec-off,
    drafts accepted on the memorized sentence."""
    with _no_collector():
        result = bench.run_spec_bench(
            **{**SMALL, "prompt_lens": (24, 32), "max_new": 24},
            spec_k=4, spec_rounds=3, train_steps=10, reps=1)
    d = result["detail"]
    assert d["greedy_token_exact"] is True
    assert d["acceptance_rate"] > 0 and d["spec_tokens_per_step"] > 1
    assert result["value"] == d["spec_tokens_per_sec"]
    assert {"train", "spec[0]", "plain[0]", "adv_spec[0]",
            "adv_plain[0]"} <= set(d["arms"])
    _detail_keys_hold(result, "spec")


@pytest.mark.parametrize("argv,code,item", [
    (["--speculative", "--obs"], 2, "ROADMAP A8"),
    (["--kv-quant", "int8", "--paged"], 2, "pick one per run"),
    (["--speculative", "--kv-quant", "int8"], 2, "pick one per run"),
    (["--spec-rounds", "2", "--obs-hlo-dir=d"], 2, "ROADMAP A8"),
    (["--spec-train-steps", "3", "--speculative", "--http"], 2,
     "pick one per run"),
    (["--kv-quant-block", "8", "--spec-k", "2", "--obs"], 2, "ROADMAP A8"),
    (["--quant-train-steps=3", "--speculative", "--checkpoint-dir", "ck"], 2,
     "not consumed"),
    (["--obs"], 2, "ROADMAP A8"),
    (["--chaos", "--fleet"], 2, "pick one per run"),
    (["--obs-hlo-dir", "d"], 2, "ROADMAP A8"),
    (["--paged", "--http"], 2, "pick one per run"),
    (["--checkpoint-dir", "ck"], 2, "not consumed"),
])
def test_serve_bench_refusals_exit_2(capsys, argv, code, item):
    rc = cli.main(["serve-bench", "--config", CFG, "--device", "cpu", *argv])
    captured = capsys.readouterr()
    assert rc == code and not captured.out and item in captured.err


# ------------------------------------------------------------ profiler


def _traces(directory, stem):
    return sorted(glob.glob(os.path.join(str(directory), f"{stem}.*.json")))


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_engine_profile_window_writes_one_trace(tmp_path):
    model, vocab = bench.build_serve_model(CFG, "cpu")
    cfg = ServeConfig(n_slots=2, max_len=32, decode_block=2, bucket=8,
                      profile_dir=str(tmp_path), profile_steps=(1, 2))
    eng = ServeEngine(model, cfg, device="cpu")
    for i in range(3):
        eng.submit(np.arange(8) + i, max_new_tokens=6)
    eng.run()
    assert eng.config.profile_steps == (1, 2)
    [path] = _traces(tmp_path, "serve")
    assert eng.profile.path == path
    names = {e.get("name") for e in _events(path)}
    assert "serve/decode_block" in names
    # one window a lifetime: more steps open none
    eng.submit(np.arange(8), max_new_tokens=6)
    eng.run()
    assert len(_traces(tmp_path, "serve")) == 1


def test_engine_stop_profile_closes_an_open_window(tmp_path):
    model, _ = bench.build_serve_model(CFG, "cpu")
    cfg = ServeConfig(n_slots=2, max_len=32, decode_block=2, bucket=8,
                      profile_dir=str(tmp_path), profile_steps=(0, 100))
    eng = ServeEngine(model, cfg, device="cpu")
    eng.submit(np.arange(8), max_new_tokens=4)
    eng.step()
    assert eng.profile.is_open and not _traces(tmp_path, "serve")
    eng.close()
    assert not eng.profile.is_open and len(_traces(tmp_path, "serve")) == 1


def test_trainer_profile_window_writes_one_trace(tmp_path):
    from solvingpapers_tpu_torch.configs.factory import (
        build_char_lm_run,
        loss_fn_for,
    )
    from solvingpapers_tpu_torch.train import Trainer

    run = get_config(CFG, steps=3, log_every=1, eval_every=0,
                     profile_dir=str(tmp_path), profile_steps=(1, 2))
    run, model, _, train_iter, _ = build_char_lm_run(run, device="cpu")
    Trainer(model, run.train, loss_fn=loss_fn_for(run),
            device="cpu").fit(train_iter, writer=_Quiet())
    [path] = _traces(tmp_path, "train")
    assert len(_events(path)) > 0


class _Quiet:
    def write(self, step, metrics):
        pass

    def close(self):
        pass


def test_no_profile_dir_opens_no_profiler(monkeypatch, tmp_path):
    from solvingpapers_tpu_torch.configs.factory import (
        build_char_lm_run,
        loss_fn_for,
    )
    from solvingpapers_tpu_torch.train import Trainer

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler opened without profile_dir")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.chdir(tmp_path)
    model, _ = bench.build_serve_model(CFG, "cpu")
    eng = ServeEngine(model, ServeConfig(n_slots=2, max_len=32, bucket=8),
                      device="cpu")
    eng.submit(np.arange(8), max_new_tokens=4)
    eng.run()
    assert eng.profile is None
    run = get_config(CFG, steps=2, log_every=1, eval_every=0)
    run, model, _, train_iter, _ = build_char_lm_run(run, device="cpu")
    Trainer(model, run.train, loss_fn=loss_fn_for(run),
            device="cpu").fit(train_iter, writer=_Quiet())
    assert os.listdir(tmp_path) == []


def test_the_reference_train_config_has_the_same_profile_fields():
    from solvingpapers_tpu.train.engine import TrainConfig as JTrainConfig
    from solvingpapers_tpu_torch.train import TrainConfig

    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.name.startswith("profile")}

    assert defaults(TrainConfig) == defaults(JTrainConfig)
    assert {k: getattr(ServeConfig(), k) for k in defaults(TrainConfig)} \
        == defaults(JTrainConfig)
