"""Models and helpers shared by the port's durability tests
(`test_torch_faults.py`, `test_torch_journal.py`, `test_torch_trace.py`,
`test_torch_slo.py`).

`gpt_tiny_pair()` is the registry's `gpt_tiny` (vocab 64, dim 64, 2
layers, float32) in both packages on one set of weights: the JAX
package's (jitted) initialisation from key 0, carried to the port by
`convert.flax_to_torch`. `port_model()` is the same configuration with
the port's own initialisation (no JAX), for the port-only tests, and
`port_dsv3()` a toy DeepSeek-V3 for its latent cache. Each is built once
a process.
"""

import functools

import numpy as np

VOCAB = 64


@functools.lru_cache(maxsize=1)
def gpt_tiny_pair():
    """(JAX model, its params, the port's model in eval mode)."""
    import jax
    import jax.numpy as jnp

    from solvingpapers_tpu.configs import get_config as jget_config
    from solvingpapers_tpu.models.gpt import GPT as JGPT
    from solvingpapers_tpu_torch.convert import flax_to_torch
    from solvingpapers_tpu_torch.models import GPT, GPTConfig

    jcfg = jget_config("gpt_tiny").model
    jm = JGPT(jcfg)
    # jitted: an eager init compiles every op on its own (~10 s a process)
    params = jax.jit(jm.init)({"params": jax.random.key(0)},
                              jnp.zeros((1, 8), jnp.int32))["params"]
    fields = {k: getattr(jcfg, k) for k in ("vocab_size", "block_size", "dim",
                                            "n_layers", "n_heads", "mlp_mult",
                                            "dropout", "dtype")}
    tm = GPT(GPTConfig(**fields), device="cpu")
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


@functools.lru_cache(maxsize=1)
def port_model():
    """The port's gpt_tiny, float32, random weights from seed 0."""
    import torch

    from solvingpapers_tpu_torch.configs import get_config
    from solvingpapers_tpu_torch.models import GPT, init_params_for

    cfg = get_config("gpt_tiny").model
    model = GPT(cfg, device="cpu")
    model.load_state_dict(init_params_for(cfg)(cfg, torch.Generator().manual_seed(0)))
    return model.eval()


@functools.lru_cache(maxsize=1)
def port_dsv3():
    """A DeepSeek-V3 of the port at toy size (vocab 64, dim 64, 2 layers,
    latent 8, decoupled RoPE 8, 4 experts top-2), float32, random weights
    from seed 0, at a capacity factor of n_experts / top_experts: no
    pair drops, so a prefill routes each token as a decode step does."""
    import torch

    from solvingpapers_tpu_torch.models.deepseekv3 import (
        DeepSeekV3,
        DeepSeekV3Config,
        init_params,
    )

    cfg = DeepSeekV3Config(vocab_size=VOCAB, block_size=64, dim=64, n_layers=2,
                           n_heads=4, latent_dim=8, rope_dim=8, n_experts=4,
                           top_experts=2, capacity_factor=2.0, dtype="float32",
                           use_flash=True, dropout=0.0, attn_dropout=0.0,
                           pe_scale=0.02)
    model = DeepSeekV3(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return model.eval()


def prompts(n, seed, lo=4, hi=17):
    r = np.random.default_rng(seed)
    return [r.integers(0, VOCAB, size=int(r.integers(lo, hi))).astype(np.int64)
            for _ in range(n)]


# the engine shape every durability test serves at: 3 slots, blocks of 4,
# buckets of 8, 48 positions
BASE = dict(n_slots=3, max_len=48, decode_block=4, bucket=8)
PAGED = dict(paged=True, page_size=8)


def port_engine(model=None, **kw):
    from solvingpapers_tpu_torch.serve import ServeConfig, ServeEngine

    model = port_model() if model is None else model
    return ServeEngine(model, ServeConfig(**{**BASE, **kw}),
                       device="cpu")


def drive(eng, prompts_, new=10, **submit_kw):
    """Submit every prompt, then step until the engine drains (bounded)."""
    reqs = [eng.submit(p, max_new_tokens=new, **submit_kw) for p in prompts_]
    for _ in range(400):
        if not eng.has_work():
            break
        eng.step()
    assert not eng.has_work(), "the engine did not drain in 400 steps"
    return reqs


def no_leaks(eng):
    """Every slot free and, on a paged pool with the tree cleared, every
    page free and only the trash page held."""
    pool = eng.pool
    if pool.n_active:
        return False
    if not eng.config.paged:
        return True
    if eng.prefix_cache is not None:
        while eng.prefix_cache.evict_one():
            pass
    return (pool.pages_free == pool.page_budget
            and int(pool.refcount.sum()) == 1)
