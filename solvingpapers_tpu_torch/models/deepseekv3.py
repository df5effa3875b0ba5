"""DeepSeek-V3-style decoder: MLA + MoE (port of
`solvingpapers_tpu/models/deepseekv3.py`, its uncached training and
evaluation paths).

* Multi-head latent attention with absorbed queries: scores are
  ``(x W_q W_k^T) . latent`` and the context is ``probs @ latent``,
  decompressed per head by W_v only at the output. With the decoupled-RoPE
  branch (`rope_dim` R > 0) a rotary query per head and one shared rotary
  key ride along: k = v = cat(latent, k_rope), one kv head of width L + R,
  so absorbed-query MLA *is* MQA over the latent stream and the flash
  kernels serve it directly (`use_flash`); the dense branch computes the
  same function with einsums.
* Top-k MoE over stacked (E, ...) SwiGLU experts with a shared expert and
  the aux-free routing bias (a float32 buffer), dispatched to capacity
  slots by `ops.moe`.
* Sinusoidal PE (times `pe_scale`) added to the embedding, per-layer
  remat, final dropout, the 2 * L^-0.5 depth scaling, RMSNorm, and the
  head tied to the embedding.

Randomness and state under remat. A checkpointed layer runs twice, so
its dropout masks are pure functions of a seed passed in (the flash
kernels' keep function, `kernels.dropout`), and the routing bias is never
changed inside the forward: a training forward returns each layer's new
bias (``bias + rate * sign(mean(c) - c)``) in its stats, and the trainer
installs it after the optimizer step — the reference's functional
`moe_state` update.

Not ported (raise, naming their ROADMAP items): the latent cache and
cached MLA serving, multi-token prediction and `noisy_topk` (A6), context
parallelism and expert parallelism (A7).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.kernels.dropout import dropout, mix_seed
from solvingpapers_tpu_torch.models.layers import (
    GLUFFN,
    Dense,
    Embed,
    RMSNorm,
    apply_flash_attention,
    default_positions,
    maybe_remat,
    swiglu_hidden_dim,
)
from solvingpapers_tpu_torch.models.llama3 import _lecun_normal

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the per-layer MoE stats a training step reports, averaged over layers
MOE_METRICS = ("load_entropy", "load_max_fraction", "drop_fraction", "bias_norm")


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config:
    """The reference's config, field for field (see its docstrings)."""

    vocab_size: int = 50257
    block_size: int = 256
    dim: int = 512
    n_layers: int = 6
    n_heads: int = 8
    latent_dim: int = 64
    n_experts: int = 8
    top_experts: int = 2
    rope_dim: int = 0
    rope_theta: float = 10000.0
    pe_scale: float = 1.0
    use_shared_expert: bool = True
    noisy_topk: bool = False
    use_aux_free: bool = True
    aux_free_bias_update_rate: float = 0.001
    balance_loss_weight: float = 0.0
    moe_impl: str = "dispatch"  # dispatch | dense
    capacity_factor: float = 2.0
    mtp_heads: int = 0
    mtp_loss_weight: float = 0.3
    dropout: float = 0.1
    attn_dropout: float = 0.1
    remat: bool = False
    use_flash: bool = False
    context_parallel: bool = False
    ep_impl: str = "sliced"
    norm_eps: float = 1e-6
    dtype: str = "float32"

    def __post_init__(self):
        if self.ep_impl not in ("sliced", "all_to_all"):
            raise ValueError(
                f"ep_impl must be 'sliced' or 'all_to_all', got {self.ep_impl!r}")
        if self.moe_impl not in ("dispatch", "dense"):
            raise ValueError(
                f"moe_impl must be 'dispatch' or 'dense', got {self.moe_impl!r}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def expert_hidden(self) -> int:
        return swiglu_hidden_dim(self.dim)  # ((2D)*4)//3


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class MLA(nn.Module):
    """Multi-head latent attention with absorbed queries and optional
    decoupled RoPE. Raw einsum weights keep Flax's layouts: w_q (dim, N,
    hd), w_k and w_v (L, N, hd), w_qr (dim, N, R)."""

    def __init__(self, cfg: DeepSeekV3Config, rope, device=None,
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        stored = param_dtype or dt
        n, hd, lat, r = cfg.n_heads, cfg.head_dim, cfg.latent_dim, cfg.rope_dim
        kw = dict(dtype=dt, param_dtype=param_dtype, device=device)
        self.w_dkv = Dense(cfg.dim, lat, **kw)
        self.w_q = _empty((cfg.dim, n, hd), stored, device)
        self.w_k = _empty((lat, n, hd), stored, device)
        self.w_v = _empty((lat, n, hd), stored, device)
        if r:
            self.w_qr = _empty((cfg.dim, n, r), stored, device)
            self.w_kr = Dense(cfg.dim, r, **kw)
        self.rope = rope
        self.out = Dense(n * hd, cfg.dim, **kw)

    def forward(self, x, positions, seed, deterministic):
        cfg = self.cfg
        b, s, _ = x.shape
        n, hd, lat, r = cfg.n_heads, cfg.head_dim, cfg.latent_dim, cfg.rope_dim
        dt = cfg.compute_dtype
        xd = x.to(dt)
        latent = self.w_dkv(x)  # (B, S, L)
        q = (xd @ self.w_q.to(dt).reshape(cfg.dim, n * hd)).view(b, s, n, hd)
        # absorbed query: q projected into latent space once per head
        q_lat = torch.einsum("bsnh,lnh->bsnl", q, self.w_k.to(dt))
        if r:
            cos, sin = self.rope
            q_rope = (xd @ self.w_qr.to(dt).reshape(cfg.dim, n * r)).view(b, s, n, r)
            q_rope = ops.apply_rope(q_rope, cos, sin, positions=positions)
            k_rope = self.w_kr(x)
            k_rope = ops.apply_rope(k_rope[:, :, None, :], cos, sin,
                                    positions=positions)[:, :, 0]
            q_lat = torch.cat([q_lat, q_rope.to(dt)], dim=-1)
            latent = torch.cat([latent.to(dt), k_rope.to(dt)], dim=-1)
        scale = (hd + r) ** -0.5 if r else hd**-0.5
        drop = cfg.attn_dropout > 0.0 and not deterministic
        attn_seed = mix_seed(seed, 0) if drop else 0

        if cfg.use_flash:
            c_kv = latent.to(dt)[:, :, None, :]  # (B, S, 1, L[+R])
            ctx = apply_flash_attention(
                q_lat, c_kv, c_kv, causal=True, scale=scale,
                dropout_rate=cfg.attn_dropout, dropout_seed=attn_seed,
                deterministic=deterministic).to(dt)
        else:
            c = latent.to(dt)
            scores = torch.einsum("bsnl,btl->bnst", q_lat, c).float() * scale
            idx = torch.arange(s, device=x.device)
            scores = scores.masked_fill(~(idx[:, None] >= idx[None, :]),
                                        ops.BIG_NEG)
            probs = torch.softmax(scores, dim=-1)
            if drop:  # the flash kernels' mask: element (b * N + h, q, kv)
                probs = dropout(probs, cfg.attn_dropout, attn_seed)
            ctx = torch.einsum("bnst,btl->bsnl", probs.to(dt), c)

        if r:
            ctx = ctx[..., :lat]  # values decompress from the latent part
        out = torch.einsum("bsnl,lnh->bsnh", ctx, self.w_v.to(dt))
        out = self.out(out.reshape(b, s, n * hd))
        if drop:
            out = dropout(out, cfg.attn_dropout, mix_seed(seed, 1))
        return out


class MoELayer(nn.Module):
    """Top-k MoE with a shared expert and aux-free load balancing: a
    float32 gate, selection and softmax weights over the biased logits,
    stacked SwiGLU experts w3(swish(w1 x) * (w2 x)) (Flax's (E, D, H)
    layouts), the `routing_bias` buffer."""

    def __init__(self, cfg: DeepSeekV3Config, device=None, param_dtype=None):
        super().__init__()
        if cfg.noisy_topk:
            raise NotImplementedError(
                "noisy top-k gating is not ported (ROADMAP A6)")
        self.cfg = cfg
        dt = cfg.compute_dtype
        stored = param_dtype or dt
        d, h, e = cfg.dim, cfg.expert_hidden, cfg.n_experts
        self.gate = Dense(d, e, dtype=torch.float32, param_dtype=torch.float32,
                          device=device)
        self.register_buffer("routing_bias",
                             torch.zeros(e, dtype=torch.float32, device=device))
        self.w1 = _empty((e, d, h), stored, device)
        self.w2 = _empty((e, d, h), stored, device)
        self.w3 = _empty((e, h, d), stored, device)
        self.shared_expert = (
            GLUFFN(d, h, ops.swish, dtype=dt, param_dtype=param_dtype,
                   device=device) if cfg.use_shared_expert else None)

    def forward(self, x, deterministic):
        """(B, S, D) -> ((B, S, D) in x's dtype, stats). stats is None
        when `deterministic`; in training it holds the layer's routing
        stats (`MOE_METRICS`, `ci`), `new_bias` (with aux-free balancing)
        and `balance_loss` (differentiable; when its weight is set)."""
        cfg = self.cfg
        b, s, d = x.shape
        dt = cfg.compute_dtype
        xt = x.reshape(b * s, d).to(dt)
        gate_logits = self.gate(xt.float())
        bias = self.routing_bias
        biased = gate_logits + bias if cfg.use_aux_free else gate_logits
        probs = ops.moe.topk_gate_probs(biased, cfg.top_experts)
        w1, w2, w3 = (w.to(dt) for w in (self.w1, self.w2, self.w3))

        cap = None
        if cfg.moe_impl == "dense":
            def expert_fn_all(t):  # (T, D) -> (E, T, D)
                a, g = torch.matmul(t, w1), torch.matmul(t, w2)
                return torch.matmul(ops.swish(a) * g, w3)

            out = ops.moe.moe_dense_combine(xt, probs, expert_fn_all)
        else:
            def expert_fn(xe):  # (E, C, D) -> (E, C, D)
                a, g = torch.bmm(xe, w1), torch.bmm(xe, w2)
                return torch.bmm(ops.swish(a) * g, w3)

            cap = ops.moe.expert_capacity(b * s, cfg.n_experts,
                                          cfg.top_experts, cfg.capacity_factor)
            out = ops.moe.moe_dispatch_combine(xt, probs, expert_fn, cap)
        if self.shared_expert is not None:
            out = out + self.shared_expert(xt)
        out = out.reshape(b, s, d).to(x.dtype)
        if deterministic:
            return out, None

        ci = ops.moe.expert_load(probs)
        stats = ops.moe.load_balance_stats(probs, ci=ci)
        stats["ci"] = ci
        stats["drop_fraction"] = (
            torch.zeros((), device=x.device) if cap is None
            else ops.moe.dispatch_drop_fraction(probs, cap))
        if cfg.use_aux_free:
            new_bias = ops.moe.aux_free_bias_update(
                probs, bias, cfg.aux_free_bias_update_rate, ci=ci)
            stats["new_bias"] = new_bias
            stats["bias_norm"] = torch.linalg.norm(new_bias)
        else:
            stats["bias_norm"] = torch.linalg.norm(bias)
        if cfg.balance_loss_weight > 0.0:
            sel_frac = (probs > 0.0).float().mean(0)
            f = sel_frac * (cfg.n_experts / cfg.top_experts)
            p_full = torch.softmax(gate_logits.float(), dim=-1).mean(0)
            stats["balance_loss"] = (f * p_full).sum()
        return out, stats


class DSV3DecoderLayer(nn.Module):
    """Pre-RMSNorm MLA + residual; pre-RMSNorm MoE + residual."""

    def __init__(self, cfg: DeepSeekV3Config, rope, device=None,
                 param_dtype=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.dim, cfg.norm_eps, device=device)
        self.mla = MLA(cfg, rope, device=device, param_dtype=param_dtype)
        self.norm2 = RMSNorm(cfg.dim, cfg.norm_eps, device=device)
        self.moe = MoELayer(cfg, device=device, param_dtype=param_dtype)

    def forward(self, x, positions, seed):
        """`seed` None runs the layer deterministic (eval); an int seeds
        its dropout masks. Returns (x, MoE stats or None)."""
        deterministic = seed is None
        x = x + self.mla(self.norm1(x), positions, seed, deterministic)
        h, stats = self.moe(self.norm2(x), deterministic)
        return x + h, stats


class DeepSeekV3(nn.Module):
    """``DeepSeekV3(cfg, device=None, param_dtype=None)`` on `device`
    (default ``cuda``; raises when there is none), `param_dtype` as in
    `models.llama3.Llama` (float32 master weights for training)."""

    def __init__(self, cfg: DeepSeekV3Config,
                 device: str | torch.device | None = None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        if cfg.context_parallel or cfg.ep_impl != "sliced":
            raise NotImplementedError(
                "context and expert parallelism are not ported (ROADMAP A7)")
        if cfg.mtp_heads > 0:
            raise NotImplementedError(
                "multi-token prediction (mtp_heads > 0) is not ported "
                "(ROADMAP A6)")
        device = resolve_device(device)
        self.cfg = cfg
        rope = (ops.precompute_rope(cfg.rope_dim, cfg.block_size, cfg.rope_theta,
                                    device=device) if cfg.rope_dim else None)
        self.tok_emb = Embed(cfg.vocab_size, cfg.dim, dtype=cfg.compute_dtype,
                             param_dtype=param_dtype, device=device)
        self.register_buffer(
            "pe", ops.sinusoidal_position_encoding(cfg.block_size, cfg.dim,
                                                   device=device),
            persistent=False)
        self.layers = nn.ModuleList(
            DSV3DecoderLayer(cfg, rope, device=device, param_dtype=param_dtype)
            for _ in range(cfg.n_layers))
        self.norm_f = RMSNorm(cfg.dim, cfg.norm_eps, device=device)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    @property
    def max_positions(self) -> int:
        return self.cfg.block_size

    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                caches=None, attend_len: int | None = None,
                dropout_seed: int | None = None,
                return_stats: bool = False):
        """tokens (B, S) -> (logits (B, S, vocab) in the compute dtype,
        caches), or (logits, caches, stats) with `return_stats`: stats is
        the per-layer list of MoE stats dicts (None in eval mode).

        In training mode (`self.training`) dropout is active and
        `dropout_seed` must be given when a rate is > 0: layer i draws its
        masks from ``mix_seed(dropout_seed, i)``, the final dropout from
        ``mix_seed(dropout_seed, n_layers)``. Eval mode is deterministic."""
        cfg = self.cfg
        if caches is not None or attend_len is not None:
            raise NotImplementedError(
                "the latent cache and cached MLA serving are not ported "
                "(ROADMAP A6)")
        deterministic = not self.training
        if deterministic:
            dropout_seed = None
        elif dropout_seed is None:
            if cfg.dropout > 0.0 or cfg.attn_dropout > 0.0:
                raise ValueError("dropout_seed is required when dropout is "
                                 "active (training mode, a rate > 0)")
            dropout_seed = 0  # no mask is drawn; the seed only marks training
        b, s = tokens.shape
        if positions is None:
            positions = default_positions(b, s, max_positions=cfg.block_size,
                                          device=tokens.device)
        dt = cfg.compute_dtype
        x = self.tok_emb(tokens) + self.pe[positions].to(dt) * cfg.pe_scale
        stats = []
        for i, layer in enumerate(self.layers):
            run = maybe_remat(layer, cfg.remat)
            seed = None if deterministic else mix_seed(dropout_seed, i)
            x, st = run(x, positions, seed)
            stats.append(st)
        if cfg.dropout > 0.0 and not deterministic:
            x = dropout(x, cfg.dropout, mix_seed(dropout_seed, cfg.n_layers))
        x = x * (2.0 * cfg.n_layers**-0.5)  # deepseek depth scaling
        x = self.norm_f(x)
        logits = nn.functional.linear(x.to(dt), self.tok_emb.weight.to(dt))
        if return_stats:
            return logits, None, (None if deterministic else stats)
        return logits, None


def init_params(cfg: DeepSeekV3Config, generator: torch.Generator) -> dict:
    """Random float32 parameters from the reference's (Flax's)
    initializers, on the generator's device: normal(0.02) for the
    embedding, w_q, w_k, w_v, w_qr and the stacked experts; lecun_normal
    for every Dense kernel; ones for norm weights; a zero routing bias.
    The bits differ from a JAX init; the distributions are the same.
    Returns a state dict for `DeepSeekV3.load_state_dict`."""
    dev = generator.device
    d, n, hd, lat, r = (cfg.dim, cfg.n_heads, cfg.head_dim, cfg.latent_dim,
                        cfg.rope_dim)
    e, h = cfg.n_experts, cfg.expert_hidden

    def normal(*shape):
        return torch.empty(shape, device=dev).normal_(0.0, 0.02,
                                                      generator=generator)

    sd = {"tok_emb.weight": normal(cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        sd[p + "norm1.weight"] = torch.ones(d, device=dev)
        sd[p + "mla.w_dkv.weight"] = _lecun_normal((d, lat), generator, dev)
        sd[p + "mla.w_q"] = normal(d, n, hd)
        sd[p + "mla.w_k"] = normal(lat, n, hd)
        sd[p + "mla.w_v"] = normal(lat, n, hd)
        if r:
            sd[p + "mla.w_qr"] = normal(d, n, r)
            sd[p + "mla.w_kr.weight"] = _lecun_normal((d, r), generator, dev)
        sd[p + "mla.out.weight"] = _lecun_normal((n * hd, d), generator, dev)
        sd[p + "norm2.weight"] = torch.ones(d, device=dev)
        sd[p + "moe.gate.weight"] = _lecun_normal((d, e), generator, dev)
        sd[p + "moe.routing_bias"] = torch.zeros(e, device=dev)
        sd[p + "moe.w1"] = normal(e, d, h)
        sd[p + "moe.w2"] = normal(e, d, h)
        sd[p + "moe.w3"] = normal(e, h, d)
        if cfg.use_shared_expert:
            for name, shape in (("gate", (d, h)), ("up", (d, h)), ("down", (h, d))):
                sd[p + f"moe.shared_expert.{name}.weight"] = _lecun_normal(
                    shape, generator, dev)
    sd["norm_f.weight"] = torch.ones(d, device=dev)
    return sd


def routing_state(stats: list) -> dict:
    """The new routing biases of a training forward's stats, as
    {buffer name: tensor} for `Trainer` to install after its step."""
    return {f"layers.{i}.moe.routing_bias": st["new_bias"]
            for i, st in enumerate(stats) if st is not None and "new_bias" in st}


def moe_metrics(stats: list) -> dict:
    """Each MOE_METRICS stat averaged over layers, as moe_<name>."""
    stats = [st for st in stats if st is not None]
    if not stats:
        return {}
    return {f"moe_{k}": torch.stack([st[k].float() for st in stats]).mean()
            for k in MOE_METRICS}

