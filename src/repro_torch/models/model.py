"""The model of the ported architectures, in PyTorch.

The port of ``repro.models.model`` for every family of the JAX package:
the decoder-only GQA and MLA ones, the attention-free RWKV6 family, the
encoder-decoder family and the hybrid one:

    params = init_params(cfg, seed, device)
    logits, stats = forward(params, cfg, batch)            # train / prefill
    loss, stats = loss_fn(params, cfg, batch)              # train
    cache  = init_cache(cfg, batch_size, max_len, device)
    logits, cache = prefill(params, cfg, batch, cache)
    logits, cache = decode_step(params, cfg, tokens, cache, cache_len)

``family`` is ``"dense"`` (SwiGLU) or ``"moe"`` with ``attn="gqa"`` or
``"mla"`` (MiniCPM3, DeepSeek-V2: a compressed latent cache ``{"c_kv",
"k_pe"}``), ``"vlm"`` (the dense GQA decoder behind stubbed patch
embeddings, ``batch["patches"]`` ``[B, n_patches, d_model]`` prepended to
the token embeddings), or ``"ssm"`` (RWKV6 time-mix and channel-mix, the
recurrence through K6) with ``attn="none"``, or ``"encdec"`` (Whisper: a
bidirectional encoder over stubbed frame embeddings ``batch["frames"]``
``[B, enc_seq, d_model]`` plus learned positions, and a decoder whose
blocks also attend to the encoder's output, ``cache["enc_out"]`` when
serving).  Norms are RMS or LayerNorm (``cfg.norm``), the dense FFN
SwiGLU or a GELU MLP (``cfg.act``).  A MoE model may
have shared experts (``n_shared``) and ``first_k_dense`` SwiGLU layers
ahead of the MoE ones, kept in ``params["dense_blocks"]`` (and
``cache["dense_blocks"]``) as JAX keeps them; ``blocks`` holds the other
``n_layers - first_k_dense``.  The ssm family's cache is a float32
recurrent state per layer (``wkv`` and the two token-shift carries), so
``max_len`` does not size it.  The ``"hybrid"`` family (Hymba) runs a
Mamba head beside GQA attention in every block (``ssm_in``, ``ssm``: the
recurrence through K7) and averages the two outputs' RMS norms
(``ln_attn_out``, ``ln_ssm_out``); its attention takes a sliding window of
``swa_window`` on every layer but the first, the middle and the last
(:func:`_layer_flags`; a full layer passes ``window=None``, where JAX
passes 2^30), in K5 and in the decode alike, and its cache adds the
Mamba state, float32 ``[B, d_model, ssm_state]`` a layer (``"ssm"``).

The encdec family follows JAX's: the encoder's blocks (``enc_blocks``, a
list like ``blocks``) run its self-attention through K5 with
``causal=False`` (RoPE applied, as JAX's ``gqa_apply`` does), and each
decoder block's cross attention (``attention.cross_attention``: no RoPE, no mask)
projects K and V from the encoder's output on every call, decode steps
too, and runs K5 full with S != T (one query row against ``enc_seq``
keys in a decode step).

The vlm prefill departs from JAX's (``ROADMAP.md`` §3): JAX ingests the
patches and the text as two segments, and its ``gqa_apply`` lets the
second attend only within itself, so its text never sees the image and
its ``prefill`` disagrees with its ``forward``.  The port ingests
``cat(patches, embed[tokens])`` as one segment at 0, JAX's
``decode_step(..., embeds=joined)``, which equals JAX's ``forward``.

MoE configurations may carry spare replica slots (``moe_replica_slots``)
and :func:`forward` the Reshape balancer's routing tables
(``moe_routing``, one ``[E, P]`` table a MoE layer of ``blocks``).

Where JAX stacks the per-layer params for ``lax.scan``, the port keeps
``params["blocks"]`` as a list of per-layer dicts and loops over it in
Python (:func:`repro_torch.models.convert.params_from_jax` unstacks a JAX
tree).  ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, where JAX takes ``jax.checkpoint``), so the
kernels' forwards launch twice a step.  :func:`loss_fn` is differentiable
for every family: K4, K5, K6 and K7 have their backward (each a
kernel).  Entry points
take ``device`` (default ``"cuda"``), resolved by
:func:`repro_torch.devices.resolve_device`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, dtype_of
from ..devices import DeviceSpec, resolve_device
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (
    Params,
    cross_entropy,
    dense_init,
    embed_init,
    gelu_mlp,
    gelu_mlp_init,
    layernorm,
    layernorm_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
)


#: The layer lists that the JAX package stacks for ``lax.scan`` (a leading
#: layer axis on every leaf) and the port keeps as lists of per-layer dicts.
STACKED = ("blocks", "enc_blocks")


def stacked_depths(cfg: ModelConfig) -> Dict[str, int]:
    """The layers each list of :data:`STACKED` holds under ``cfg``."""
    return dict(zip(STACKED, (cfg.n_layers - cfg.first_k_dense,
                              cfg.n_enc_layers)))


#: The attention each ported family takes.
ATTN = {"dense": ("gqa", "mla"), "moe": ("gqa", "mla"), "vlm": ("gqa",),
        "ssm": ("none",), "encdec": ("gqa",), "hybrid": ("gqa",)}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration outside what the
    JAX package builds: an unknown family, an attention its family does
    not take, or another norm or activation."""
    missing = []
    if cfg.family not in ATTN:
        missing.append(f"family {cfg.family!r}")
    elif cfg.attn not in ATTN[cfg.family]:
        missing.append(f"attn {cfg.attn!r} in family {cfg.family!r}")
    if cfg.norm not in ("rms", "ln") or cfg.act not in ("swiglu", "gelu"):
        missing.append(f"norm {cfg.norm!r} / act {cfg.act!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to PyTorch yet "
            "(ROADMAP.md)")


# ===================================================================== #
# Parameter initialization                                               #
# ===================================================================== #
def _norm_init(cfg: ModelConfig, d: int, dt, dev):
    return (rmsnorm_init(d, dt, dev) if cfg.norm == "rms"
            else layernorm_init(d, dt, dev))


def _apply_norm(cfg: ModelConfig, x: torch.Tensor, p) -> torch.Tensor:
    return rmsnorm(x, p) if cfg.norm == "rms" else layernorm(x, p)


def _block_init(cfg: ModelConfig, gen: torch.Generator, *,
                dense_ffn: bool = False, cross: bool = False) -> Params:
    """One layer's params; ``dense_ffn``: the dense FFN of ``d_ff`` in
    place of the MoE (the first_k_dense layers); ``cross``: a decoder
    block's cross attention (``ln_cross``, and ``cross``, a GQA layer with
    ``n_heads`` KV heads)."""
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    p: Params = {"ln1": _norm_init(cfg, cfg.d_model, dt, dev)}
    if cfg.family == "ssm":
        p["tmix"] = ssm_lib.rwkv6_init(gen, cfg.d_model, cfg.n_heads, dt)
        p["ln2"] = _norm_init(cfg, cfg.d_model, dt, dev)
        p["cmix"] = ssm_lib.rwkv6_cmix_init(gen, cfg.d_model, cfg.d_ff, dt)
        return p
    if cfg.attn == "mla":
        p["attn"] = attn_lib.mla_init(
            gen, cfg.d_model, cfg.n_heads, kv_lora=cfg.kv_lora,
            qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope, v_head=cfg.v_head,
            q_lora=cfg.q_lora, dtype=dt)
    else:
        p["attn"] = attn_lib.gqa_init(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.hd, dt)
    if cfg.family == "hybrid":
        p["ssm_in"] = dense_init(gen, cfg.d_model, cfg.d_model, dt)
        p["ssm"] = ssm_lib.mamba_init(gen, cfg.d_model, cfg.ssm_state, dt)
        p["ln_attn_out"] = rmsnorm_init(cfg.d_model, dt, dev)
        p["ln_ssm_out"] = rmsnorm_init(cfg.d_model, dt, dev)
    if cross:
        p["ln_cross"] = _norm_init(cfg, cfg.d_model, dt, dev)
        p["cross"] = attn_lib.gqa_init(gen, cfg.d_model, cfg.n_heads,
                                       cfg.n_heads, cfg.hd, dt)
    p["ln2"] = _norm_init(cfg, cfg.d_model, dt, dev)
    if cfg.n_experts and not dense_ffn:
        p["moe"] = moe_lib.moe_init(gen, cfg.d_model, cfg.d_expert,
                                    cfg.n_experts, n_shared=cfg.n_shared,
                                    d_shared=cfg.d_shared or None,
                                    n_replica_slots=cfg.moe_replica_slots,
                                    dtype=dt)
    elif cfg.act == "swiglu":
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)
    else:
        p["mlp"] = gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceSpec = "cuda") -> Params:
    """Random weights from ``seed``, drawn on ``device`` (JAX's
    distributions; other numbers than JAX's from the same seed)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    p: Params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dt)}
    encdec = cfg.family == "encdec"
    p["blocks"] = [_block_init(cfg, gen, cross=encdec)
                   for _ in range(cfg.n_layers - cfg.first_k_dense)]
    if cfg.first_k_dense:
        p["dense_blocks"] = [_block_init(cfg, gen, dense_ffn=True)
                             for _ in range(cfg.first_k_dense)]
    if encdec:
        p["enc_blocks"] = [_block_init(cfg, gen)
                           for _ in range(cfg.n_enc_layers)]
        pos = torch.empty((cfg.enc_seq, cfg.d_model), dtype=torch.float32,
                          device=dev)
        p["enc_pos"] = pos.normal_(0.0, 1.0, generator=gen).mul_(0.01).to(dt)
        p["ln_enc"] = _norm_init(cfg, cfg.d_model, dt, dev)
    p["ln_f"] = _norm_init(cfg, cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, dt,
                                  scale=cfg.d_model ** -0.5)
    return p


# ===================================================================== #
# Block forward                                                          #
# ===================================================================== #
def _block_apply(
    cfg: ModelConfig,
    bp: Params,
    x: torch.Tensor,
    *,
    cache: Optional[Params] = None,
    cache_len: int = 0,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
    moe_routing: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Params], Dict[str, torch.Tensor]]:
    """One block (GQA or MLA attention, with the hybrid family's Mamba
    head beside it, the cross attention over ``enc_out`` where given, then
    a MoE or the dense FFN; or RWKV6 time-mix + channel-mix).
    ``causal=False``: the encoder's full self-attention; ``window``: the
    attention's sliding window (None: full).  Returns (x, the new cache,
    moe_stats)."""
    stats: Dict[str, torch.Tensor] = {}
    h = _apply_norm(cfg, x, bp["ln1"])
    if cfg.family == "ssm":
        mix_state = None if cache is None else {
            "wkv": cache["wkv"], "shift": cache["shift"]}
        out, new_mix = ssm_lib.rwkv6_apply(bp["tmix"], h, n_heads=cfg.n_heads,
                                           state=mix_state)
        x = x + out
        h2 = _apply_norm(cfg, x, bp["ln2"])
        clast = None if cache is None else cache["cshift"]
        out2, new_clast = ssm_lib.rwkv6_cmix_apply(bp["cmix"], h2, clast)
        x = x + out2
        new_cache = None
        if cache is not None:
            new_cache = {"wkv": new_mix["wkv"], "shift": new_mix["shift"],
                         "cshift": new_clast}
        return x, new_cache, stats
    attn_cache = None if cache is None else cache["attn"]
    if cfg.attn == "mla":
        a_out, new_attn = attn_lib.mla_apply(
            bp["attn"], h, n_heads=cfg.n_heads, kv_lora=cfg.kv_lora,
            qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope, v_head=cfg.v_head,
            rope_theta=cfg.rope_theta, cache=attn_cache, cache_len=cache_len)
    else:
        a_out, new_attn = attn_lib.gqa_apply(
            bp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta, cache=attn_cache,
            cache_len=cache_len, causal=causal, window=window)
    new_cache = None if cache is None else {"attn": new_attn}
    if cfg.family == "hybrid":
        s_in = h @ bp["ssm_in"].to(x.dtype)
        s_out, new_ssm = ssm_lib.mamba_apply(
            bp["ssm"], s_in, state=None if cache is None else cache["ssm"])
        a_out = 0.5 * (rmsnorm(a_out, bp["ln_attn_out"])
                       + rmsnorm(s_out, bp["ln_ssm_out"]))
        if cache is not None:
            new_cache["ssm"] = new_ssm
    x = x + a_out

    if enc_out is not None:
        hc = _apply_norm(cfg, x, bp["ln_cross"])
        x = x + attn_lib.cross_attention(bp["cross"], hc, enc_out,
                                         n_heads=cfg.n_heads, head_dim=cfg.hd)

    h2 = _apply_norm(cfg, x, bp["ln2"])
    if "moe" in bp:
        # Serving is drop-free: cap >= N (cf = E/k makes cap = N exactly).
        # The forward without a cache keeps the configured capacity factor.
        cf = (max(cfg.capacity_factor, cfg.n_experts / cfg.top_k)
              if cache is not None else cfg.capacity_factor)
        f_out, mstats = moe_lib.moe_apply(
            bp["moe"], h2, top_k=cfg.top_k, capacity_factor=cf,
            expert_routing=moe_routing, return_stats=True,
            token_groups=cfg.moe_token_groups)
        stats.update(mstats)
    elif cfg.act == "swiglu":
        f_out = swiglu(h2, bp["mlp"])
    else:
        f_out = gelu_mlp(h2, bp["mlp"])
    x = x + f_out
    return x, new_cache, stats


def _plain(fn, *args):
    return fn(*args)


def _run_encoder(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                 run=_plain) -> torch.Tensor:
    """The encoder over ``frames`` ``[B, enc_seq, D]``: the frames plus
    the learned positions in the compute dtype, the bidirectional blocks
    (each through ``run``, the caller's remat), then ``ln_enc``."""
    cdt = dtype_of(cfg.compute_dtype)
    x = frames.to(cdt) + params["enc_pos"].to(cdt)[None]
    for bp in params["enc_blocks"]:
        x = run(lambda bp, x: _block_apply(cfg, bp, x, causal=False)[0],
                bp, x)
    return _apply_norm(cfg, x, params["ln_enc"])


def _layer_flags(cfg: ModelConfig) -> List[bool]:
    """Which layers of ``blocks`` attend fully: the hybrid family's first,
    middle and last (JAX's ``_layer_flags``); none else."""
    n = cfg.n_layers - cfg.first_k_dense
    full = {0, n // 2, n - 1} if cfg.family == "hybrid" else set()
    return [i in full for i in range(n)]


def _windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Each layer of ``blocks``'s sliding window: the hybrid family's
    ``max(swa_window, 1)`` on all but its full layers (JAX's windows,
    where a full layer's 2^30 masks nothing: None here); None else."""
    n = cfg.n_layers - cfg.first_k_dense
    if cfg.family != "hybrid":
        return [None] * n
    return [None if full else max(cfg.swa_window, 1)
            for full in _layer_flags(cfg)]


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = _apply_norm(cfg, x, params["ln_f"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            moe_routing: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence logits ``[B, S, V]`` and aux stats (the train /
    prefill forward, without a cache): ``dense_blocks`` first, then
    ``blocks``, each attending to the encoder's output over
    ``batch["frames"]`` in the encdec family.  ``moe_routing``: the
    balancer's ``[L, E, P]`` tables, one for each of the ``L`` layers of
    ``blocks`` (a layer's table is its block's ``expert_routing``);
    ``remat`` recomputes each block (the encoder's too) in the backward
    when gradients are taken."""
    check_supported(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    x = params["embed"][batch["tokens"]].to(cdt)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(cdt), x], dim=1)
    dev = x.device
    n_e = max(cfg.n_experts, 1)
    n_slots = moe_routing.shape[-1] if moe_routing is not None else n_e
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def block(bp, x, routing, enc_out, window):
        x, _, st = _block_apply(cfg, bp, x, enc_out=enc_out,
                                moe_routing=routing, window=window)
        return x, (
            st.get("aux_loss", zero),
            st.get("dropped_frac", zero),
            st.get("tokens_per_expert_router",
                   torch.zeros((n_e,), dtype=torch.float32, device=dev)),
            st.get("tokens_per_expert",
                   torch.zeros((n_slots,), dtype=torch.float32, device=dev)),
        )

    def run(fn, *args):
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = _run_encoder(params, cfg, batch["frames"], run)
    for bp in params.get("dense_blocks", []):
        x = run(lambda bp, x: _block_apply(cfg, bp, x)[0], bp, x)
    aux: List[Tuple[torch.Tensor, ...]] = []
    for i, (bp, window) in enumerate(zip(params["blocks"], _windows(cfg))):
        routing = None if moe_routing is None else moe_routing[i]
        x, st = run(block, bp, x, routing, enc_out, window)
        aux.append(st)
    aux_l, drop_f, tpe_router, tpe_slot = (torch.stack(t) for t in zip(*aux))
    logits = _logits(params, cfg, x)
    stats = {
        "aux_loss": aux_l.mean(),
        "dropped_frac": drop_f.mean(),
        "tokens_per_expert": tpe_router.sum(0),
        "tokens_per_expert_layers": tpe_router,   # [L, E] router demand
        "tokens_per_slot_layers": tpe_slot,       # [L, P] post-routing
    }
    return logits, stats


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, aux_weight: float = 0.01, remat: bool = True,
            moe_routing: Optional[torch.Tensor] = None):
    """(loss, stats): the float32 cross-entropy of the last ``n_text``
    positions' logits against ``batch["labels"]`` ``[B, n_text]``, plus
    ``aux_weight`` times the MoE load-balance loss where there are
    experts (``repro.models.model.loss_fn``)."""
    logits, stats = forward(params, cfg, batch, remat=remat,
                            moe_routing=moe_routing)
    labels = batch["labels"]
    n_text = labels.shape[1]
    loss = cross_entropy(logits[:, -n_text:], labels)
    if cfg.n_experts:
        loss = loss + aux_weight * stats["aux_loss"]
    return loss, stats


# ===================================================================== #
# KV caches & decode                                                     #
# ===================================================================== #
def _ssm_cache(cfg: ModelConfig, batch: int, dev: torch.device) -> Params:
    st = ssm_lib.rwkv6_state_init(batch, cfg.d_model, cfg.n_heads,
                                  torch.float32, dev)
    return {"wkv": st["wkv"], "shift": st["shift"],
            "cshift": torch.zeros((batch, 1, cfg.d_model),
                                  dtype=torch.float32, device=dev)}


def _block_cache(cfg: ModelConfig, batch: int, max_len: int,
                 dev: torch.device) -> Params:
    if cfg.family == "ssm":
        return _ssm_cache(cfg, batch, dev)
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.attn == "mla":
        return {"attn": attn_lib.mla_cache_init(batch, max_len, cfg.kv_lora,
                                                cfg.qk_rope, cdt, dev)}
    c = {"attn": attn_lib.gqa_cache_init(batch, max_len, cfg.n_kv_heads,
                                         cfg.hd, cdt, dev)}
    if cfg.family == "hybrid":
        c["ssm"] = torch.zeros((batch, cfg.d_model, cfg.ssm_state),
                               dtype=torch.float32, device=dev)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceSpec = "cuda") -> Params:
    """One ``{"attn": {"k", "v"}}`` per layer, ``[batch, max_len, KV,
    hd]`` in the compute dtype (MLA: ``{"attn": {"c_kv": [batch, max_len,
    kv_lora], "k_pe": [batch, max_len, qk_rope]}}``), under ``blocks`` and
    the first_k_dense layers' under ``dense_blocks``; for the ssm family
    one float32 ``{"wkv": [batch, H, hd, hd], "shift", "cshift": [batch,
    1, D]}`` per layer, whatever ``max_len``; for the hybrid family also
    the Mamba state ``"ssm"``, float32 ``[batch, D, ssm_state]`` a layer;
    for the encdec family also ``enc_out`` ``[batch, enc_seq, D]`` in the
    compute dtype (zeros until :func:`prefill` runs the encoder)."""
    check_supported(cfg)
    dev = resolve_device(device)
    cache: Params = {"blocks": [
        _block_cache(cfg, batch, max_len, dev)
        for _ in range(cfg.n_layers - cfg.first_k_dense)]}
    if cfg.first_k_dense:
        cache["dense_blocks"] = [_block_cache(cfg, batch, max_len, dev)
                                 for _ in range(cfg.first_k_dense)]
    if cfg.family == "encdec":
        cache["enc_out"] = torch.zeros(
            (batch, cfg.enc_seq, cfg.d_model),
            dtype=dtype_of(cfg.compute_dtype), device=dev)
    return cache


def decode_step(params: Params, cfg: ModelConfig,
                tokens: Optional[torch.Tensor], cache: Params, cache_len: int,
                *, embeds: Optional[torch.Tensor] = None,
                all_positions: bool = False) -> Tuple[torch.Tensor, Params]:
    """One serve step: append ``tokens [B, S_new]`` (or the pre-embedded
    segment ``embeds [B, S_new, D]``, the vlm prefill's patches and text)
    at ``cache_len`` and return the last position's logits ``[B, 1, V]``
    (every new position's, ``[B, S_new, V]``, with ``all_positions``) and
    the cache (updated in place: the attention caches' tensors, the
    recurrent state's entries).  The encdec family's blocks attend to
    ``cache["enc_out"]``."""
    cdt = dtype_of(cfg.compute_dtype)
    x = (embeds.to(cdt) if embeds is not None
         else params["embed"][tokens].to(cdt))
    cache_len = int(cache_len)
    enc_out = cache.get("enc_out")
    for name in ("dense_blocks", "blocks"):
        windows = (_windows(cfg) if name == "blocks"
                   else [None] * cfg.first_k_dense)
        for bp, bc, window in zip(params.get(name, []), cache.get(name, []),
                                  windows):
            x, new_cache, _ = _block_apply(cfg, bp, x, cache=bc,
                                           cache_len=cache_len,
                                           enc_out=enc_out, window=window)
            bc.update(new_cache)
    return _logits(params, cfg, x if all_positions else x[:, -1:]), cache


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            cache: Params, *,
            all_positions: bool = False) -> Tuple[torch.Tensor, Params]:
    """Prompt ingestion: the decode path with the whole prompt at 0.  For
    the vlm family the prompt is ``batch["patches"]`` followed by the
    tokens, one segment of ``n_patches + S`` positions (one causal K5 call
    a layer), so the next token goes at ``n_patches + S``.  For the encdec
    family the encoder first runs over ``batch["frames"]`` into
    ``cache["enc_out"]`` (in place)."""
    if cfg.family == "encdec":
        cache["enc_out"].copy_(
            _run_encoder(params, cfg, batch["frames"]))
    if cfg.family == "vlm":
        cdt = dtype_of(cfg.compute_dtype)
        joined = torch.cat([batch["patches"].to(cdt),
                            params["embed"][batch["tokens"]].to(cdt)], dim=1)
        return decode_step(params, cfg, None, cache, 0, embeds=joined,
                           all_positions=all_positions)
    return decode_step(params, cfg, batch["tokens"], cache, 0,
                       all_positions=all_positions)
