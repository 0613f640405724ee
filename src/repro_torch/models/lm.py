"""The language model: parameters, the layer stack, the SHINE DEQ, serving.

The port of ``repro/models/lm.py`` for every family: dense, MoE, audio
and vlm with GQA (dense and MoE also with MLA), hybrid and SSM.  A model
is a list of *stack groups*, each ``count`` blocks of one kind stored
stacked (a leading ``layers`` axis):

  * dense, audio, vlm: ``attn_mlp`` blocks (attention + SwiGLU or, for
    the audio encoder, a GELU MLP; the audio encoder attends
    non-causally);
  * moe: ``first_k_dense`` ``attn_mlp`` blocks (of width ``dense_d_ff``),
    then ``attn_moe`` blocks (attention + fine-grained MoE, whose aux losses
    the stack sums);
  * hybrid (Zamba2): ``zamba_unit``s, each ``ssm.attn_every`` Mamba2
    layers (a second stacked axis inside the unit) then one SHARED
    attention + MLP block (``shared_attn``, weight-tied across units);
  * ssm (xLSTM): ``xlstm_unit``s, each ``xlstm.slstm_every - 1`` pre-norm
    mLSTM layers (a second stacked axis) then one pre-norm sLSTM layer.

Without the DEQ (``cfg.deq.enabled`` false) the groups run layer by layer
(:func:`apply_stack`); in training each unit is rematerialised as
``cfg.remat`` says (``_remat_wrap``: ``full`` recomputes the whole unit in
the backward, ``dots`` keeps only its matmul outputs).  With it, the stack is a weight-tied group of
``cfg.deq.num_blocks`` blocks of the family's kind solved to a fixed point
with input injection,

    z* = x + C(z*),   C(z) = blocks(z) - z,

by the registered forward solver (Broyden, whose inverse estimate is
SHINE's shared object).  The input comes from the family's frontend
(:func:`_input_embedding`): token embeddings; the audio stub's frame
embeddings ``batch["embeds"]``; or the vlm stub's patch embeddings
``batch["image_embeds"]`` prepended to the token embeddings.  Training:
:func:`forward` and :func:`loss_fn` solve the whole sequence (causally,
or not for the audio encoder), and the backward runs the configured
SHINE-family estimator (``implicit_fixed_point``).  Serving:
:func:`prefill` runs the prompt against a fresh cache (for the DEQ: solves
its equilibrium, cold or seeded from a cross-request prefix-cache snapshot
assembled by :func:`prefix_seed_carry` or :func:`prefix_gather_carry`, and
seeds the decode carry with its last token); :func:`decode_step` runs one
new token per row against the cache (for the DEQ: solved with inactive
rows frozen, warm started from the carried equilibrium and quasi-Newton
ring, then the cache refreshed once at ``z*``).  Attention caches are
written in place by the attention; a Mamba or xLSTM state is read then
replaced, so ``mamba2_block`` and the xLSTM blocks return a new one and the
stack stores it (``_store``): inside a DEQ solve every evaluation starts
from the frozen state and only the final pass at ``z*`` stores it.  The
vlm family serves text only (a prompt of tokens); the audio encoder is not
served.

Parameters are a plain dict with the JAX package's tree and layouts
(``group{i}`` or ``deq_blocks`` trees), so :func:`params_from_jax` converts
a JAX ``init_params`` tree leaf for leaf.

Every entry point takes ``ctx`` (a ``ShardCtx``, default none).  On a
running mesh the parameters, batch and caches are DTensors, the
activations are constrained where the reference constrains them (block
inputs gathered along the sequence, block outputs in the residual layout
``seq_res``, the solver state batch-split), and the calls run with plain
tensors taken as replicated (``sharding.spmd``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowrank import LowRank
from repro_torch.core.solvers import SolveCarry, init_solve_carry, seed_carry
from repro_torch.device import resolve_device, to_device
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.engine import batched_solve
from repro_torch.implicit.fixed_point import implicit_fixed_point
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ShardCtx,
    distribute_tree,
    map_decls,
    spec_tree,
    spmd,
)
from repro_torch.models.layers import (
    ParamDecl,
    act_dtype,
    cross_entropy,
    embed_decl,
    embed_tokens,
    lm_logits,
    mlp,
    mlp_decl,
    norm_decl,
    rmsnorm,
)

# ---------------------------------------------------------------------------
# Stack structure and parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StackGroup:
    kind: str       # attn_mlp | attn_moe | zamba_unit | xlstm_unit
    count: int      # number of stacked blocks


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "hybrid", "ssm", "audio", "vlm") \
            or cfg.attn_type not in ("gqa", "mla") \
            or (cfg.family in ("hybrid", "audio", "vlm")
                and cfg.attn_type != "gqa"):
        raise NotImplementedError(
            f"repro_torch runs the dense and MoE families with GQA or MLA, "
            f"the hybrid, audio and vlm families with GQA and the SSM "
            f"family; {cfg.name} is {cfg.family}/{cfg.attn_type}")


def stack_groups(cfg: ModelConfig) -> list[StackGroup]:
    _check_family(cfg)
    if cfg.family in ("dense", "audio", "vlm"):
        return [StackGroup("attn_mlp", cfg.num_layers)]
    if cfg.family == "hybrid":
        period = cfg.ssm.attn_every or cfg.num_layers
        if cfg.num_layers % period:
            raise ValueError(f"{cfg.num_layers} layers are no multiple of "
                             f"attn_every {period}")
        return [StackGroup("zamba_unit", cfg.num_layers // period)]
    if cfg.family == "ssm":
        period = cfg.xlstm.slstm_every
        if cfg.num_layers % period:
            raise ValueError(f"{cfg.num_layers} layers are no multiple of "
                             f"slstm_every {period}")
        return [StackGroup("xlstm_unit", cfg.num_layers // period)]
    groups = []
    if cfg.moe.first_k_dense:
        groups.append(StackGroup("attn_mlp", cfg.moe.first_k_dense))
    groups.append(StackGroup("attn_moe",
                             cfg.num_layers - cfg.moe.first_k_dense))
    return groups


def _deq_kind(cfg: ModelConfig) -> str:
    return {"dense": "attn_mlp", "audio": "attn_mlp", "vlm": "attn_mlp",
            "moe": "attn_moe", "hybrid": "zamba_unit",
            "ssm": "xlstm_unit"}[cfg.family]


def _stack(decl: dict, count: int) -> dict:
    """Prepend a stacked ``layers`` axis to every declaration of a tree."""
    return {k: (_stack(v, count) if isinstance(v, dict) else
                ParamDecl((count,) + v.shape, ("layers",) + v.axes, v.init,
                          v.scale))
            for k, v in decl.items()}


def _attn_decl(cfg: ModelConfig) -> dict:
    return attn.mla_decl(cfg) if cfg.attn_type == "mla" else attn.gqa_decl(cfg)


def _unit_decl(cfg: ModelConfig, kind: str) -> dict:
    if kind == "attn_mlp":
        ff = (cfg.moe.dense_d_ff if cfg.family == "moe" and cfg.moe.dense_d_ff
              else cfg.d_ff)
        return {"ln1": norm_decl(cfg.d_model), "attn": _attn_decl(cfg),
                "ln2": norm_decl(cfg.d_model), "mlp": mlp_decl(cfg, d_ff=ff)}
    if kind == "attn_moe":
        return {"ln1": norm_decl(cfg.d_model), "attn": _attn_decl(cfg),
                "ln2": norm_decl(cfg.d_model), "moe": moe_mod.moe_decl(cfg)}
    if kind == "zamba_unit":
        return {"mamba": _stack({"ln": norm_decl(cfg.d_model),
                                 "m": ssm_mod.mamba2_decl(cfg)},
                                cfg.ssm.attn_every)}
    if kind == "xlstm_unit":
        return {"mlstm": _stack({"ln": norm_decl(cfg.d_model),
                                 "m": xlstm_mod.mlstm_decl(cfg)},
                                cfg.xlstm.slstm_every - 1),
                "slstm": {"ln": norm_decl(cfg.d_model),
                          "s": xlstm_mod.slstm_decl(cfg)}}
    raise ValueError(kind)


def model_decl(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    embed = embed_decl(cfg)
    if "lm_head" not in embed and cfg.family == "audio":
        # the audio encoder's classifier head over the padded classes
        embed["lm_head"] = ParamDecl((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"))
    decl = {"embed": embed, "final_norm": norm_decl(cfg.d_model)}
    if cfg.deq.enabled:
        decl["deq_blocks"] = _stack(_unit_decl(cfg, _deq_kind(cfg)),
                                    cfg.deq.num_blocks)
    else:
        for i, grp in enumerate(stack_groups(cfg)):
            decl[f"group{i}"] = _stack(_unit_decl(cfg, grp.kind), grp.count)
    if cfg.family == "hybrid":
        decl["shared_attn"] = {
            "ln1": norm_decl(cfg.d_model), "attn": _attn_decl(cfg),
            "ln2": norm_decl(cfg.d_model), "mlp": mlp_decl(cfg)}
    return decl


def _init_leaf(d: ParamDecl, gen: torch.Generator, device,
               dtype: torch.dtype) -> torch.Tensor:
    """One leaf in ``dtype``.  A leaf of 4 or more dims (a stacked layer
    axis over the experts' weights: DeepSeek-V2-Lite's ``wi_g`` is 26 x 64
    x 2048 x 1408, 19 GB in f32; Zamba2's units over their Mamba layers:
    ``w_z`` is 9 x 6 x 2560 x 5120) is drawn one layer at a time and cast
    as it goes, so its f32 draw never exists whole; every other leaf is
    drawn whole in f32 and cast."""
    if d.init == "ones":
        return torch.ones(d.shape, device=device, dtype=dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, device=device, dtype=dtype)
    if d.init not in ("normal", "fan_in"):
        raise ValueError(f"unknown init {d.init!r}")
    # fan-in = product of all dims except the last (as the JAX package's
    # ParamDecl, stacked layer axis included)
    fan_in = max(1, math.prod(d.shape[:-1])) if len(d.shape) > 1 \
        else d.shape[0]
    std = d.scale / math.sqrt(fan_in)

    def draw(shape):
        if d.init == "normal":
            return d.scale * torch.randn(shape, generator=gen, device=device)
        # standard normal truncated to [-2, 2], scaled
        out = torch.empty(shape, device=device)
        return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=gen)

    if len(d.shape) < 4:
        return draw(d.shape).to(dtype)
    out = torch.empty(d.shape, device=device, dtype=dtype)
    for i in range(d.shape[0]):
        out[i] = draw(d.shape[1:])
    return out


def param_count(cfg: ModelConfig) -> int:
    """The number of parameters: the elements of every declared leaf
    (``model_decl``)."""
    leaves = []
    map_decls(leaves.append, model_decl(cfg))
    return sum(math.prod(d.shape) for d in leaves)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and distributions
    (``fan_in`` truncated normal, ``normal`` 0.02 embedding and router,
    ``ones`` norms), drawn from a ``torch.Generator`` seeded with ``seed``
    on the target device, in the config's dtype.  The numbers differ from
    JAX's for the same seed; tests carry JAX's over with
    :func:`params_from_jax`.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = act_dtype(cfg)

    def build(decl):
        return {k: (build(v) if isinstance(v, dict) else
                    _init_leaf(v, gen, dev, dtype))
                for k, v in decl.items()}

    return build(model_decl(cfg))


def params_from_jax(np_params: dict, device=None) -> dict:
    """Convert the JAX ``init_params`` tree, as numpy arrays, to the port's
    tree (same keys, same layouts).  bf16 leaves (numpy's ml_dtypes
    bfloat16) stay bf16."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return conv(np_params)


def place_params(params: dict, cfg: ModelConfig, ctx: ShardCtx) -> dict:
    """Whole parameters (the same on every rank) as DTensors laid out by
    ``ctx``'s rules (``model_decl``'s axes): TP-split, DP-replicated."""
    return distribute_tree(params, spec_tree(model_decl(cfg), ctx.rules),
                           ctx.device_mesh)


def params_device(params: dict) -> torch.device:
    return params["embed"]["embedding"].device


# ---------------------------------------------------------------------------
# Block application and the DEQ solve
# ---------------------------------------------------------------------------


def _apply_attention(params, x, cfg, positions, cache, cache_index,
                     ctx=NULL_CTX):
    fn = attn.mla_attention if cfg.attn_type == "mla" else attn.gqa_attention
    return fn(params, x, cfg, positions, cache, cache_index, ctx)


def apply_unit(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache=None, cache_index=None,
               shared: dict | None = None, ctx: ShardCtx = NULL_CTX):
    """One stack unit.  ``attn_mlp``/``attn_moe``: a pre-norm block,
    attention then SwiGLU or the MoE.  ``zamba_unit``: ``attn_every``
    pre-norm Mamba2 layers, then the ``shared`` attention + MLP block.
    ``xlstm_unit``: ``slstm_every - 1`` pre-norm mLSTM layers, then a
    pre-norm sLSTM layer (no attention, no position).
    Returns ``(x, new_cache, aux)``; ``aux`` holds the MoE's ``moe_aux`` and
    ``moe_z`` (empty otherwise).  A zamba unit's ``new_cache`` is ``{"mamba":
    MambaCache stacked over its layers (new tensors), "attn": the KVCache
    written in place}``, an xLSTM unit's ``{"mlstm": MLSTMCache stacked
    over its layers, "slstm": SLSTMCache}`` (new tensors); storing them is
    the caller's (``_store``).  Block inputs are gathered along the
    sequence (``_gathered``: a no-op unless sequence parallelism splits
    the residual stream)."""
    if kind == "zamba_unit":
        return _apply_zamba_unit(params, x, cfg, positions, cache,
                                 cache_index, shared, ctx)
    if kind == "xlstm_unit":
        return _apply_xlstm_unit(params, x, cfg, cache, ctx)
    if kind not in ("attn_mlp", "attn_moe"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    g = functools.partial(_gathered, ctx)
    a_out, new_kv = _apply_attention(
        params["attn"], g(rmsnorm(params["ln1"], x, cfg.norm_eps)), cfg,
        positions, cache, cache_index, ctx)
    x = x + a_out
    h = g(rmsnorm(params["ln2"], x, cfg.norm_eps))
    if kind == "attn_mlp":
        return x + mlp(params["mlp"], h, ctx), new_kv, {}
    m_out, aux = moe_mod.moe_block(params["moe"], h, cfg, ctx)
    return x + m_out, new_kv, aux


def _gathered(ctx: ShardCtx, h):
    """A block input pinned whole along the sequence."""
    return ctx.constrain(h, ("batch", "seq", "embed_act"))


def _apply_zamba_unit(params, x, cfg, positions, cache, cache_index,
                      shared, ctx=NULL_CTX):
    eps = cfg.norm_eps
    g = functools.partial(_gathered, ctx)
    states, convs = [], []
    for j in range(cfg.ssm.attn_every):
        pj = _block(params["mamba"], j)
        cj = None if cache is None else _block(cache["mamba"], j)
        out, mc = ssm_mod.mamba2_block(pj["m"], g(rmsnorm(pj["ln"], x, eps)),
                                       cfg, cj, ctx)
        x = x + out
        if mc is not None:
            states.append(mc.state)
            convs.append(mc.conv)
    a_out, new_kv = _apply_attention(
        shared["attn"], g(rmsnorm(shared["ln1"], x, eps)), cfg, positions,
        None if cache is None else cache["attn"], cache_index, ctx)
    x = x + a_out
    x = x + mlp(shared["mlp"], g(rmsnorm(shared["ln2"], x, eps)), ctx)
    new_cache = None
    if cache is not None:
        new_cache = {"mamba": ssm_mod.MambaCache(torch.stack(states),
                                                 torch.stack(convs)),
                     "attn": new_kv}
    return x, new_cache, {}


def _apply_xlstm_unit(params, x, cfg, cache, ctx=NULL_CTX):
    eps = cfg.norm_eps
    g = functools.partial(_gathered, ctx)
    m_caches = []
    for j in range(cfg.xlstm.slstm_every - 1):
        pj = _block(params["mlstm"], j)
        cj = None if cache is None else _block(cache["mlstm"], j)
        out, mc = xlstm_mod.mlstm_block(pj["m"], g(rmsnorm(pj["ln"], x, eps)),
                                        cfg, cj, ctx)
        x = x + out
        if mc is not None:
            m_caches.append(mc)
    sp = params["slstm"]
    out, sc = xlstm_mod.slstm_block(sp["s"], g(rmsnorm(sp["ln"], x, eps)),
                                    cfg,
                                    None if cache is None else cache["slstm"],
                                    ctx)
    x = x + out
    new_cache = None
    if cache is not None:
        new_cache = {"mlstm": xlstm_mod.MLSTMCache(
            *(torch.stack(t) for t in zip(*m_caches))), "slstm": sc}
    return x, new_cache, {}


def _block(tree, j: int):
    """Entry ``j`` of every leaf of a stacked tree (dicts and NamedTuples
    of tensors, as parameters and caches are), as views."""
    if isinstance(tree, dict):
        return {k: _block(v, j) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_block(v, j) for v in tree))
    return tree[j]


def _store(dst, src) -> None:
    """Copy a unit's new cache ``src`` into its cache ``dst`` in place,
    leaf by leaf; a leaf the unit wrote in place (``src`` is ``dst``'s own
    tensor: the attention's k/v) is left alone."""
    if isinstance(dst, dict):
        for k in dst:
            _store(dst[k], src[k])
    elif isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _store(a, b)
    elif src is not dst:
        dst.copy_(src)


def _remat_wrap(fn, cfg: ModelConfig, train: bool):
    """``fn`` rematerialised for training, as ``cfg.remat`` says: ``full``
    keeps only its inputs and recomputes it in the backward; ``dots``
    keeps the outputs of its matmuls (``aten.mm``/``bmm``/``addmm``) and
    recomputes the rest; ``none`` (or ``train=False``) keeps everything."""
    if not train or cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}; expected none | full | dots")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _save_dots)
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, **kw)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy: the counterpart of JAX's ``checkpoint_dots``."""
    cp = torch.utils.checkpoint.CheckpointPolicy
    return cp.MUST_SAVE if op in _DOTS else cp.PREFER_RECOMPUTE


def _deq_cfg(cfg: ModelConfig) -> ImplicitConfig:
    d = cfg.deq
    return ImplicitConfig.from_strings(
        solver=d.solver, max_steps=d.max_steps, tol=d.tol, memory=d.memory,
        backward=d.backward, refine_steps=d.refine_steps,
        backward_max_steps=d.backward_max_steps, unroll=d.unroll,
        qn_dtype=d.qn_dtype, guard=d.guard)


def deq_solve_carry(cfg: ModelConfig, batch: int, seq: int,
                    device=None, ctx: ShardCtx = NULL_CTX) -> SolveCarry:
    """An all-cold persistent solve state for the DEQ group's ``(B, S, d)``
    activations; on a running ``ctx`` laid out as its solves lay it out
    (``implicit.fixed_point.SolveLayout``: rows split along the batch over
    the DP axes and otherwise whole, the ``(U, V)`` ring beside them)."""
    carry = init_solve_carry(batch, (seq, cfg.d_model), cfg.deq.memory,
                             dtype=act_dtype(cfg), qn_dtype=cfg.deq.qn_dtype,
                             device=resolve_device(device))
    if not ctx.running:
        return carry
    vec = ctx.spec(("batch",))
    z = vec + (None, None)
    mem = (None,) + z
    specs = SolveCarry(z=z, lowrank=LowRank(alpha=(), u=mem, v=mem,
                                            count=vec), warm=vec, age=vec)
    return distribute_tree(carry, specs, ctx.device_mesh)


# logical axes of the DEQ solver state (the qN memory prepends "qn_mem")
_STATE_AXES = ("batch", "seq_res", "embed_act")


def _deq_aux(out, carry) -> dict:
    """The solve's aux outputs from ``implicit_fixed_point``'s return."""
    stats = out[1]
    aux = {"deq_residual": stats.residual.mean(),
           "deq_steps": float(stats.n_steps)}
    if stats.status is not None:
        aux["deq_status"] = stats.status
    if carry is not None:
        aux["solve_carry"] = out[2]
    return aux


def apply_stack(params, x, cfg: ModelConfig, positions, caches=None,
                cache_index=None, train: bool = True, active=None,
                carry=None, ctx: ShardCtx = NULL_CTX):
    """Run every stack group.  Returns ``(x, caches, aux)``.

    Without the DEQ the groups run unit by unit (each unit's cache rows
    stored in place), rematerialised when ``train`` (``_remat_wrap``), and
    ``aux`` holds the MoE losses summed over the layers; ``active`` and
    ``carry`` are the DEQ's (:func:`_apply_deq`)."""
    if cfg.deq.enabled:
        return _apply_deq(params, x, cfg, positions, caches, cache_index,
                          active=active, carry=carry, ctx=ctx)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    shared = params.get("shared_attn")
    for i, grp in enumerate(stack_groups(cfg)):
        gp = params[f"group{i}"]
        gc = None if caches is None else caches[f"group{i}"]

        def body(xc, lp, lc, kind=grp.kind):
            x2, nc, a = apply_unit(kind, lp, xc, cfg, positions, lc,
                                   cache_index, shared, ctx)
            # the residual stream between blocks: sequence-split under SP
            return ctx.constrain(x2, ("batch", "seq_res", "embed_act")), \
                nc, a

        wrapped = _remat_wrap(body, cfg, train)
        for j in range(grp.count):
            lc = None if gc is None else _block(gc, j)
            x, nc, a = wrapped(x, _block(gp, j), lc)
            if lc is not None:
                _store(lc, nc)
            aux = {k: aux[k] + a[k] if k in a else aux[k] for k in aux}
    return x, caches, aux


def _apply_deq(params, x_emb, cfg, positions, caches=None, cache_index=None,
               active=None, carry=None, ctx: ShardCtx = NULL_CTX):
    """Solve the weight-tied block group's fixed point.  Without caches
    (training) the whole sequence attends over its own k/v (causally, or
    not as ``cfg.causal`` says: the audio encoder) and the solve is
    differentiable; with caches the new tokens attend over the
    frozen cache, which is refreshed once at ``z*``.  The blocks' MoE aux
    losses are not part of the solve's output, as in the reference.
    Returns ``(z*, caches, aux)``."""
    nb = cfg.deq.num_blocks
    kind = _deq_kind(cfg)
    # the shared block is a differentiated parameter of the solve, beside
    # the tied blocks: reached through f's closure, the implicit backward
    # would not see it and its gradient would come out zero
    p_all = {"blocks": params["deq_blocks"]}
    if "shared_attn" in params:
        p_all["shared"] = params["shared_attn"]
    # cold start AT the injection: f(x) = x + C(x) is one free Picard step
    z0 = x_emb
    if caches is None:
        def f(p, xin, z):
            x_in, pos = xin
            h = z
            for j in range(nb):
                h, _, _ = apply_unit(kind, _block(p["blocks"], j), h, cfg,
                                     pos, shared=p.get("shared"), ctx=ctx)
            return ctx.constrain(x_in + (h - z), _STATE_AXES)

        out = implicit_fixed_point(f, p_all, (x_emb, positions), z0,
                                   _deq_cfg(cfg), carry=carry, ctx=ctx,
                                   state_axes=_STATE_AXES)
        return out[0], None, _deq_aux(out, carry)

    p_dec = dict(p_all, blocks=[_block(params["deq_blocks"], j)
                                for j in range(nb)])
    unit_caches = [_block(caches["deq"], j) for j in range(nb)]

    def f_dec(p, xin, z):
        # every evaluation reads the frozen caches: the attention writes
        # this step's k/v at cidx (the same rows each time), a Mamba
        # state is not stored
        x_in, pos, cidx = xin
        h = z
        for j in range(nb):
            h, _, _ = apply_unit(kind, p["blocks"][j], h, cfg, pos,
                                 unit_caches[j], cidx, p.get("shared"), ctx)
        return ctx.constrain(x_in + (h - z), _STATE_AXES)

    xin = (x_emb, positions, cache_index)
    if active is not None:
        out = batched_solve(f_dec, p_dec, xin, z0, _deq_cfg(cfg),
                            valid=active, carry=carry, ctx=ctx,
                            state_axes=_STATE_AXES)
    else:
        out = implicit_fixed_point(f_dec, p_dec, xin, z0, _deq_cfg(cfg),
                                   carry=carry, ctx=ctx,
                                   state_axes=_STATE_AXES)
    z_star = out[0]
    # one more pass stores the caches at the fixed point (the state IS the
    # block-input stream under input injection)
    h = z_star
    for j in range(nb):
        h, nc, _ = apply_unit(kind, p_dec["blocks"][j], h, cfg, positions,
                              unit_caches[j], cache_index, p_dec.get("shared"),
                              ctx)
        _store(unit_caches[j], nc)
    return z_star, caches, _deq_aux(out, carry)


# ---------------------------------------------------------------------------
# Training: full-sequence forward and loss
# ---------------------------------------------------------------------------


def _input_embedding(params, batch: dict, cfg: ModelConfig,
                     ctx: ShardCtx = NULL_CTX):
    """The frontend: ``(x (B, S, d), positions (B, S))`` on the parameters'
    device.  Audio takes the stub frame embeddings ``batch["embeds"]`` in
    the model's dtype; a vlm batch with ``image_embeds (B, N, d)`` puts
    them before the token embeddings of ``batch["tokens"]``; every other
    batch is its tokens' embeddings.  Positions run over the whole
    sequence."""
    dev = params_device(params)
    if cfg.family == "audio":
        x = batch["embeds"].to(device=dev, dtype=act_dtype(cfg))
    else:
        x = embed_tokens(params["embed"], batch["tokens"].to(dev), cfg, ctx)
        if cfg.family == "vlm" and "image_embeds" in batch:
            img = ctx.constrain(batch["image_embeds"].to(device=dev,
                                                          dtype=x.dtype),
                                ("batch", "seq", "embed_act"))
            x = torch.cat([img, x], 1)
    x = ctx.constrain(x, ("batch", "seq", "embed_act"))
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    return x, ctx.constrain(pos, ("batch", "seq"))


def forward(params, batch: dict, cfg: ModelConfig, train: bool = True,
            carry: SolveCarry | None = None, ctx: ShardCtx = NULL_CTX):
    """Full-sequence forward of a batch (``_input_embedding``: ``tokens
    (B, S)``, the audio stub's ``embeds`` or the vlm stub's
    ``image_embeds`` before the tokens).  Returns ``(logits (B, S, V),
    aux)``, the image positions included; ``train`` rematerialises the
    layer stack (``cfg.remat``); ``carry`` warm-starts the DEQ solve and
    the updated one comes back under ``aux["solve_carry"]``."""
    _check_family(cfg)
    with spmd(ctx):
        x, pos = _input_embedding(params, batch, cfg, ctx)
        z, _, aux = apply_stack(params, x, cfg, pos, train=train,
                                carry=carry, ctx=ctx)
        z = rmsnorm(params["final_norm"], z, cfg.norm_eps)
        return lm_logits(params["embed"], z, cfg, ctx), aux


def loss_fn(params, batch: dict, cfg: ModelConfig, z_loss: float = 1e-4,
            carry: SolveCarry | None = None, ctx: ShardCtx = NULL_CTX):
    """Cross entropy (plus z-loss) of the logits against
    ``batch["targets"]`` (the image positions of a vlm batch dropped first),
    plus the MoE's weighted load-balance and router z-losses.  Returns
    ``(loss, metrics)``; the metrics hold the loss terms and the stack's
    aux (the DEQ solve's, ``solve_carry`` among them when a carry is
    given)."""
    logits, aux = forward(params, batch, cfg, train=True, carry=carry,
                          ctx=ctx)
    if cfg.family == "vlm" and "image_embeds" in batch:
        logits = logits[:, batch["image_embeds"].shape[1]:]
    with spmd(ctx):
        loss, metrics = cross_entropy(logits, batch["targets"], z_loss, ctx)
    if "moe_aux" in aux:
        loss = (loss + cfg.moe.aux_weight * aux["moe_aux"]
                + cfg.moe.z_weight * aux["moe_z"])
    metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _stacked(cache: tuple, lead: tuple) -> tuple:
    """``cache`` (a NamedTuple of one layer's tensors) repeated over the
    stacked axes ``lead``, each leaf its own tensor."""
    return type(cache)(*(t.expand(lead + tuple(t.shape)).contiguous()
                         for t in cache))


def _unit_cache(cfg: ModelConfig, kind: str, count: int, batch: int,
                max_len: int, device):
    """Cold caches of ``count`` stacked units of ``kind``."""
    if kind == "xlstm_unit":
        # no attention: the recurrent states only, stabilisers at -1e30
        return {"mlstm": _stacked(
                    xlstm_mod.mlstm_cache_shape(cfg, batch, device),
                    (count, cfg.xlstm.slstm_every - 1)),
                "slstm": _stacked(
                    xlstm_mod.slstm_cache_shape(cfg, batch, device),
                    (count,))}
    dt = act_dtype(cfg)
    if cfg.attn_type == "mla":
        k_shape, v_shape = attn.mla_cache_shapes(cfg, batch, max_len)
    else:
        k_shape = v_shape = attn.gqa_cache_shape(cfg, batch, max_len)
    kv = attn.KVCache(
        torch.zeros((count,) + k_shape, dtype=dt, device=device),
        torch.zeros((count,) + v_shape, dtype=dt, device=device))
    if kind != "zamba_unit":
        return kv
    return {"mamba": _stacked(ssm_mod.mamba2_cache_shape(cfg, batch, device),
                              (count, cfg.ssm.attn_every)), "attn": kv}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               ctx: ShardCtx = NULL_CTX):
    """Cold caches, one tree per stack: ``{"deq": ...}`` stacked over the
    DEQ's ``num_blocks``, or ``{"group{i}": ...}`` stacked over each
    group's units.  An attention unit's is a zero ``KVCache``: GQA holds
    k/v ``(count, B, max_len, KV, hd)``, MLA the latents ``c_kv (count, B,
    max_len, rank)`` and ``k_pe (count, B, max_len, rope_dim)``.  A zamba
    unit's is ``{"mamba": MambaCache(state (count, attn_every, B, H, P, N)
    f32, conv (count, attn_every, B, d_conv - 1, conv_dim)), "attn":
    KVCache}`` (the shared block's k/v per unit).  An xLSTM unit's is
    ``{"mlstm": MLSTMCache(C (count, n_m, B, H, hd, hd), n (count, n_m, B,
    H, hd), m (count, n_m, B, H)), "slstm": SLSTMCache(c, n, h, m, each
    (count, B, H, d / H))}``, all f32, ``n_m = slstm_every - 1``, the
    stabilisers ``m`` at -1e30 (a zero ``m`` would change every first
    step); it holds no ``KVCache`` and ``max_len`` does not size it.
    On a running mesh every leaf is a DTensor laid out by
    ``configs.shapes.cache_sharding`` (under ``DECODE_RULES`` the length
    of an attention cache is split over "model")."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.deq.enabled:
        caches = {"deq": _unit_cache(cfg, _deq_kind(cfg), cfg.deq.num_blocks,
                                     batch, max_len, dev)}
    else:
        caches = {f"group{i}": _unit_cache(cfg, grp.kind, grp.count, batch,
                                           max_len, dev)
                  for i, grp in enumerate(stack_groups(cfg))}
    if not ctx.running:
        return caches
    from repro_torch.configs.shapes import cache_sharding
    return distribute_tree(caches, cache_sharding(cfg, ctx, caches),
                           ctx.device_mesh)


def prefix_seed_carry(cfg: ModelConfig, batch: int, seq: int,
                      snapshots: list, device=None) -> tuple[SolveCarry,
                                                            torch.Tensor]:
    """A PREFILL-shaped carry from per-row prefix-cache snapshots.

    ``snapshots``: one entry per row, ``None`` for a miss (the row stays
    cold, bit for bit a carryless prefill) or a host tuple ``(z, u, v,
    count)``: ``z (L, d)`` the cached prefix equilibrium, ``u``/``v (m, L,
    d)`` the donor's ring over the prefix positions (``None``/``count=0``
    for an iterate-only seed).  Suffix positions (``>= L``) are zero here;
    :func:`prefill` starts them at the live ``x_emb``, and the zero ring
    pairs act as the identity on them.  Built on the host and copied to
    ``device`` without a wait.  Returns ``(carry, prefix_len (B,) int32)``.

    ``count`` is the donor's as it stands, as :func:`prefix_gather_carry`
    takes it from the device store.  (The JAX package clamps it to ``m``
    here but not in its gather, so once a donor's ring has wrapped its two
    pipelines write the next pair to different ring slots and part bit for
    bit; the port's two do not.)
    """
    if len(snapshots) != batch:
        raise ValueError(f"{len(snapshots)} snapshots for batch {batch}")
    dev = resolve_device(device)
    tmpl = deq_solve_carry(cfg, batch, seq, "cpu")
    m = tmpl.memory
    z, u, v = tmpl.z, tmpl.lowrank.u, tmpl.lowrank.v
    count, warm = tmpl.lowrank.count, tmpl.warm
    plen = torch.zeros((batch,), dtype=torch.int32)
    for i, snap in enumerate(snapshots):
        if snap is None:
            continue
        sz, su, sv, sc = snap
        sz = torch.as_tensor(sz)
        length = sz.shape[0]
        if length > seq:
            raise ValueError(f"snapshot row {i}: prefix {length} > seq {seq}")
        warm[i] = True
        plen[i] = length
        z[i, :length] = sz.to(z.dtype)
        if su is not None and sv is not None and sc:
            su, sv = torch.as_tensor(su), torch.as_tensor(sv)
            if su.shape[0] != m:
                raise ValueError(
                    f"snapshot row {i}: ring memory {su.shape[0]} != {m}")
            u[:, i, :length] = su.to(u.dtype)
            v[:, i, :length] = sv.to(v.dtype)
            count[i] = int(sc)
    carry = SolveCarry(
        z=to_device(z, dev),
        lowrank=LowRank(
            alpha=torch.ones((), dtype=torch.float32, device=dev),
            u=to_device(u, dev), v=to_device(v, dev),
            count=to_device(count, dev)),
        warm=to_device(warm, dev),
        age=torch.zeros((batch,), dtype=torch.int32, device=dev))
    return carry, to_device(plen, dev)


def prefix_gather_carry(cfg: ModelConfig, batch: int, seq: int, arrays,
                        slot_ids: torch.Tensor,
                        prefix_len: torch.Tensor) -> tuple[SolveCarry,
                                                           torch.Tensor]:
    """A PREFILL-shaped carry gathered from the device prefix store's rows
    (:class:`~repro_torch.implicit.DevicePrefixStore`), on the device:
    ``arrays`` the store's ``(z, u, v, count)``, ``slot_ids (B,)`` the donor
    rows and ``prefix_len (B,)`` the matched lengths (0 = a miss: the row
    comes out cold, bit for bit a carryless prefill).  Positions past the
    matched length hold a donor's tail in the store and are zeroed here,
    as :func:`prefix_seed_carry` zero-pads."""
    z_s, u_s, v_s, c_s = arrays
    if u_s.shape[0] != cfg.deq.memory:
        raise ValueError(
            f"store ring memory {u_s.shape[0]} != cfg {cfg.deq.memory}")
    if z_s.shape[1] < seq:
        raise ValueError(f"store seq {z_s.shape[1]} < prompt seq {seq}")
    dev = z_s.device
    idx = slot_ids.to(device=dev, dtype=torch.long)
    pmask = (torch.arange(seq, dtype=torch.int32, device=dev)[None, :]
             < prefix_len[:, None])[..., None]
    z = torch.where(pmask, z_s.narrow(1, 0, seq).index_select(0, idx).to(
        act_dtype(cfg)), torch.zeros((), dtype=act_dtype(cfg), device=dev))
    zr = torch.zeros((), dtype=u_s.dtype, device=dev)
    u = torch.where(pmask[None], u_s.narrow(2, 0, seq).index_select(1, idx),
                    zr)
    v = torch.where(pmask[None], v_s.narrow(2, 0, seq).index_select(1, idx),
                    zr)
    warm = prefix_len > 0
    count = torch.where(warm, c_s.index_select(0, idx),
                        torch.zeros_like(prefix_len)).int()
    carry = SolveCarry(
        z=z,
        lowrank=LowRank(alpha=torch.ones((), dtype=torch.float32,
                                         device=dev), u=u, v=v, count=count),
        warm=warm,
        age=torch.zeros((batch,), dtype=torch.int32, device=dev))
    return carry, prefix_len


def _spmd_entry(fn):
    """Run an entry point under ``sharding.spmd`` of its ``ctx``."""
    @functools.wraps(fn)
    def wrapped(*args, ctx: ShardCtx = NULL_CTX, **kw):
        with spmd(ctx):
            return fn(*args, ctx=ctx, **kw)
    return wrapped


@torch.no_grad()
@_spmd_entry
def prefill(params, batch: dict, cfg: ModelConfig, max_len: int, *,
            ctx: ShardCtx = NULL_CTX,
            carry: SolveCarry | None = None,
            prefix_carry: SolveCarry | None = None,
            prefix_len: torch.Tensor | None = None,
            return_steps: bool = False, return_status: bool = False):
    """Encode a prompt ``batch["tokens"] (B, S)`` (a vlm batch's
    ``image_embeds (B, N, d)`` before it: the logits, caches and
    ``lengths`` then count N + S positions, and decoding continues at
    N + S); returns ``(logits (B, N + S, V), caches, lengths)``.

    ``carry`` (a decode-shaped ``deq_solve_carry(cfg, B, 1)``) is seeded
    with the last token's equilibrium and appended to the return, so the
    first decode step warm-starts.

    ``prefix_carry`` + ``prefix_len`` seed the prefill solve itself from a
    prefix-cache snapshot: warm rows start at ``where(pos < prefix_len,
    cached_z, x_emb)`` with the cached ring, cold rows are bit for bit a
    carryless prefill.  The return then gains ``(solve_carry, deq_steps)``:
    the converged prefill carry (to publish) and the solve's step count.

    ``return_steps`` appends the prefill solve's step count and
    ``return_status`` its per-row health codes (``core.solvers.STATUS_*``).
    """
    _check_family(cfg)
    dev = params_device(params)
    x, pos = _input_embedding(params, batch, cfg, ctx)
    b, s = x.shape[:2]
    caches = init_cache(cfg, b, max_len, dev, ctx)
    idx0 = ctx.constrain(torch.zeros((b,), dtype=torch.int32, device=dev),
                         ("batch",))
    solve_carry = None
    if prefix_carry is not None:
        if not cfg.deq.enabled:
            raise ValueError("prefix_carry requires cfg.deq.enabled")
        if prefix_len is None:
            raise ValueError("prefix_carry requires prefix_len")
        # cached prefix positions start at the donor equilibrium, the live
        # suffix at the injection
        pmask = (pos < prefix_len[:, None])[..., None]
        solve_carry = dataclasses.replace(
            prefix_carry,
            z=torch.where(pmask, prefix_carry.z.to(x.dtype), x))
    z, caches, aux = apply_stack(params, x, cfg, pos, caches, idx0,
                                 train=False, carry=solve_carry, ctx=ctx)
    # for the DEQ the stack's output IS the equilibrium z*
    z_last = z[:, -1:, :]
    x = rmsnorm(params["final_norm"], z, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg, ctx)
    lengths = ctx.constrain(torch.full((b,), s, dtype=torch.int32,
                                       device=dev), ("batch",))
    out = (logits, caches, lengths)
    if carry is not None:
        out = out + (seed_carry(carry, z_last),)
    if prefix_carry is not None:
        out = out + (aux["solve_carry"], aux["deq_steps"])
    if return_steps:
        out = out + (aux.get("deq_steps", 0.0),)
    if return_status:
        out = out + (aux["deq_status"] if "deq_status" in aux else
                     torch.zeros((b,), dtype=torch.int32, device=dev),)
    return out


@torch.no_grad()
@_spmd_entry
def decode_step(params, caches, tokens: torch.Tensor,
                cache_index: torch.Tensor, cfg: ModelConfig, *,
                ctx: ShardCtx = NULL_CTX,
                active: torch.Tensor | None = None,
                carry: SolveCarry | None = None, return_steps: bool = False,
                return_status: bool = False):
    """One decode step: tokens ``(B,)`` at ``cache_index (B,)``.  Returns
    ``(logits (B, V), caches)``, plus the updated carry when ``carry`` is
    given, the solver's step count (``return_steps``; 0.0 without the DEQ)
    and the per-row health codes (``return_status``; zeros without the
    DEQ).  ``active: (B,) bool`` freezes finished/empty slots in the DEQ
    solve.  The caches are updated in place."""
    _check_family(cfg)
    x = embed_tokens(params["embed"], tokens[:, None], cfg, ctx)
    x = ctx.constrain(x, ("batch", "seq", "embed_act"))
    cache_index = ctx.constrain(cache_index, ("batch",))
    pos = ctx.constrain(cache_index[:, None].int(), ("batch", "seq"))
    if active is not None:
        active = ctx.constrain(active, ("batch",))
    z, caches, aux = apply_stack(params, x, cfg, pos, caches, cache_index,
                                 train=False, active=active, carry=carry,
                                 ctx=ctx)
    x = rmsnorm(params["final_norm"], z, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg, ctx)
    out = ((logits[:, 0], caches) if carry is None
           else (logits[:, 0], caches, aux.get("solve_carry", carry)))
    if return_steps:
        out = out + (aux.get("deq_steps", 0.0),)
    if return_status:
        out = out + (aux["deq_status"] if "deq_status" in aux else
                     torch.zeros((tokens.shape[0],), dtype=torch.int32,
                                 device=tokens.device),)
    return out
