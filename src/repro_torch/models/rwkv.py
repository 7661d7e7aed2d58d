"""RWKV6 (Finch) blocks: time-mix (the wkv recurrence with data-dependent
decay) and channel-mix — the port's twin of the JAX package's
``models/rwkv.py``.

The full-sequence time-mix runs one plan of ``core/plans.RWKV_PLANS``
(module-level ``WKV_PLAN``, or ``plan=`` per call): ``chunked_scan`` is the
hand-written CUDA kernel (kernels/wkv6.py, K6) and the port's default,
because on the card the prefill must run the kernel; ``chunked_xla``
(``wkv_chunked`` below, the JAX package's default) and ``stepwise`` stay
selectable as plain-PyTorch plans for comparisons.  Decode runs the
per-token recurrence ``wkv_step`` in plain PyTorch, as the JAX package runs
it in jnp: there is no kernel on the decode path.

Dtypes follow the JAX package's casts: the token-shift interpolation
(``_ddlerp``) and the decay LoRA run in f32; r, k, v and g come out of the
projections in the model dtype; ``logw`` and the wkv state are f32; the wkv
output is in v's dtype before the head-norm of the full-sequence path (the
decode step feeds its f32 output to the head-norm, as JAX's does).

Token-shift state and the per-head (dk x dv) wkv state are the recurrent
state buffers held in the preallocated decode cache (core/state.py).

On a mesh of more than one device (``partitioning.use_rules`` over a
process group) the time-mix takes DTensors.  A ``seq_shard`` config whose
sequence splits into at least 4 tokens a rank runs the JAX package's
sequence-parallel pipeline (``_apply_tmix_seqpar``, the MobiRNN wavefront
carried across devices); any other runs the single-device body on each
rank's batch shard (``_apply_tmix_batch``), so the hand kernel sees only
rank-local tensors either way.
"""
from __future__ import annotations

import torch

from repro_torch import partitioning as pt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.partitioning import Annot, dense_init, zeros_init

F32 = torch.float32
N_MIX = 5  # w, k, v, r, g interpolation vectors


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.ssm.head_dim


def init_tmix_annot(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, device="cpu") -> dict:
    """The time-mix parameters with the JAX package's logical axes."""
    d = cfg.d_model
    r = cfg.ssm.lora_rank
    H, dh = n_heads(cfg), cfg.ssm.head_dim

    def w(shape, axes, scale, dt):
        return dense_init(gen, shape, axes, dt, device, scale)

    return {
        # token-shift interpolation: base mu vectors + data-dependent LoRA
        "maa_x": zeros_init((d,), ("embed_nofsdp",), F32, device),
        "maa": zeros_init((N_MIX, d), (None, "embed_nofsdp"), F32, device),
        "tm_w1": w((d, N_MIX * 32), ("embed", None), d ** -0.5, F32),
        "tm_w2": w((N_MIX, 32, d), (None, None, "embed"), 32 ** -0.5, F32),
        # data-dependent decay: w0 + LoRA(xw)
        "w0": Annot(torch.linspace(-6.0, -0.3, d, dtype=F32, device=device),
                    ("embed_nofsdp",)),
        "td_w1": w((d, r), ("embed", None), d ** -0.5, F32),
        "td_w2": w((r, d), (None, "embed"), r ** -0.5, F32),
        # projections
        "wr": w((d, d), ("embed", "mlp"), d ** -0.5, dtype),
        "wk": w((d, d), ("embed", "mlp"), d ** -0.5, dtype),
        "wv": w((d, d), ("embed", "mlp"), d ** -0.5, dtype),
        "wg": w((d, d), ("embed", "mlp"), d ** -0.5, dtype),
        "wo": w((d, d), ("mlp", "embed"), d ** -0.5, dtype),
        # per-head bonus u
        "u": zeros_init((H, dh), ("heads", None), F32, device),
        "gn": common.init_groupnorm_annot(H, d, F32, device),
    }


def _ddlerp(p: dict, x: torch.Tensor, sx: torch.Tensor
            ) -> tuple[torch.Tensor, ...]:
    """Data-dependent token-shift interpolation (rwkv6 'ddlerp'), f32."""
    B, S, d = x.shape
    xxx = x + sx * p["maa_x"]
    lora = torch.tanh(xxx @ p["tm_w1"]).reshape(B, S, N_MIX, 32)
    mixes = torch.einsum("bsnr,nrd->nbsd", lora, p["tm_w2"])    # (5,B,S,d)
    return tuple(x + sx * (p["maa"][i] + mixes[i]) for i in range(N_MIX))


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The sequence shifted one token right, ``x_prev`` in front."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _project(p: dict, cfg: ModelConfig, x: torch.Tensor,
             x_prev: torch.Tensor):
    """Common head: token shift + ddlerp + projections.

    x: (B,S,d); x_prev: (B,d) last token of the previous segment.
    Returns r,k,v,g (B,S,H,*) in x's dtype, logw (B,S,H,dk) f32 (<= 0),
    and the new shift state (B,d)."""
    B, S, d = x.shape
    H, dh = n_heads(cfg), cfg.ssm.head_dim
    # the shift's difference stays f32 into the f32 ddlerp: the JAX
    # package's compiled graph drops its bf16 round trip there
    sx = _shifted(x, x_prev).to(F32) - x.to(F32)
    xw, xk, xv, xr, xg = _ddlerp(p, x.to(F32), sx)
    dt = x.dtype
    r = (xr.to(dt) @ p["wr"]).reshape(B, S, H, dh)
    k = (xk.to(dt) @ p["wk"]).reshape(B, S, H, dh)
    v = (xv.to(dt) @ p["wv"]).reshape(B, S, H, dh)
    g = common.silu(xg.to(dt) @ p["wg"])
    w = p["w0"] + torch.tanh(xw @ p["td_w1"]) @ p["td_w2"]      # (B,S,d) f32
    logw = -torch.exp(w.reshape(B, S, H, dh))
    return r, k, v, g, logw, x[:, -1]


def wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Batched chunked wkv scan in plain PyTorch, f32.  r,k,logw:
    (B,S,H,dk); v: (B,S,H,dv); u: (H,dk); state: (B,H,dk,dv); S % chunk
    == 0.  Returns (out (B,S,H,dv) f32, state' f32)."""
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    assert S % chunk == 0, (S, chunk)
    n = S // chunk

    def to_chunks(a):                                # (n,B,H,C,*)
        return a.reshape(B, n, chunk, H, -1).permute(1, 0, 3, 2, 4).to(F32)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, logw))
    idx = torch.arange(chunk, device=r.device)
    mask = (idx[:, None] > idx[None, :])[..., None]
    neg_inf = torch.tensor(-torch.inf, device=r.device)
    u32 = u.to(F32)
    s = state.to(F32)
    outs = []
    for rr, kk, vv, ww in zip(rc, kc, vc, wc):           # (B,H,C,*)
        L = torch.cumsum(ww, dim=2)
        L_prev = L - ww
        out = torch.einsum("bhck,bhkv->bhcv", rr * torch.exp(L_prev), s)
        # mask the exponent, not the scores: j >= i entries are positive
        # and would overflow exp under strong decay, NaN-ing the VJP
        diff = L_prev[:, :, :, None, :] - L[:, :, None, :, :]
        diff = torch.exp(torch.where(mask, diff, neg_inf))
        scores = torch.einsum("bhik,bhjk,bhijk->bhij", rr, kk, diff)
        out = out + torch.einsum("bhij,bhjv->bhiv", scores, vv)
        bonus = torch.einsum("bhck,hk,bhck->bhc", rr, u32, kk)
        out = out + bonus[..., None] * vv
        L_last = L[:, :, -1]
        decay_j = torch.exp(L_last[:, :, None, :] - L)
        s = (torch.exp(L_last)[..., None] * s
             + torch.einsum("bhck,bhcv->bhkv", kk * decay_j, vv))
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, dv)
    return out, s


def wkv_step(r, k, v, logw, u, state):
    """Single decode step, f32.  r,k,logw: (B,H,dk); v: (B,H,dv);
    u: (H,dk); state: (B,H,dk,dv).  Returns (out (B,H,dv), state')."""
    r, k, v, logw = (a.to(F32) for a in (r, k, v, logw))
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r, state + u.to(F32)[..., None] * kv)
    state = torch.exp(logw)[..., None] * state + kv
    return out, state


#: default ``core/plans.RWKV_PLANS`` plan of the full-sequence scan.  The
#: JAX package defaults to "chunked_xla" (its jnp scan); the port defaults
#: to "chunked_scan", the registry's accelerator plan, so that a prefill on
#: the card runs the hand kernel.  Override per call through
#: ``apply_tmix(..., plan=...)`` or globally for comparisons.
WKV_PLAN = "chunked_scan"


def apply_tmix(p: dict, cfg: ModelConfig, x: torch.Tensor,
               x_prev: torch.Tensor, state: torch.Tensor,
               plan: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix.  Returns (out, shift', state').

    As in the JAX package, under ``use_rules`` with ``cfg.seq_shard``, a
    'model' axis m > 1, S % m == 0 and S // m >= 4, the sequence-parallel
    pipeline runs (``_apply_tmix_seqpar``).  Otherwise the single-device
    body (``_apply_tmix_local``), on a mesh of more than one device on
    each rank's batch shard (``_apply_tmix_batch``)."""
    rules = pt.active_rules()
    if rules is None:
        return _apply_tmix_local(p, cfg, x, x_prev, state, plan)
    m = rules.mesh.shape.get("model", 1)
    S = x.shape[1]
    if cfg.seq_shard and m > 1 and S % m == 0 and S // m >= 4:
        return _apply_tmix_seqpar(p, cfg, x, x_prev, state, rules, plan)
    return _apply_tmix_batch(p, cfg, x, x_prev, state, rules, plan)


def _apply_tmix_local(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      x_prev: torch.Tensor, state: torch.Tensor,
                      plan: str | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The single-device time-mix (the JAX package's
    ``_apply_tmix_local``)."""
    from repro_torch.core import plans as plans_lib

    B, S, d = x.shape
    H = n_heads(cfg)
    r, k, v, g, logw, shift = _project(p, cfg, x, x_prev)
    wkv_fn = plans_lib.RWKV_PLANS[plan or WKV_PLAN]
    out, state = wkv_fn(r, k, v, logw, p["u"], state, chunk=cfg.ssm.chunk)
    out = common.apply_groupnorm(p["gn"], out.reshape(B, S, d), H)
    out = (out.to(x.dtype) * g) @ p["wo"]
    return out, shift, state


def _specs(rules, x: torch.Tensor, state: torch.Tensor, seq: str):
    """in_specs of the time-mix bodies: x (batch, ``seq``, None), x_prev
    (batch, None), the state (batch, ...), the parameters replicated."""
    B, _, d = x.shape
    return (rules.spec_for(("batch", seq, None), x.shape),
            rules.spec_for(("batch", None), (B, d)),
            rules.spec_for(("batch", None, None, None), state.shape),
            pt.PartitionSpec())


def _apply_tmix_batch(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      x_prev: torch.Tensor, state: torch.Tensor, rules,
                      plan: str | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The single-device body on each rank's batch shard, the sequence
    whole and the parameters replicated: the path of a mesh of more than
    one device where the sequence does not shard.  The wkv scan has no
    DTensor sharding rule (on the card it is the hand kernel), so the
    inputs are redistributed to these specs explicitly; ranks along
    'model' compute the same outputs."""
    x_spec, b_spec, st_spec, p_spec = _specs(rules, x, state, "seq")

    def local_fn(x_loc, xp_loc, s_loc, p_loc):
        return _apply_tmix_local(p_loc, cfg, x_loc, xp_loc, s_loc, plan)

    fn = pt.shard_map(local_fn, rules.mesh,
                      in_specs=(x_spec, b_spec, st_spec, p_spec),
                      out_specs=(x_spec, b_spec, st_spec))
    return tuple(fn(x, x_prev, state, p))


def _apply_tmix_seqpar(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       x_prev: torch.Tensor, state: torch.Tensor, rules,
                       plan: str | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence-parallel time-mix (the JAX package's ``_apply_tmix_seqpar``,
    step for step).

    Activations arrive sequence-sharded over the 'model' axis.  Everything
    per token (ddlerp, projections, head-norm, gating) is rank-local; the
    cross-rank parts are

      1. token shift: the last token of shard i is the shift input of
         shard i+1 — one (B, d) cyclic ``ppermute``;
      2. the wkv state carry: each shard's scan is affine in its incoming
         state, ``S_out = D ⊙ S_in + A`` with D = exp(Σ logw) and A the
         scan from a zero state, so the global recurrence is an exclusive
         prefix over shards of affine maps: ceil(log2 m) Hillis-Steele
         rounds of ``ppermute``s of (D, A), then one exclusive permute;
      3. one correction product folding the incoming state into the local
         outputs: out_t += (r_t ⊙ exp(L_prev,t)) @ S_in, in f32.

    The final state and the shift state are masked to the last shard and
    ``psum``med over 'model'.  The one difference from the JAX package: the
    scan from zero runs the registered plan (``plan`` or ``WKV_PLAN``; on
    the card K6, under autograd K6t and K6b, whose final-state cotangent
    carries the prefix's gradient), where JAX calls ``wkv_chunked``."""
    from repro_torch.core import plans as plans_lib

    m_size = rules.mesh.shape["model"]
    H, dh = n_heads(cfg), cfg.ssm.head_dim
    d = x.shape[-1]
    wkv_fn = plans_lib.RWKV_PLANS[plan or WKV_PLAN]
    x_spec, b_spec, st_spec, p_spec = _specs(rules, x, state, "seq_model")

    def local_fn(x_loc, x_prev_g, s0_g, p_loc):
        idx = pt.axis_index("model")
        dev = x_loc.device

        def mask(flag: bool) -> torch.Tensor:
            # a rank-dependent select as a tensor: every rank builds the
            # same graph, so the collectives' backwards meet
            return torch.tensor(flag, device=dev)

        B_loc, S_loc = x_loc.shape[0], x_loc.shape[1]
        # --- 1. token shift across the shard boundary ------------------
        recv = pt.ppermute(x_loc[:, -1], "model",
                           [(i, (i + 1) % m_size) for i in range(m_size)])
        xp = torch.where(mask(idx == 0), x_prev_g.to(x_loc.dtype), recv)
        r, k, v, g, logw, _ = _project(p_loc, cfg, x_loc, xp)

        # --- 2. local scan from zero + affine summary ------------------
        chunk = cfg.ssm.chunk
        while S_loc % chunk:
            chunk -= 1
        zero = torch.zeros((B_loc, H, dh, dh), dtype=F32, device=dev)
        out0, a_loc = wkv_fn(r, k, v, logw, p_loc["u"], zero, chunk=chunk)
        d_loc = torch.exp(logw.to(F32).sum(1))                  # B,H,dk

        # inclusive Hillis-Steele prefix of (D, A) over the model axis
        d_agg, a_agg = d_loc, a_loc
        shift_amt = 1
        while shift_amt < m_size:
            perm = [(i, i + shift_amt) for i in range(m_size - shift_amt)]
            d_r = pt.ppermute(d_agg, "model", perm)
            a_r = pt.ppermute(a_agg, "model", perm)
            has = mask(idx >= shift_amt)
            # compose: earlier segment (recv) then mine:
            #   D = D_mine * D_recv ; A = D_mine ⊙ A_recv + A_mine
            d_new = torch.where(has, d_agg * d_r, d_agg)
            a_new = torch.where(has, d_agg[..., None] * a_r + a_agg, a_agg)
            d_agg, a_agg = d_new, a_new
            shift_amt *= 2
        # exclusive prefix = inclusive of shard i-1 (shard 0: global s0)
        perm1 = [(i, i + 1) for i in range(m_size - 1)]
        a_excl = pt.ppermute(a_agg, "model", perm1)
        d_excl = pt.ppermute(d_agg, "model", perm1)
        s0 = s0_g.to(F32)
        s_in = torch.where(mask(idx == 0), s0,
                           a_excl + d_excl[..., None] * s0)

        # --- 3. fold the carry into local outputs ----------------------
        lw32 = logw.to(F32)
        l_prev = torch.cumsum(lw32, dim=1) - lw32                # B,S,H,dk
        carry = torch.einsum("bshk,bhkv->bshv",
                             r.to(F32) * torch.exp(l_prev), s_in)
        out = out0 + carry

        # final state (replicated): inclusive aggregate of the last shard
        last = mask(idx == m_size - 1)
        s_fin = a_agg + d_agg[..., None] * s0
        s_fin = pt.psum(torch.where(last, s_fin, torch.zeros_like(s_fin)),
                        "model")
        # shift state = globally-last token (replicated)
        tail = x_loc[:, -1]
        shift = pt.psum(torch.where(last, tail, torch.zeros_like(tail)),
                        "model")

        out = common.apply_groupnorm(p_loc["gn"],
                                     out.reshape(B_loc, S_loc, d), H)
        out = (out.to(x_loc.dtype) * g) @ p_loc["wo"]
        return out, shift.to(x_loc.dtype), s_fin

    fn = pt.shard_map(local_fn, rules.mesh,
                      in_specs=(x_spec, b_spec, st_spec, p_spec),
                      out_specs=(x_spec, b_spec, st_spec))
    return tuple(fn(x, x_prev, state, p))


def step_tmix(p: dict, cfg: ModelConfig, x: torch.Tensor,
              x_prev: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token time-mix.  x: (B,1,d).  On a mesh of more than one device
    (DTensors) the body of ``_apply_tmix_batch``'s layout: each rank's
    batch shard, the parameters whole."""
    rules = pt.active_rules()
    if rules is not None:
        x_spec, b_spec, st_spec, p_spec = _specs(rules, x, state, "seq")
        fn = pt.shard_map(lambda *a: step_tmix(a[3], cfg, *a[:3]),
                          rules.mesh, in_specs=(x_spec, b_spec, st_spec,
                                                p_spec),
                          out_specs=(x_spec, b_spec, st_spec))
        return tuple(fn(x, x_prev, state, p))
    B, _, d = x.shape
    H = n_heads(cfg)
    r, k, v, g, logw, shift = _project(p, cfg, x, x_prev)
    out, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["u"],
                          state)
    out = common.apply_groupnorm(p["gn"], out.reshape(B, 1, d), H)
    out = (out.to(x.dtype) * g) @ p["wo"]
    return out, shift, state


# ---------------------------------------------------------------------------
# Channel-mix
# ---------------------------------------------------------------------------
def init_cmix_annot(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, device="cpu") -> dict:
    """The channel-mix parameters with the JAX package's logical axes."""
    d, ff = cfg.d_model, cfg.d_ff

    def w(shape, axes, scale):
        return dense_init(gen, shape, axes, dtype, device, scale)

    return {
        "mu_k": zeros_init((d,), ("embed_nofsdp",), F32, device),
        "mu_r": zeros_init((d,), ("embed_nofsdp",), F32, device),
        "wk": w((d, ff), ("embed", "mlp"), d ** -0.5),
        "wv": w((ff, d), ("mlp", "embed"), ff ** -0.5),
        "wr": w((d, d), ("embed", "mlp"), d ** -0.5),
    }


def apply_cmix(p: dict, x: torch.Tensor, x_prev: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel-mix with token shift.  x: (B,S,d); x_prev: (B,d).  On a
    mesh of more than one device (DTensors) ``_apply_cmix_sharded``."""
    rules = pt.active_rules()
    if rules is not None:
        return _apply_cmix_sharded(p, x, x_prev, rules)
    sx = (_shifted(x, x_prev) - x).to(x.dtype)
    xk = x + sx * p["mu_k"].to(x.dtype)
    xr = x + sx * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = common.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, x[:, -1]


def _apply_cmix_sharded(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                        rules) -> tuple[torch.Tensor, torch.Tensor]:
    """The channel-mix as a ``shard_map`` body: each rank's batch shard
    and, for a sequence split over 'model' (``seq_model``), its tokens,
    the weights whole.  The first token of a sequence shard shifts in the
    previous shard's last one (a cyclic ``ppermute`` over 'model'; shard 0
    takes ``x_prev``), and the new shift state is the last shard's last
    token (masked and ``psum``med over 'model'), as
    ``_apply_tmix_seqpar``'s step 1 does."""
    x_spec = rules.spec_for(("batch", "seq_model", None), x.shape)
    b_spec = rules.spec_for(("batch", None), x_prev.shape)
    split = pt.sharded_over(x_spec, 1, rules.mesh)
    m = rules.mesh.shape.get("model", 1)

    def local_fn(x_loc, xp_loc, p_loc):
        if not split:
            return apply_cmix(p_loc, x_loc, xp_loc)
        idx = pt.axis_index("model")
        dev = x_loc.device
        recv = pt.ppermute(x_loc[:, -1], "model",
                           [(i, (i + 1) % m) for i in range(m)])
        first = torch.where(torch.tensor(idx == 0, device=dev),
                            xp_loc.to(x_loc.dtype), recv)
        out, _ = apply_cmix(p_loc, x_loc, first)
        tail = x_loc[:, -1]
        shift = pt.psum(torch.where(torch.tensor(idx == m - 1, device=dev),
                                    tail, torch.zeros_like(tail)), "model")
        return out, shift

    fn = pt.shard_map(local_fn, rules.mesh,
                      in_specs=(x_spec, b_spec, pt.PartitionSpec()),
                      out_specs=(x_spec, b_spec))
    return tuple(fn(x, x_prev, p))
