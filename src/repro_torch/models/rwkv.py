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
state buffers held in the preallocated decode cache (core/state.py).  The
sequence-parallel time-mix (JAX ``_apply_tmix_seqpar``) is not ported: it
comes with the distributed code (ROADMAP Queue 1, "Distributed, launch and
checkpoint").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

F32 = torch.float32
N_MIX = 5  # w, k, v, r, g interpolation vectors


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.ssm.head_dim


def init_tmix(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              device="cpu") -> dict:
    d = cfg.d_model
    r = cfg.ssm.lora_rank
    H, dh = n_heads(cfg), cfg.ssm.head_dim

    def w(shape, scale, dt):
        return common.truncated_normal(gen, shape, scale, dt, device)

    return {
        # token-shift interpolation: base mu vectors + data-dependent LoRA
        "maa_x": torch.zeros(d, dtype=F32, device=device),
        "maa": torch.zeros(N_MIX, d, dtype=F32, device=device),
        "tm_w1": w((d, N_MIX * 32), d ** -0.5, F32),
        "tm_w2": w((N_MIX, 32, d), 32 ** -0.5, F32),
        # data-dependent decay: w0 + LoRA(xw)
        "w0": torch.linspace(-6.0, -0.3, d, dtype=F32, device=device),
        "td_w1": w((d, r), d ** -0.5, F32),
        "td_w2": w((r, d), r ** -0.5, F32),
        # projections
        "wr": w((d, d), d ** -0.5, dtype),
        "wk": w((d, d), d ** -0.5, dtype),
        "wv": w((d, d), d ** -0.5, dtype),
        "wg": w((d, d), d ** -0.5, dtype),
        "wo": w((d, d), d ** -0.5, dtype),
        # per-head bonus u
        "u": torch.zeros(H, dh, dtype=F32, device=device),
        "gn": common.init_groupnorm(H, d, F32, device),
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
    sx = _shifted(x, x_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x.to(F32), sx.to(F32))
    dt = x.dtype
    r = (xr.to(dt) @ p["wr"]).reshape(B, S, H, dh)
    k = (xk.to(dt) @ p["wk"]).reshape(B, S, H, dh)
    v = (xv.to(dt) @ p["wv"]).reshape(B, S, H, dh)
    g = F.silu(xg.to(dt) @ p["wg"])
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
    """Full-sequence time-mix (the JAX package's single-device
    ``_apply_tmix_local``).  Returns (out, shift', state')."""
    from repro_torch.core import plans as plans_lib

    B, S, d = x.shape
    H = n_heads(cfg)
    r, k, v, g, logw, shift = _project(p, cfg, x, x_prev)
    wkv_fn = plans_lib.RWKV_PLANS[plan or WKV_PLAN]
    out, state = wkv_fn(r, k, v, logw, p["u"], state, chunk=cfg.ssm.chunk)
    out = common.apply_groupnorm(p["gn"], out.reshape(B, S, d), H)
    out = (out.to(x.dtype) * g) @ p["wo"]
    return out, shift, state


def step_tmix(p: dict, cfg: ModelConfig, x: torch.Tensor,
              x_prev: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token time-mix.  x: (B,1,d)."""
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
def init_cmix(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              device="cpu") -> dict:
    d, ff = cfg.d_model, cfg.d_ff

    def w(shape, scale):
        return common.truncated_normal(gen, shape, scale, dtype, device)

    return {
        "mu_k": torch.zeros(d, dtype=F32, device=device),
        "mu_r": torch.zeros(d, dtype=F32, device=device),
        "wk": w((d, ff), d ** -0.5),
        "wv": w((ff, d), ff ** -0.5),
        "wr": w((d, d), d ** -0.5),
    }


def apply_cmix(p: dict, x: torch.Tensor, x_prev: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel-mix with token shift.  x: (B,S,d); x_prev: (B,d)."""
    sx = (_shifted(x, x_prev) - x).to(x.dtype)
    xk = x + sx * p["mu_k"].to(x.dtype)
    xr = x + sx * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, x[:, -1]
