"""Recurrent sequence mixers: Mamba (selective SSM) and xLSTM (mLSTM and
sLSTM), in chunkwise-parallel forms.

Counterpart of ``repro.models.ssm`` (XLA in the reference, no Pallas
kernel; plain torch here). Each mixer has a parallel form (train and
prefill) and a single-step form (decode) on the same parameters, and
takes its parameters as a mapping of name → tensor.

* Mamba: the depthwise causal conv as shifted adds; the selective scan
  in chunks of ``chunk`` steps (``nchunks = max(S // chunk, 1)``, which
  must divide S), the state carried from chunk to chunk and, inside a
  chunk, a log-step (Hillis–Steele) inclusive scan of the affine maps
  h ↦ dA·h + dBx. The reference's ``lax.associative_scan`` combines the
  same maps in another tree, so the states agree to f32 rounding, not
  bit for bit.
* mLSTM: the chunkwise gated-linear-attention form with sigmoid gates
  (the chunk shrinks until it divides S), the normalizer floored at 1.
* sLSTM: the scalar-memory cell, one step at a time, in f32 whatever
  the compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# --------------------------------------------------------------- mamba ---
def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, Di); w: (CW, Di): a depthwise causal conv by shifted
    adds."""
    cw, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(cw):
        shift = cw - 1 - i
        xs = F.pad(x, (0, 0, shift, 0))[:, :S] if shift else x
        out = out + xs * w[i]
    return out + b


def _ssm_scan_chunk(h0: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the selective scan. h0: (B, Di, N); dA, dBx: (B, C,
    Di, N). The inclusive scan of (a, b) pairs under (a1, b1) ∘ (a2, b2)
    = (a2·a1, a2·b1 + b2), in ⌈log2 C⌉ steps. Returns (h_end, h_all (B,
    C, Di, N))."""
    a, b = dA, dBx
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    h_all = a * h0[:, None] + b
    return h_all[:, -1], h_all


def mamba_mixer(x: torch.Tensor, p, cfg, state: dict | None = None,
                mode: str = "train", chunk: int = 128
                ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D). ``state`` (decode): {"h": (B, Di, N) f32, "conv":
    (B, CW−1, Di)}. Returns (y, new state: None in "train")."""
    B, S, D = x.shape
    di, n, cw, r = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_dt_rank
    dt_ = x.dtype
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(dt_))
    x1, z = xz.chunk(2, dim=-1)                             # (B, S, Di)

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("Mamba decode takes one token and a state")
        buf = torch.cat([state["conv"].to(dt_), x1], dim=1)  # (B, CW, Di)
        conv = torch.einsum("bwd,wd->bd", buf, p["conv_w"].to(dt_)
                            )[:, None, :] + p["conv_b"].to(dt_)
        new_conv = buf[:, 1:, :]
    else:
        conv = _causal_depthwise_conv(x1, p["conv_w"].to(dt_),
                                      p["conv_b"].to(dt_))
    xc = F.silu(conv)

    xdb = torch.einsum("bsd,de->bse", xc, p["x_proj"].to(dt_))
    dt_low = xdb[..., :r]
    Bc = xdb[..., r:r + n].float()
    Cc = xdb[..., r + n:].float()
    # softplus as jax.nn.softplus, log(1 + e^x) everywhere (F.softplus
    # turns linear past 20)
    pre = torch.einsum("bsr,rd->bsd", dt_low, p["dt_w"].to(dt_)).float() \
        + p["dt_b"].float()
    dt = torch.logaddexp(pre, torch.zeros((), device=x.device))  # (B,S,Di)
    A = -torch.exp(p["A_log"].float())                      # (Di, N)
    xcf = xc.float()

    new_state = None
    if mode == "decode":
        dA = torch.exp(dt[:, 0, :, None] * A)               # (B, Di, N)
        dBx = dt[:, 0, :, None] * Bc[:, 0, None, :] * xcf[:, 0, :, None]
        h = dA * state["h"] + dBx
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None, :]
        new_state = {"h": h, "conv": new_conv}
    else:
        nchunks = max(S // chunk, 1)
        if S % nchunks:
            raise ValueError(f"Mamba scan: S {S} is not a whole number of "
                             f"{nchunks} chunks (chunk {chunk})")
        csize = S // nchunks
        h = torch.zeros((B, di, n), dtype=torch.float32, device=x.device) \
            if state is None else state["h"]
        ys = []
        for c in range(nchunks):
            sl = slice(c * csize, (c + 1) * csize)
            dt_c = dt[:, sl]
            dA = torch.exp(dt_c[..., None] * A)             # (B, C, Di, N)
            dBx = dt_c[..., None] * Bc[:, sl, None, :] * xcf[:, sl, :, None]
            h, h_all = _ssm_scan_chunk(h, dA, dBx)
            ys.append(torch.einsum("bsdn,bsn->bsd", h_all, Cc[:, sl]))
        y = torch.cat(ys, dim=1)
        if mode == "prefill":
            # the last CW − 1 rows of x1, left-padded when S < CW − 1
            # (a copy: a view would keep the whole projection alive)
            conv_state = x1[:, S - (cw - 1):].clone() if S >= cw - 1 \
                else F.pad(x1, (0, 0, cw - 1 - S, 0))
            new_state = {"h": h, "conv": conv_state}
    y = (y + p["Dskip"].float() * xcf).to(dt_)
    y = y * F.silu(z)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt_)), new_state


# --------------------------------------------------------------- mLSTM ---
def _mlstm_chunk(q, k, v, li, lf, C0, n0, eps=1.0):
    """Chunkwise gated linear attention (sigmoid-gated mLSTM).

    q, k, v: (B, H, C, dh); li, lf: (B, H, C) log input and forget gates
    (≤ 0). C0: (B, H, dh, dh); n0: (B, H, dh). Returns (y, C1, n1)."""
    csz = q.shape[2]
    lF = torch.cumsum(lf, dim=-1)                   # log Π f up to t
    decay_t = torch.exp(lF)[..., None]              # (B, H, C, 1)
    y_state = decay_t * torch.einsum("bhtd,bhde->bhte", q, C0)
    n_state = decay_t * torch.einsum("bhtd,bhd->bht", q, n0)[..., None]
    # intra-chunk: w[t, s] = exp(lF_t − lF_s) · i_s for s ≤ t
    logw = lF[:, :, :, None] - lF[:, :, None, :] + li[:, :, None, :]
    tri = torch.tril(torch.ones((csz, csz), dtype=torch.bool,
                                device=q.device))
    w = torch.where(tri, torch.exp(logw), 0.0)      # (B, H, C, C)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * w
    y_intra = torch.einsum("bhts,bhsd->bhtd", scores, v)
    n_intra = scores.sum(dim=-1, keepdim=True)      # (B, H, C, 1)
    den = torch.clamp_min((n_state + n_intra).abs(), eps)
    y = (y_state + y_intra) / den
    decay_end = torch.exp(lF[:, :, -1])[..., None, None]
    rel = torch.exp(lF[:, :, -1:] - lF) * torch.exp(li)  # (B, H, C)
    C1 = decay_end * C0 + torch.einsum("bhs,bhsd,bhse->bhde", rel, k, v)
    n1 = decay_end[..., 0] * n0 + torch.einsum("bhs,bhsd->bhd", rel, k)
    return y, C1, n1


def mlstm_mixer(x: torch.Tensor, p, cfg, state: dict | None = None,
                mode: str = "train") -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D). ``state``: {"C": (B, H, dh, dh), "n": (B, H, dh)} f32.
    Returns (y, new state: None in "train")."""
    B, S, D = x.shape
    nh = cfg.n_heads
    di = cfg.ssm_expand * D
    dh = di // nh
    dt_ = x.dtype
    q = torch.einsum("bsd,dhe->bhse", x, p["wq"].to(dt_))
    k = torch.einsum("bsd,dhe->bhse", x, p["wk"].to(dt_)) / \
        torch.tensor(math.sqrt(dh), dtype=torch.float32).to(dt_)
    v = torch.einsum("bsd,dhe->bhse", x, p["wv"].to(dt_))
    gates = torch.einsum("bsd,dgh->bgsh", x.float(), p["w_if"].float())
    li = F.logsigmoid(gates[:, 0].transpose(1, 2))  # (B, H, S)
    lf = F.logsigmoid(gates[:, 1].transpose(1, 2))
    q, k, v = q.float(), k.float(), v.float()

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("mLSTM decode takes one token and a state")
        f = torch.exp(lf[:, :, 0])[..., None, None]
        i = torch.exp(li[:, :, 0])[..., None, None]
        C = f * state["C"] + i * torch.einsum("bhd,bhe->bhde", k[:, :, 0],
                                              v[:, :, 0])
        n = f[..., 0] * state["n"] + i[..., 0] * k[:, :, 0]
        # the xLSTM normalizer, floored at 1 (as the chunk form)
        den = torch.clamp_min(torch.einsum("bhd,bhd->bh", q[:, :, 0],
                                           n).abs(), 1.0)
        y = torch.einsum("bhd,bhde->bhe", q[:, :, 0], C) / den[..., None]
        y = y[:, :, None, :]
        new_state = {"C": C, "n": n}
    else:
        csz = min(cfg.xlstm_chunk, S)
        while S % csz:
            csz -= 1
        C = torch.zeros((B, nh, dh, dh), dtype=torch.float32,
                        device=x.device) if state is None else state["C"]
        n = torch.zeros((B, nh, dh), dtype=torch.float32,
                        device=x.device) if state is None else state["n"]
        ys = []
        for c in range(S // csz):
            sl = slice(c * csz, (c + 1) * csz)
            yc, C, n = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                    li[:, :, sl], lf[:, :, sl], C, n)
            ys.append(yc)
        y = torch.cat(ys, dim=2)
        new_state = {"C": C, "n": n} if mode == "prefill" else None

    y = y.transpose(1, 2).reshape(B, S, di).to(dt_)
    og = torch.sigmoid(torch.einsum("bsd,de->bse", x, p["w_og"].to(dt_)))
    return torch.einsum("bse,ed->bsd", y * og, p["w_out"].to(dt_)), \
        new_state


# --------------------------------------------------------------- sLSTM ---
def slstm_mixer(x: torch.Tensor, p, cfg, state: dict | None = None,
                mode: str = "train") -> tuple[torch.Tensor, dict | None]:
    """Scalar-memory LSTM with per-head block-diagonal recurrence.
    ``state``: {"c", "n", "h": (B, H, dh)} f32. Returns (y, new state:
    None in "train")."""
    B, S, D = x.shape
    nh = cfg.n_heads
    dh = D // nh
    wx = torch.einsum("bsd,dghe->bsghe", x.float(),
                      p["w_izfo"].float())          # (B, S, 4, H, dh)
    r = p["r_izfo"].float()                         # (4, H, dh, dh)
    b = p["b_izfo"].float()                         # (4, H, dh)
    if state is None:
        z0 = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
        c, n, h = z0, z0, z0
    else:
        c, n, h = state["c"], state["n"], state["h"]
    hs = []
    for t in range(S):
        z = wx[:, t] + torch.einsum("bhe,ghef->bghf", h, r) + b
        i = torch.sigmoid(z[:, 0])
        zin = torch.tanh(z[:, 1])
        f = torch.sigmoid(z[:, 2])
        o = torch.sigmoid(z[:, 3])
        c = f * c + i * zin
        n = f * n + i
        h = o * c / torch.clamp_min(n, 1e-6)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    new_state = {"c": c, "n": n, "h": h} if mode in ("prefill", "decode") \
        else None
    return torch.einsum("bsd,de->bse", y, p["w_sout"].to(x.dtype)), \
        new_state
