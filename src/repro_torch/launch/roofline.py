"""Roofline analysis of the dry run's cells (launch/dryrun.py).

Counterpart of ``repro.launch.roofline``. Three terms per (arch × shape
× mesh), in seconds, against the H100 SXM5 datasheet constants of
launch/mesh.py (not measurements):

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = Σ ring-model bytes of every collective / LINK_BW

The reference reads its collectives out of XLA's optimized HLO text
(``parse_collectives``); the port has no compiler and no HLO. Its
counterpart is the dry run's count of the collectives a DTensor run of
the step issues on a fake process group of the mesh's size
(``dryrun.count_collectives``), each priced by the same ring model,
:func:`_ring_bytes`. MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE)
gives the usefulness ratio. Everything here is f64 Python arithmetic,
line for line the reference's.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models import schema as schema_api

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _ring_bytes(op: str, out_bytes: int, n: int) -> float:
    """Per-device bytes moved over links, ring model."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / n
    if op == "all-gather":
        return out_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return out_bytes * (n - 1)          # output is the 1/n shard
    if op == "all-to-all":
        return out_bytes * (n - 1) / n
    if op == "collective-permute":
        return float(out_bytes)
    return 0.0


def analytic_flops(cfg: ArchConfig, cell) -> float:
    """Closed-form FLOP accounting per cell (global, all devices).

    The dry run takes the larger of this and the FLOPs it counts on the
    meta device, as the reference takes the larger of this and XLA's
    cost analysis: dominant matmul terms only, 2·M·N·K per matmul. Training
    ≈ 4× forward (fwd + 2×bwd + ~1× remat recompute); decode = forward
    on 1 token/sequence against a seq_len cache.
    """
    B, S = cell.batch, cell.seq
    d, ff = cfg.d_model, cfg.d_ff
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_dec = max(S // 4, 64) if cfg.is_encdec else S
    if cell.kind == "train":
        T, s_kv, mult = B * s_dec, s_dec, 4.0     # remat on
        causal, s_cross = 0.5, S
    elif cell.kind == "prefill":
        T, s_kv, mult = B * s_dec, s_dec, 1.0
        causal, s_cross = 0.5, S
    else:
        T, s_kv, mult = B * 1, S, 1.0
        causal, s_cross = 1.0, cfg.cross_len      # 1 query, full cache

    def attn_flops(skv=None, cz=None):
        skv = s_kv if skv is None else skv
        cz = causal if cz is None else cz
        proj = 2 * T * d * (h * dh + 2 * kh * dh) + 2 * T * h * dh * d
        qk_v = 2 * 2 * T * skv * h * dh * cz
        return proj + qk_v

    def mlp_flops(f):
        return 2 * T * 3 * d * f if f else 0.0

    def moe_flops():
        slots = T * cfg.moe_topk * max(cfg.capacity_factor, 1.0)
        expert = 2 * slots * 3 * d * ff
        router = 2 * T * d * cfg.moe_experts
        if cfg.moe_dispatch == "einsum":
            # GShard one-hot dispatch+combine: T·(Tg·k·cf)·D each
            tg = min(cfg.moe_group_size, T)
            dispatch = 4 * T * tg * cfg.moe_topk * \
                max(cfg.capacity_factor, 1.0) * d
        else:
            dispatch = 4 * slots * d      # gathers: bytes, not flops
        return expert + router + dispatch

    def mamba_flops():
        di, n = cfg.d_inner, cfg.ssm_state
        proj = 2 * T * d * 2 * di + 2 * T * di * d
        small = 2 * T * di * (cfg.ssm_dt_rank + 2 * n) + \
            2 * T * cfg.ssm_dt_rank * di + 2 * T * cfg.ssm_conv * di
        scan = 8 * T * di * n              # discretize + recurrence + y
        return proj + small + scan

    def mlstm_flops():
        di = cfg.ssm_expand * d
        dhh = di // cfg.n_heads
        csz = min(cfg.xlstm_chunk, S) if cell.kind != "decode" else 0
        proj = 2 * T * d * 3 * di + 2 * T * d * di * 2   # qkv + og + out
        intra = 2 * 2 * T * csz * di * 0.5               # qk + y, causal
        state = 2 * 2 * T * di * dhh                     # C update + read
        return proj + intra + state

    def slstm_flops():
        dhh = d // cfg.n_heads
        return 2 * T * d * 4 * d + 2 * T * 4 * dhh * d + 2 * T * d * d

    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.xlstm:
            total += slstm_flops() if (i + 1) % cfg.slstm_every == 0 \
                else mlstm_flops()
            continue
        total += attn_flops() if cfg.is_attn_layer(i) else mamba_flops()
        if cfg.is_encdec:
            total += attn_flops(skv=s_cross, cz=1.0)   # cross attention
        if cfg.is_moe_layer(i):
            total += moe_flops()
        else:
            f = cfg.dense_ff if cfg.dense_ff else ff
            total += mlp_flops(f)
    if cfg.is_encdec:
        # encoder processes the frame sequence at full length
        T_enc = B * S if cell.kind != "decode" else 0
        enc = cfg.n_enc_layers * (
            2 * T_enc * d * (h * dh + 2 * kh * dh) + 2 * T_enc * h * dh * d
            + 2 * 2 * T_enc * S * h * dh + 2 * T_enc * 2 * d * ff)
        total += enc
    total += 2 * T * d * cfg.padded_vocab          # lm head
    return total * mult


def analytic_bytes(cfg: ArchConfig, cell, n_devices: int,
                   moment_dtype: str = "float32",
                   ffn_mode: str = "tp") -> float:
    """Per-device HBM traffic model (bytes/step), the reference's: it
    assumes elementwise chains and softmax fuse, and attention scores
    hit HBM once per pass without the flash kernel. The port's eager
    steps fuse far less (PERF.md, P15 and P16), so this is a floor on
    what the card moves, not a count of it.

    Methodology per component (train: fwd + remat-fwd + bwd ≈ 3 activation
    passes; params: cast-read + 2 fwd reads + bwd read + grad rw +
    optimizer state rw + write):
    """
    B, S = cell.batch, cell.seq
    d, ff = cfg.d_model, cfg.d_ff
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mdl = 16 if n_devices >= 256 else max(n_devices // 16, 1)
    if ffn_mode in ("dp", "dp_batch"):
        mdl = 1                       # no TP: tokens spread over all axes
    data = n_devices // mdl
    params_dev = schema_api.param_count(cfg, padded=True) / n_devices
    s_dec = max(S // 4, 64) if cfg.is_encdec else S

    if cell.kind == "train":
        t_dev = B * s_dec / data            # tokens per device
        passes = 3.0                        # fwd + remat + bwd
        mom = {"float32": 16, "bfloat16": 8, "int8": 4.2}[moment_dtype]
        param_traffic = params_dev * (4 + 2 + 2 + 2 + 8 + mom + 4)
    elif cell.kind == "prefill":
        t_dev = B * s_dec / data
        passes = 1.0
        param_traffic = params_dev * 2      # bf16 read once
    else:
        t_dev = B / data                    # decode: 1 token per seq
        passes = 1.0
        param_traffic = params_dev * 2

    # per-layer activation flows (residual stream, projections, FFN)
    ff_dev = ff / mdl if ff else 0
    act = 0.0
    for i in range(cfg.n_layers):
        if cfg.xlstm:
            di = cfg.ssm_expand * d
            act += t_dev * (6 * d + 6 * di / mdl) * 2
            continue
        if cfg.is_attn_layer(i):
            h_dev = max(h // mdl, 1) * dh if cfg.n_heads % mdl == 0 \
                else h * dh / mdl
            act += t_dev * (8 * d + 4 * h_dev) * 2
            # score matrices: the unfused baseline writes+reads them in
            # f32 per pass; the flash kernel keeps its tiles on chip
            if cell.kind != "decode" and not cfg.use_flash_attention:
                skv = s_dec
                heads_dev = h / mdl
                act += (t_dev * skv * heads_dev) * 4 * 2
        else:
            di_dev = cfg.d_inner / mdl
            act += t_dev * (6 * d + 8 * di_dev
                            + 2 * di_dev * cfg.ssm_state) * 2
        if cfg.is_moe_layer(i):
            slots = t_dev * cfg.moe_topk * max(cfg.capacity_factor, 1.0)
            act += slots * (4 * d + 2 * ff_dev) * 2
        elif ff or cfg.dense_ff:
            f = (cfg.dense_ff if cfg.dense_ff else ff) / mdl
            act += t_dev * (2 * d + 4 * f) * 2
    act *= passes
    if cfg.is_encdec and cell.kind != "decode":
        act += cfg.n_enc_layers * (B * S / data) * (8 * d + 4 * ff / mdl) \
            * 2 * passes

    # logits + embedding
    vp_dev = cfg.padded_vocab / mdl
    logits = t_dev * vp_dev * 4 * (2 if cell.kind == "train" else 1)
    embed = t_dev * d * 2 * passes

    # decode: the KV cache / recurrent state is read once per step
    cache = 0.0
    if cell.kind == "decode":
        b_dev = max(B / data, 1)
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if (not cfg.xlstm) and cfg.is_attn_layer(i))
        kv_b = 1.07 if cfg.kv_cache_dtype == "int8" else 2  # +scales
        cache += n_attn * b_dev * (S / mdl) * kh * dh * 2 * kv_b
        if cfg.is_encdec:
            cache += cfg.n_layers * b_dev * (cfg.cross_len / mdl) * \
                kh * dh * 2 * 2
        n_ssm = sum(1 for i in range(cfg.n_layers)
                    if cfg.xlstm or not cfg.is_attn_layer(i))
        state_sz = (cfg.d_inner / mdl) * cfg.ssm_state * 4 if not cfg.xlstm \
            else (cfg.ssm_expand * d / mdl) * (cfg.ssm_expand * d
                                               / cfg.n_heads) * 4
        cache += n_ssm * b_dev * state_sz * 2
    return param_traffic + act + logits + embed + cache


def model_flops(cfg: ArchConfig, cell, n_tokens: int | None = None) -> float:
    """6·N·D with N = active params; decode cells process batch tokens."""
    n_active = schema_api.active_param_count(cfg)
    if n_tokens is None:
        if cell.kind == "train":
            n_tokens = cell.batch * cell.seq
        elif cell.kind == "prefill":
            n_tokens = cell.batch * cell.seq
        else:
            n_tokens = cell.batch              # one token per sequence
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active * n_tokens


def roofline(flops_dev: float, bytes_dev: float,
             coll_bytes_dev: float | None, coll_meta: dict,
             cfg: ArchConfig, cell, n_devices: int,
             raw_cost: dict | None = None) -> dict:
    """Three-term roofline. ``flops_dev``/``bytes_dev``/``coll_bytes_dev``
    are the per-device numbers of the dry run (counted FLOPs max'ed with
    the analytic ones, the analytic bytes, the priced collectives).
    ``coll_bytes_dev`` None (a cell whose collectives could not be
    traced) leaves the collective term None and out of the bound."""
    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    collective_s = None if coll_bytes_dev is None \
        else coll_bytes_dev / LINK_BW
    mf = model_flops(cfg, cell)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    known = {k: v for k, v in terms.items() if v is not None}
    dominant = max(known, key=known.get)
    bound = max(known.values())
    useful = mf / max(flops_dev * n_devices, 1.0)
    # ideal step time: compute at peak — but decode is weights/KV-
    # bandwidth-bound by nature, so its floor is reading the active
    # params (bf16) + the KV/state cache once per step
    ideal_s = mf / n_devices / PEAK_FLOPS_BF16
    if cell.kind == "decode":
        n_active = schema_api.active_param_count(cfg)
        kv = analytic_bytes(cfg, cell, n_devices) - 2 * n_active / n_devices
        floor_bytes = 2.0 * n_active / n_devices + max(kv, 0.0)
        ideal_s = max(ideal_s, floor_bytes / HBM_BW)
    return {
        **terms,
        "dominant": dominant,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_bytes_dev,
        "collective_counts": coll_meta.get("counts", {}),
        "collective_per_op_bytes": coll_meta.get("per_op_bytes", {}),
        "model_flops": mf,
        "useful_flops_ratio": useful,
        "raw_cost_analysis": raw_cost or {},
        # fraction of roofline: the ideal step time (MODEL_FLOPS at peak;
        # for decode: the weights+KV HBM floor) vs the binding term
        "ideal_s": ideal_s,
        "roofline_fraction": ideal_s / max(bound, 1e-12),
    }
