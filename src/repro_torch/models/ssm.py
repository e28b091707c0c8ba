"""Mamba2 block (SSD form): forward (chunked scan) and one-token decode.
Counterpart of `repro/models/ssm.py`.

Structure (arXiv:2405.21060):
  in_proj x -> [z | xc | B | C | dt]   (gate, conv channels, proj, step)
  causal depthwise conv over [xc|B|C] + silu
  SSD scan over per-head (x, dt, A, B, C)
  gated RMSNorm (y * silu(z)), out_proj

ngroups = 1 (B/C shared across heads). Decode carries a conv window
(the last conv_width - 1 pre-conv inputs) and the (nh, hp, N) SSM
state: a fixed-size state, not a KV ring. The port's decode writes both
into the cache tensors in place (the reference returns new buffers); a
caller that needs an older cache afterwards clones it first.

`A_log`, `D` and `dt_bias` are float32 leaves in a bf16 model, as in
the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import (Rng, as_dtype, dense_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.sharding.dtensor import (batch_layout, is_dtensor,
                                         kernel_axes, local_call, reshape)
from repro_torch.sharding.rules import P
from repro_torch.utils.pytree import tree_flatten, tree_unflatten


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads
    hp = cfg.ssm_head_dim
    assert nh * hp == d_in, (nh, hp, d_in)
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return d_in, nh, hp, N, conv_dim


def mamba_init(rng: Rng, cfg, dtype):
    d = cfg.d_model
    d_in, nh, hp, N, conv_dim = _dims(cfg)
    proj_out = 2 * d_in + 2 * N + nh          # z, xc, B, C, dt
    dev, dt = rng.device, as_dtype(dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init(rng, d, proj_out, dtype),
        "conv_w": (torch.randn((cfg.conv_width, conv_dim), generator=rng.next(),
                               **f32) * 0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.zeros((nh,), **f32),       # A = -exp(A_log) = -1
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.full((nh,), -2.0, **f32),  # softplus ~ 0.12
        "norm": rmsnorm_init(d_in, dtype, dev),
        "w_out": dense_init(rng, d_in, d, dtype),
    }


def _split_proj(cfg, proj):
    d_in, nh, hp, N, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in, N, N, nh], dim=-1)  # z, xc, B, C, dt


def _causal_conv(params, xbc, cfg):
    """Depthwise causal conv over (B, L, conv_dim), in the parameters'
    dtype."""
    W = cfg.conv_width
    L = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for w in range(W):
        out = out + pad[:, w:w + L] * params["conv_w"][W - 1 - w]
    return out + params["conv_b"]


def mamba_forward(params, cfg, x, *, ssd_impl: str | None = None,
                  return_cache: bool = False):
    """x: (B, L, d) -> (B, L, d) via the chunked SSD scan.

    With return_cache, also returns the decode cache after the last token
    (conv tail + final SSM state) for prefill -> decode handoff."""
    Bsz, L, _ = x.shape
    d_in, nh, hp, N, conv_dim = _dims(cfg)
    # on a mesh the projection is gathered to the batch layout: DTensor
    # propagates the split, the conv's shifted slices and their
    # backward into sequence shards that its matmul rules refuse
    proj = batch_layout(x @ params["w_in"])
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)
    xbc_pre = torch.cat([xc, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(params, xbc_pre, cfg))
    xc, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = reshape(xc, Bsz, L, nh, hp)
    # pad L to a chunk multiple; dt = 0 padding is exact (decay 1, no input)
    chunk = min(cfg.ssm_chunk, L)
    pad = (-L) % chunk
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        Bm_p = F.pad(Bm, (0, 0, 0, pad))
        Cm_p = F.pad(Cm, (0, 0, 0, pad))
    else:
        xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm
    out = ssd_ops.ssd_chunked(xh_p, dt_p, A, Bm_p, Cm_p, chunk=chunk,
                              impl=ssd_impl, return_final_state=return_cache)
    y, state = out if return_cache else (out, None)
    if pad:
        y = y[:, :L]
    y = (y + xh * params["D"][None, None, :, None]).to(x.dtype)
    y = reshape(y, Bsz, L, d_in)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    y = y @ params["w_out"]
    if return_cache:
        return y, {"conv": xbc_pre[:, -(cfg.conv_width - 1):], "state": state}
    return y


def mamba_init_cache(cfg, batch: int, dtype, device="cuda"):
    d_in, nh, hp, N, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=as_dtype(dtype), device=device),
        "state": torch.zeros((batch, nh, hp, N), dtype=torch.float32,
                             device=device),
    }


def _mamba_decode_core(params, cfg, x, conv, state):
    """One-token decode on plain tensors: (out (B, 1, d), the new conv
    window, the new SSM state)."""
    Bsz = x.shape[0]
    d_in, nh, hp, N, conv_dim = _dims(cfg)
    proj = x[:, 0] @ params["w_in"]
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)
    xbc = torch.cat([xc, Bm, Cm], dim=-1)          # (B, conv_dim)
    # full window = [cache, new]
    window = torch.cat([conv, xbc[:, None, :].to(conv.dtype)],
                       dim=1)                      # (B, W, conv_dim)
    # the forward conv applies conv_w[lag] to x[t - lag]; window[i] holds
    # lag W - 1 - i, so the kernel is flipped here to match (`_causal_conv`)
    conv_out = (torch.einsum("bwc,wc->bc", window.float(),
                             params["conv_w"].flip(0).float())
                + params["conv_b"].float())
    xbc_act = F.silu(conv_out).to(x.dtype)
    xc2, Bm2, Cm2 = torch.split(xbc_act, [d_in, N, N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xc2.reshape(Bsz, nh, hp)
    y, state = ssd_ops.ssd_decode_step(state, xh, dt, A, Bm2, Cm2)
    y = (y + xh * params["D"][None, :, None]).to(x.dtype)
    y = y.reshape(Bsz, d_in)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return (y @ params["w_out"])[:, None, :], window[:, 1:], state


def mamba_decode(params, cfg, x, cache):
    """One-token decode. x: (B, 1, d). Returns (y, cache): the new conv
    window and state are written into ``cache["conv"]`` and
    ``cache["state"]`` in place. On DTensors (a step on a mesh) each
    rank decodes its own batch rows with the mixer's weights whole
    (`local_map`): DTensor lacks rules for some of the step's ops (the
    card's torch has none for the kernel flip)."""
    if is_dtensor(x):
        ws, treedef = tree_flatten(params)
        b, _ = kernel_axes(x, x.shape[0])
        rows = lambda n: P(b, *[None] * (n - 1))    # noqa: E731

        def local(x_, conv, state, *ws_):
            return _mamba_decode_core(tree_unflatten(treedef, list(ws_)),
                                      cfg, x_, conv, state)

        out, conv, state = local_call(
            local, (x, cache["conv"], cache["state"], *ws),
            (rows(3), rows(3), rows(4), *[P(*[None] * w.ndim) for w in ws]),
            (rows(3), rows(3), rows(4)))
    else:
        out, conv, state = _mamba_decode_core(params, cfg, x, cache["conv"],
                                              cache["state"])
    cache["conv"].copy_(conv)
    cache["state"].copy_(state)
    return out, cache
