"""Mamba2 mixer — chunked state-space duality (SSD), in PyTorch (the port
of the JAX package's ``models/ssm.py``).

``ssd_chunked`` is the published minimal SSD algorithm (arXiv:2405.21060
listing 1), written out as the reference writes it: it is the plain
version of the ``ssd_scan`` kernel, which ``mamba2_forward`` calls for
the scan (the prefill always starts from a zero state, the kernel's
contract).

Projections are kept as separate matrices (w_z / w_x / w_B / w_C / w_dt
and separate depthwise convs for x vs B/C), so the reference's weights
carry across leaf for leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import dense_init, rms_norm

NEG_INF = -1e30


def segsum(x):
    """x [..., T] -> lower-triangular segment sums [..., T, T] (log-space)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.tensor(NEG_INF, device=x.device))


def ssd_chunked(X, A, B, C, chunk: int):
    """Chunked SSD from a zero state.

    X: [b, l, h, p] (pre-multiplied by dt), A: [b, l, h] log-decay
    (dt*A_cont), B, C: [b, l, h, n]. Returns (Y [b, l, h, p],
    final_state [b, h, p, n])."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk
    Xc = X.reshape(b, nc, chunk, h, p)
    Ac = A.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)         # [b,h,c,l]
    Bc = B.reshape(b, nc, chunk, h, n)
    Cc = C.reshape(b, nc, chunk, h, n)
    A_cumsum = torch.cumsum(Ac, dim=-1)                          # [b,h,c,l]

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(segsum(Ac))                                    # [b,h,c,l,s]
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cc, Bc, L, Xc)

    # 2. per-chunk end states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)      # [b,h,c,l]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, Xc)

    # 3. inter-chunk recurrence
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    pad = F.pad(A_cumsum[..., -1], (1, 0))
    decay_chunk = torch.exp(segsum(pad))                         # [b,h,z,c]
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output contribution
    state_decay_out = torch.exp(A_cumsum)                        # [b,h,c,l]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay_out)
    Y = (Y_diag + Y_off).reshape(b, l, h, p)
    return Y, final_state


def ssd_decode_step(state, x, dA, dBx_B, C):
    """Single-token recurrence. state [b,h,p,n], x [b,h,p], dA [b,h],
    dBx_B [b,h,n] (dt-scaled B), C [b,h,n]."""
    state = state * torch.exp(dA)[..., None, None] \
        + x[..., :, None] * dBx_B[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, C)
    return state, y


# ----------------------------------------------------------------- block
def causal_conv1d(x, w, cache=None):
    """Depthwise causal conv. x [b, l, ch], w [cw, ch].

    Returns (y [b, l, ch], new_cache [b, cw-1, ch])."""
    cw = w.shape[0]
    if cache is None:
        cache = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([cache, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(cw))
    new_cache = xp[:, -(cw - 1):, :] if cw > 1 else cache
    return y, new_cache


def mamba2_init(generator, cfg, dtype, device):
    """Random mixer weights in the reference's layout and scheme;
    ``A_log``, ``D`` and ``dt_bias`` are f32 at any ``dtype``."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = d * s.expand
    nheads = d_in // s.head_dim
    gn = s.num_groups * s.state_dim

    def w(shape, fan_in):
        return dense_init(generator, shape, fan_in, dtype, device)

    def conv(ch):
        return (torch.randn((s.conv_width, ch), generator=generator,
                            device=device) * 0.1).to(dtype)

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=device)

    f32 = torch.float32
    return {
        "w_z": w((d, d_in), d),
        "w_x": w((d, d_in), d),
        "w_B": w((d, gn), d),
        "w_C": w((d, gn), d),
        "w_dt": w((d, nheads), d),
        "conv_x": conv(d_in),
        "conv_x_b": zeros(d_in),
        "conv_bc": conv(2 * gn),
        "conv_bc_b": zeros(2 * gn),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=f32,
                                          device=device)),
        "D": torch.ones((nheads,), dtype=f32, device=device),
        "dt_bias": zeros(nheads, f32),
        "norm": zeros(d_in),
        "out_proj": w((d_in, d), d_in),
    }


def _project(params, cfg, u, conv_x_cache, conv_bc_cache):
    """Shared projection + conv for forward/decode."""
    s = cfg.ssm
    gn = s.num_groups * s.state_dim
    z = u @ params["w_z"]
    x = u @ params["w_x"]
    bc = torch.cat([u @ params["w_B"], u @ params["w_C"]], dim=-1)
    dt_raw = u @ params["w_dt"]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    x, conv_x_cache = causal_conv1d(x, params["conv_x"], conv_x_cache)
    x = F.silu(x + params["conv_x_b"])
    bc, conv_bc_cache = causal_conv1d(bc, params["conv_bc"], conv_bc_cache)
    bc = F.silu(bc + params["conv_bc_b"])
    B, C = bc[..., :gn], bc[..., gn:]
    return z, x, B, C, dt, conv_x_cache, conv_bc_cache


def mamba2_forward(params, cfg, u, *, plain: bool = False):
    """u [b, l, d] -> (y [b, l, d], (conv_x_c, conv_bc_c, ssm_state)),
    from empty caches and a zero state (prefill). The scan runs through
    the ``ssd_scan`` kernel on the card, with B and C per group in their
    own type; ``plain`` (tests and the chip check only) runs
    ``ssd_chunked`` on B and C repeated over the heads in f32, on any
    device, to hold the kernel against it — never a fallback."""
    s = cfg.ssm
    b, l, d = u.shape
    d_in = d * s.expand
    nheads = d_in // s.head_dim
    z, x, B, C, dt, cxc, cbc = _project(params, cfg, u, None, None)
    x = x.reshape(b, l, nheads, s.head_dim)
    Bg = B.reshape(b, l, s.num_groups, s.state_dim)
    Cg = C.reshape(b, l, s.num_groups, s.state_dim)
    A = -torch.exp(params["A_log"])                              # [h]
    chunk = min(s.chunk_size, l)
    pad = (-l) % chunk
    if pad:
        # padded positions have dt = 0: no input, no decay, so the final
        # state is the state after the last real token
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bg = F.pad(Bg, (0, 0, 0, 0, 0, pad))
        Cg = F.pad(Cg, (0, 0, 0, 0, 0, pad))
    X = x.float() * dt[..., None]
    dA = dt * A
    if plain:
        rep = nheads // s.num_groups
        Y, ssm_state = ssd_chunked(
            X, dA, Bg.repeat_interleave(rep, dim=2).float(),
            Cg.repeat_interleave(rep, dim=2).float(), chunk)
    else:
        # B = bc[..., :gn] is a strided view: the kernel reads it copied
        Y, ssm_state = ssd_scan(X.contiguous(), dA.contiguous(),
                                Bg.contiguous(), Cg.contiguous(),
                                chunk=chunk)
    Y = Y[:, :l]
    x = x[:, :l]
    Y = Y + params["D"][:, None] * x.float()
    y = Y.reshape(b, l, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.rms_eps)
    return y @ params["out_proj"], (cxc, cbc, ssm_state)


def mamba2_decode(params, cfg, u, conv_caches, ssm_state):
    """u [b, 1, d] single-token step with recurrent state update."""
    s = cfg.ssm
    b = u.shape[0]
    d_in = cfg.d_model * s.expand
    nheads = d_in // s.head_dim
    cxc, cbc = conv_caches
    z, x, B, C, dt, cxc, cbc = _project(params, cfg, u, cxc, cbc)
    x = x.reshape(b, nheads, s.head_dim).float()
    rep = nheads // s.num_groups
    Bh = B.reshape(b, s.num_groups, s.state_dim).repeat_interleave(rep, dim=1)
    Ch = C.reshape(b, s.num_groups, s.state_dim).repeat_interleave(rep, dim=1)
    dt1 = dt[:, 0]                                               # [b, h]
    A = -torch.exp(params["A_log"])
    ssm_state, y = ssd_decode_step(ssm_state, x * dt1[..., None], dt1 * A,
                                   Bh.float(), Ch.float())
    y = y + params["D"][:, None] * x
    y = y.reshape(b, 1, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.rms_eps)
    return y @ params["out_proj"], (cxc, cbc, ssm_state)


def mamba2_state_shape(cfg, batch: int):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nheads = d_in // s.head_dim
    gn = s.num_groups * s.state_dim
    return ((batch, s.conv_width - 1, d_in),        # conv_x cache
            (batch, s.conv_width - 1, 2 * gn),      # conv_bc cache
            (batch, nheads, s.head_dim, s.state_dim))
