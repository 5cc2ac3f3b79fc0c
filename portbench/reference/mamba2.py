"""Plain reference of the Mamba2 language model and its next-token loss (a
frozen copy written from arXiv:2405.21060, plain PyTorch f32).

Per layer, pre-norm residual: x + Mamba2(RMSNorm(x)). The block projects
z, x, B, C and dt separately, runs a depthwise causal convolution (width
``ssm_conv``) and SiLU over x, B and C, takes dt = softplus(x W_dt +
dt_bias) and A = -exp(A_log), and runs the SSD scan in chunks of
``ssm_chunk``: within a chunk the quadratic form C_t B_s exp(cum_t - cum_s)
dt_s x_s over s <= t, across chunks the carried state. Then y + D x, the
gated RMSNorm of y * SiLU(z), and the out projection. RMSNorm weights are
offsets from 1. The logits are the final RMSNorm's output times the tied
embedding; the vocabulary's padding columns are masked out; the loss is the
mean cross-entropy of each position's next token, the last position left
out.

Each layer is recomputed in the backward (``torch.utils.checkpoint``), so a
full-size step fits beside the round's state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.layout import Leaf, normal, place

EPS = 1e-5
VOCAB_PAD = 16  # the embedding's rows are the vocabulary padded to a multiple of this


def padded_vocab(sizes: dict) -> int:
    return -(-sizes["vocab_size"] // VOCAB_PAD) * VOCAB_PAD


def dims(sizes: dict) -> tuple[int, int, int, int]:
    """(d_inner, heads, state, head width)."""
    di = sizes["ssm_expand"] * sizes["d_model"]
    return di, di // sizes["ssm_headdim"], sizes["ssm_state"], sizes["ssm_headdim"]


def leaves(sizes: dict) -> list[Leaf]:
    """The row's leaves: a tied embedding, a final RMSNorm, and per layer a
    pre-norm and the SSD block's separate projections (z, x, B, C, dt, out),
    depthwise causal convolutions of x, B and C, A_log, D, dt_bias and the
    gated RMSNorm."""
    d, L, k = sizes["d_model"], sizes["n_layers"], sizes["ssm_conv"]
    di, h, n, _ = dims(sizes)
    s = lambda name, shape, init: Leaf(f"layers/{name}", (L,) + shape, init,
                                       0.02 if init == "small" else 0.0, True)
    w = lambda name, fan_in, cols: normal(f"layers/ssm/{name}", (L, fan_in, cols), fan_in, True)
    return place([
        Leaf("embed", (padded_vocab(sizes), d), "small", 0.02, False),
        Leaf("final_norm", (d,), "zeros", 0.0, False),
        s("norm1", (d,), "zeros"),
        s("ssm/A_log", (h,), "zeros"),
        s("ssm/D", (h,), "ones"),
        s("ssm/conv_B", (k, n), "small"),
        s("ssm/conv_C", (k, n), "small"),
        s("ssm/conv_x", (k, di), "small"),
        s("ssm/dt_bias", (h,), "zeros"),
        s("ssm/gate_norm", (di,), "zeros"),
        w("wB", d, n), w("wC", d, n), w("wdt", d, h), w("wo", di, d), w("wx", d, di),
        w("wz", d, di),
    ])


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * ((1.0 + w) * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS))


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (k, C): y_t = sum_i w_i x_{t - k + 1 + i}."""
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(k))


def ssd(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        Q: int) -> torch.Tensor:
    """xdt (b, s, h, p), dA (b, s, h), Bm, Cm (b, s, n), s % Q == 0 -> y."""
    b, s, h, p = xdt.shape
    nc = s // Q
    x = xdt.reshape(b, nc, Q, h, p)
    B = Bm.reshape(b, nc, Q, -1)
    C = Cm.reshape(b, nc, Q, -1)
    cum = torch.cumsum(dA.reshape(b, nc, Q, h), dim=2)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=xdt.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, t, s, h)
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    y = torch.einsum("bctn,bcsn,bctsh,bcshp->bcthp", C, B, decay, x)
    # the state each chunk leaves, and the state entering each chunk
    to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, Q, h)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", B, to_end, x)
    state = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cum[:, c, -1, :])[:, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # (b, nc, h, p, n)
    y = y + torch.einsum("bctn,bchpn,bcth->bcthp", C, entering, torch.exp(cum))
    return y.reshape(b, s, h, p)


def block(p: dict, x: torch.Tensor, sizes: dict) -> torch.Tensor:
    di, h, n, pd = dims(sizes)
    z = x @ p["wz"]
    xin = F.silu(causal_conv(x @ p["wx"], p["conv_x"]))
    Bm = F.silu(causal_conv(x @ p["wB"], p["conv_B"]))
    Cm = F.silu(causal_conv(x @ p["wC"], p["conv_C"]))
    dt = F.softplus(x @ p["wdt"] + p["dt_bias"])
    dA = dt * -torch.exp(p["A_log"])
    xh = xin.reshape(*xin.shape[:2], h, pd)
    y = ssd(xh * dt[..., None], dA, Bm, Cm, sizes["ssm_chunk"])
    y = (y + xh * p["D"][:, None]).reshape(*x.shape[:2], di)
    return rms_norm(y * F.silu(z), p["gate_norm"]) @ p["wo"]


def loss(p: dict, batch: dict, sizes: dict) -> torch.Tensor:
    """p: {"embed", "final_norm", "layers/norm1", "layers/ssm/<name>"}
    (stacked over layers); batch: {"tokens" (B, S)} -> the mean next-token
    cross-entropy."""
    tokens = batch["tokens"].long()
    x = p["embed"][tokens]
    names = [k for k in p if k.startswith("layers/ssm/")]

    def layer(x, norm, *ws):
        q = {k[len("layers/ssm/"):]: w for k, w in zip(names, ws)}
        return x + block(q, rms_norm(x, norm), sizes)

    for i in range(sizes["n_layers"]):
        args = (x, p["layers/norm1"][i], *(p[k][i] for k in names))
        x = checkpoint(layer, *args, use_reentrant=False) if torch.is_grad_enabled() else layer(*args)
    x = rms_norm(x, p["final_norm"])
    V = sizes["vocab_size"]
    labels = tokens[:, 1:]
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    step = 512  # positions a chunk of logits
    for lo in range(0, labels.shape[1], step):
        hc = x[:, lo:lo + step][:, : labels.shape[1] - lo]
        tot = tot + checkpoint(_ce_sum, hc, p["embed"], labels[:, lo:lo + hc.shape[1]], V,
                               use_reentrant=False)
    return tot / labels.numel()


def _ce_sum(h: torch.Tensor, embed: torch.Tensor, labels: torch.Tensor, V: int) -> torch.Tensor:
    logits = (h @ embed.t())[..., :V]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1), reduction="sum")
