"""The plain reference: LipNet and the TF-family LipNet in plain PyTorch,
float32 with TF32 off, their CTC losses, global-norm clipping and Adam, the
greedy transcript's gap under the reference's log-probs, and the controls
(the same arithmetic with its products' operands rounded to TF32 or fp8).

It imports nothing of the program. The equations follow the papers and the
configuration files: LipNet (arXiv:1611.01599; `model.py:7-97` of the
reference PyTorch code): three Conv3D(SAME) -> ReLU -> MaxPool3D(1,2,2) ->
channel dropout blocks, two BiGRU(256) layers (torch's GRU cell, gate order
r, z, n) each followed by dropout, Linear -> log_softmax, CTC with blank 0
averaged over target lengths. The TF family (the reference's Keras model,
`train.py:495-547`): three Conv3D(3x3x3, SAME) -> ReLU -> MaxPool3D(1,2,2)
blocks, three BiLSTM(256) layers (gate order i, f, g, o) each followed by
dropout, Dense(512)+ReLU twice, Dense(32), log_softmax, CTC with blank last,
label lengths by count_nonzero, the per-sequence NLL averaged over the batch.

Dropout masks: a step draws its masks from a generator reseeded with
seed * 1,000,003 + step, each `rand(shape) >= rate`, in the order the layers
run (the trainers' documented convention), scaled by 1 / (1 - rate).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """cuBLAS and cuDNN in full float32 while the block runs."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark
    matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = False, False, False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = prev


# -- precision of the products ---------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = bits + (0xFFF + ((bits >> 13) & 1))
    return (bits & -8192).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float8 e4m3 with one per-tensor scale (absmax to 448)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


_ROUNDERS = {"tf32": round_tf32, "fp8": round_fp8}


class _Operand(torch.autograd.Function):
    """A product's operand rounded; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, mode):
        return _ROUNDERS[mode](x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Cotangent(torch.autograd.Function):
    """Identity; the cotangent entering the product's backward rounded."""

    @staticmethod
    def forward(ctx, y, mode):
        ctx.mode = mode
        return y

    @staticmethod
    def backward(ctx, g):
        return _ROUNDERS[ctx.mode](g), None


class Precision:
    """Where the reference computes its products: 'float32' (TF32 off), or a
    control's 'tf32' or 'fp8': both operands rounded, the products summed
    in float32, and in the backward the incoming cotangent rounded too."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def _op(self, x):
        return x if self.mode == "float32" else _Operand.apply(x, self.mode)

    def _out(self, y):
        return y if self.mode == "float32" else _Cotangent.apply(y, self.mode)

    def linear(self, x, w, b=None):
        y = self._out(torch.matmul(self._op(x), self._op(w).t()))
        return y if b is None else y + b

    def conv3d(self, x, w, b, padding):
        return self._out(F.conv3d(self._op(x), self._op(w), None, padding=padding)) \
            + b.view(1, -1, 1, 1, 1)


# -- parameters ------------------------------------------------------------------

def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, init bound) of every parameter, in the program's names
    and layouts (torch's: conv (O, I, kt, kh, kw), recurrent gate rows
    stacked, Linear (out, in)). Bounds: 1/sqrt(fan_in) (PyTorch's default)
    and, for the TF family's Dense layers, He-uniform sqrt(6/fan_in); those
    biases start at 0."""
    T, H, W = cfg["frames"], cfg["img_height"], cfg["img_width"]
    specs, cin, h, w = [], 1, H, W
    for i, (ch, k) in enumerate(zip(cfg["conv_channels"], cfg["conv_kernels"])):
        bound = 1.0 / math.sqrt(cin * math.prod(k))
        specs += [(f"conv{i + 1}.weight", (ch, cin, *k), bound),
                  (f"conv{i + 1}.bias", (ch,), bound)]
        cin, h, w = ch, h // 2, w // 2
    dim, hid = cin * h * w, cfg["hidden_dim"]
    tf = cfg["family"] == "tf"
    gates = 4 if tf else 3
    layers = cfg["num_lstm_layers"] if tf else cfg["num_gru_layers"]
    prefix = "lstm" if tf else "gru"
    for i in range(layers):
        bound = 1.0 / math.sqrt(hid)
        for suffix in ("", "_reverse"):
            specs += [(f"{prefix}{i + 1}.weight_ih_l0{suffix}", (gates * hid, dim), bound),
                      (f"{prefix}{i + 1}.weight_hh_l0{suffix}", (gates * hid, hid), bound),
                      (f"{prefix}{i + 1}.bias_ih_l0{suffix}", (gates * hid,), bound),
                      (f"{prefix}{i + 1}.bias_hh_l0{suffix}", (gates * hid,), bound)]
        dim = 2 * hid
    if tf:
        dense = cfg["dense_dim"]
        for name, din, dout in (("dense1", dim, dense), ("dense2", dense, dense),
                                ("head", dense, cfg["outputs"])):
            specs += [(f"{name}.weight", (dout, din), math.sqrt(6.0 / din)),
                      (f"{name}.bias", (dout,), 0.0)]
    else:
        bound = 1.0 / math.sqrt(dim)
        specs += [("fc.weight", (cfg["outputs"], dim), bound),
                  ("fc.bias", (cfg["outputs"],), bound)]
    return specs


def init_params(cfg: dict, seed: int, device) -> Params:
    """Every parameter from `seed`: one uniform draw on the device for all
    of them, cut into leaves and scaled to each leaf's bound; float32, the
    type the parameters are held in."""
    specs = param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, bound in specs:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * bound).view(shape).clone()
        at += n
    return out


# -- forward ---------------------------------------------------------------------

class Masks:
    """The dropout masks of one training step, drawn in the layers' order
    from `generator` reseeded with seed * 1,000,003 + step."""

    def __init__(self, generator: torch.Generator, seed: int, step: int, rate: float):
        self.gen = generator.manual_seed(seed * 1_000_003 + step)
        self.rate = rate

    def draw(self, shape, device) -> torch.Tensor:
        keep = torch.rand(shape, generator=self.gen, device=device) >= self.rate
        return keep.float() * (1.0 / (1.0 - self.rate))


def step_masks(cfg: dict, B: int, generator: torch.Generator, seed: int, step: int,
               device) -> List[torch.Tensor]:
    """All masks of a step's forward over a batch of B, in draw order."""
    m = Masks(generator, seed, step, cfg["dropout_rate"])
    T, hid = cfg["frames"], cfg["hidden_dim"]
    if cfg["family"] == "tf":
        return [m.draw((B, T, 2 * hid), device) for _ in range(cfg["num_lstm_layers"])]
    out = [m.draw((B, ch, 1, 1, 1), device) for ch in cfg["conv_channels"]]
    return out + [m.draw((B, T, 2 * hid), device) for _ in range(cfg["num_gru_layers"])]


def _gru(x, p, pre, reverse, prec):
    w_ih, w_hh = p[f"{pre}.weight_ih_l0{reverse}"], p[f"{pre}.weight_hh_l0{reverse}"]
    b_ih, b_hh = p[f"{pre}.bias_ih_l0{reverse}"], p[f"{pre}.bias_hh_l0{reverse}"]
    B, T, _ = x.shape
    H = w_hh.shape[1]
    gi = prec.linear(x, w_ih, b_ih)
    h = x.new_zeros(B, H)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = prec.linear(h, w_hh, b_hh)
        r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, t, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, t, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1)


def _lstm(x, p, pre, reverse, prec):
    w_ih, w_hh = p[f"{pre}.weight_ih_l0{reverse}"], p[f"{pre}.weight_hh_l0{reverse}"]
    b = p[f"{pre}.bias_ih_l0{reverse}"] + p[f"{pre}.bias_hh_l0{reverse}"]
    B, T, _ = x.shape
    H = w_hh.shape[1]
    gi = prec.linear(x, w_ih, b)
    h, c = x.new_zeros(B, H), x.new_zeros(B, H)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = gi[:, t] + prec.linear(h, w_hh)
        i, f, o = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H]), torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * torch.tanh(g[:, 2 * H:3 * H])
        h = o * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs, dim=1)


def forward(cfg: dict, p: Params, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None,
            prec: Precision = Precision()) -> torch.Tensor:
    """(B, T, H, W, 1) float32 model input -> (B, T, V) float32 log-probs;
    `masks` (the step's, for these rows) applies training dropout."""
    tf = cfg["family"] == "tf"
    masks = list(masks) if masks is not None else None
    x = x.permute(0, 4, 1, 2, 3)
    for i, k in enumerate(cfg["conv_kernels"]):
        pad = tuple((kk - 1) // 2 for kk in k)
        x = F.max_pool3d(F.relu(prec.conv3d(x, p[f"conv{i + 1}.weight"], p[f"conv{i + 1}.bias"],
                                            pad)), (1, 2, 2))
        if masks is not None and not tf:
            x = x * masks.pop(0)
    B, C, T, h, w = x.shape
    x = x.permute(0, 2, 1, 3, 4).reshape(B, T, C * h * w)
    rnn, pre, n = ((_lstm, "lstm", cfg["num_lstm_layers"]) if tf
                   else (_gru, "gru", cfg["num_gru_layers"]))
    for i in range(n):
        x = torch.cat([rnn(x, p, f"{pre}{i + 1}", "", prec),
                       rnn(x, p, f"{pre}{i + 1}", "_reverse", prec)], dim=-1)
        if masks is not None:
            x = x * masks.pop(0)
    if tf:
        x = F.relu(prec.linear(x, p["dense1.weight"], p["dense1.bias"]))
        x = F.relu(prec.linear(x, p["dense2.weight"], p["dense2.bias"]))
        x = prec.linear(x, p["head.weight"], p["head.bias"])
    else:
        x = prec.linear(x, p["fc.weight"], p["fc.bias"])
    return F.log_softmax(x, dim=-1)


def ctc_loss_sum(cfg: dict, log_probs: torch.Tensor, labels: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """The sum over these rows of each row's loss term: LipNet's NLL over
    its target length (zero where infeasible), the TF family's NLL with
    lengths counted as non-zero labels. The batch loss is this over B."""
    B, T, V = log_probs.shape
    lp = log_probs.transpose(0, 1)
    frames = torch.full((B,), T, dtype=torch.long, device=log_probs.device)
    if cfg["family"] == "tf":
        lens = (labels != 0).sum(dim=1)
        return F.ctc_loss(lp, labels.long(), frames, lens, blank=V - 1, reduction="sum")
    nll = F.ctc_loss(lp, labels.long(), frames, lengths.long(), blank=0, reduction="none",
                     zero_infinity=True)
    return (nll / lengths.clamp(min=1).to(nll.dtype)).sum()


# -- training --------------------------------------------------------------------

class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) after global-norm clipping, in
    float32: the update rule the configuration states."""

    def __init__(self, params: Params, lr: float, clip: float):
        self.lr, self.clip, self.t = lr, clip, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def clip_grads(self, grads: Params) -> Params:
        total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        coef = torch.clamp(self.clip / (total + 1e-6), max=1.0)
        return {k: g * coef for k, g in grads.items()}

    def step(self, params: Params, grads: Params) -> Params:
        self.t += 1
        b1, b2 = ADAM_BETAS
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p - self.lr * mhat / (vhat.sqrt() + ADAM_EPS)
        return out


def train_steps(cfg: dict, params: Params, batches: Sequence[dict], seed: int,
                prec: Precision = Precision(), block_rows: int = 32,
                loss_rows: Optional[int] = None) -> dict:
    """Follow len(batches) training steps from `params`. Each batch holds
    'video' (B, T, H, W, 1) float32, 'labels' (B, L) and 'lengths' (B,);
    step s (from 0) draws its dropout masks as the module says. The batch's
    gradient is summed over blocks of `block_rows` rows, so it fits.
    Returns each step's loss, the first step's clipped gradient (what the
    optimizer gets) and the parameters after the last step. `loss_rows`
    takes the loss over a batch's first rows only, the mean over them (a
    fault: the rest of the batch left out)."""
    device = params[next(iter(params))].device
    gen = torch.Generator(device=device)
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(p, cfg["learning_rate"], cfg["grad_clip_norm"])
    losses, first_grad = [], None
    with no_tf32():
        for s, batch in enumerate(batches):
            B = batch["video"].shape[0]
            masks = step_masks(cfg, B, gen, seed, s, device)
            used = loss_rows or B
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            grads = {k: torch.zeros_like(v) for k, v in p.items()}
            total = 0.0
            for lo in range(0, used, block_rows):
                hi = min(used, lo + block_rows)
                lp = forward(cfg, leaves, batch["video"][lo:hi], [m[lo:hi] for m in masks], prec)
                loss = ctc_loss_sum(cfg, lp, batch["labels"][lo:hi], batch["lengths"][lo:hi]) / used
                got = torch.autograd.grad(loss, list(leaves.values()))
                for k, g in zip(leaves, got):
                    grads[k] += g
                total += float(loss.detach())
            losses.append(total)
            grads = opt.clip_grads(grads)
            if first_grad is None:
                first_grad = {k: g.detach().clone() for k, g in grads.items()}
            p = {k: v.detach() for k, v in opt.step(p, grads).items()}
    return {"losses": losses, "first_grad": first_grad, "params": p}


def logprobs(cfg: dict, params: Params, clips: torch.Tensor, prec: Precision = Precision(),
             block_rows: int = 16) -> torch.Tensor:
    """Inference log-probs of (N, T, H, W, 1) model inputs, in blocks."""
    outs = []
    with no_tf32(), torch.no_grad():
        for lo in range(0, clips.shape[0], block_rows):
            outs.append(forward(cfg, params, clips[lo:lo + block_rows], None, prec))
    return torch.cat(outs)


def model_input(cfg: dict, frames: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W) uint8 crops -> (N, T, H, W, 1) float32: /255, then the
    TF family's per-clip standardization (mean, population std)."""
    x = frames.float() * (1.0 / 255.0)
    if cfg.get("standardize_clips"):
        dims = tuple(range(1, x.ndim))
        x = (x - x.mean(dim=dims, keepdim=True)) / \
            x.std(dim=dims, keepdim=True, correction=0).clamp_min(1e-8)
    return x[..., None]


# -- served transcripts ------------------------------------------------------------

def greedy_text(cfg: dict, log_probs: np.ndarray) -> str:
    """Greedy CTC of (T, V) log-probs: argmax, repeats merged, separators
    (blank and the ids that render as nothing) dropped."""
    charset, seps = cfg["charset"], set(cfg["separators"])
    out, prev = [], None
    for v in np.argmax(log_probs, axis=-1):
        v = int(v)
        if v != prev and v not in seps:
            out.append(charset[v - 1])
        prev = v
    return "".join(out)


def transcript_gap(cfg: dict, log_probs: np.ndarray, text: str) -> float:
    """The widest gap, in log-prob, by which a served frame's token lies
    below the reference's best at that frame, over the frame paths that
    greedy decoding turns into `text`, taking the path that makes it least
    (a min-max over CTC's lattice). Infinite when no path gives `text`."""
    charset = cfg["charset"]
    idx = {c: i + 1 for i, c in enumerate(charset)}
    ids = [idx.get(c) for c in text]
    T = log_probs.shape[0]
    if any(i is None for i in ids) or 2 * len(ids) - 1 > T:
        return math.inf
    gap = log_probs.max(axis=-1, keepdims=True) - log_probs  # (T, V)
    sep = gap[:, list(cfg["separators"])].min(axis=-1)  # (T,)
    L = len(ids)
    S = 2 * L + 1
    emit = np.empty((T, S))
    emit[:, 0::2] = sep[:, None]
    if L:
        emit[:, 1::2] = gap[:, ids]
    skip = np.zeros(S, bool)  # label state s may come from s - 2
    for k in range(1, L):
        skip[2 * k + 1] = ids[k] != ids[k - 1]
    cost = np.full(S, math.inf)
    cost[0] = emit[0, 0]
    if L:
        cost[1] = emit[0, 1]
    for t in range(1, T):
        best = cost.copy()
        best[1:] = np.minimum(best[1:], cost[:-1])
        best[2:][skip[2:]] = np.minimum(best[2:][skip[2:]], cost[:-2][skip[2:]])
        cost = np.maximum(best, emit[t])
    return float(min(cost[-1], cost[-2]) if L else cost[-1])
