"""The plain reference of an MoE decoder's served logits (olmoe-1b-7b as
the port computes it, its departures from the published model included:
see the configuration's ``departures``), and its control.

For every checked session it runs one full forward in float32 over the
session's prompt up to its start and the tokens it was fed, with no
cache, no capacity (every token reaches its 8 experts) and no batching
of sessions, and reads the logits at each position the program decoded
there. TF32 is off, so every product is a float32 one. The bfloat16
weights are upcast a layer at a time, so the reference fits beside them.
It imports nothing of the port and takes nothing the port made: the
weights and tokens are the benchmark's (``portbench.lm_inputs``), and the
program's logits are read only to judge them.

Each checked (session, step) gives three numbers: its gap, by which the
logit, in the reference, of the token the program puts first lies below
the reference's best (0 where the program's greedy token is the
reference's); its error, the widest ``|program - reference| / (1 +
|reference|)`` over its vocabulary; and its cache error, the norm of the
difference between the keys and values the step wrote (read back from
the cache it returned; every layer, K and V) and the reference's, over
the norm of the reference's. The numbers compared are over the whole
sample:

* ``logit_gap_mean``: the mean gap;
* ``logit_err_median``: the median error;
* ``kv_err_median``: the median cache error. With random weights the
  attention is diffuse, so a step that drops what it wrote moves the
  logits little; the cache it returns shows it whole.

Not the widest gap: a near-tie in a router's top 8, flipped by the
program's bfloat16 rounding, moves one position's hidden state as much
as float8 rounding does, so the widest gap of sound runs reaches the
control's (``PERF.md``). A position with no finite answer of the right
shape fails on its own.

The control is the same forward with the hidden state rounded to
float8 (e4m3) after the embedding and after every layer, in the
program's place: its logits and the keys and values it computes."""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

#: The numbers compared; a position without an answer reads infinite in
#: each.
COMPARED = ("logit_gap_mean", "logit_err_median", "kv_err_median")


@contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (L, heads, dh) at positions 0..L-1: each half-split pair
    rotated by position times theta ** (-i / (dh / 2))."""
    n, _, dh = x.shape
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(h, w, model):
    """Causal multi-head attention over one session, h (L, D), and the
    keys (after RoPE) and values it attends, (L, kv heads, d_head)."""
    n, d = h.shape
    heads, kvh, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    q = _rope((h @ w["wq"].reshape(d, -1)).reshape(n, heads, dh),
              model["rope_theta"])
    k = _rope((h @ w["wk"].reshape(d, -1)).reshape(n, kvh, dh),
              model["rope_theta"])
    v = (h @ w["wv"].reshape(d, -1)).reshape(n, kvh, dh)
    g = heads // kvh
    kg, vg = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, kg) / math.sqrt(dh)
    future = torch.ones(n, n, dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(s.masked_fill(future, -math.inf), dim=-1)
    o = torch.einsum("hqk,khd->qhd", p, vg).reshape(n, heads * dh)
    return o @ w["wo"], k, v


def _experts(h, w, model):
    """Each token of h (T, D) through its top experts, weighted by the
    softmax over their router logits; no capacity."""
    logits = h @ w["router"]
    top, idx = torch.topk(logits, model["experts_per_token"], dim=-1)
    share = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    for e in range(model["n_experts"]):
        tok, which = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = (F.silu(x @ w["wg"][e]) * (x @ w["wi"][e])) @ w["wo"][e]
        out.index_add_(0, tok, y * share[tok, which, None])
    return out


def _layer(weights: Dict, i: int) -> Dict:
    """Layer ``i``'s weights in float32."""
    b = weights["blocks"]["s0"]
    return {"norm1": b["norm1"][i].float(), "norm2": b["norm2"][i].float(),
            "attn": {k: t[i].float() for k, t in b["attn"].items()},
            "ffn": {k: t[i].float() for k, t in b["ffn"].items()}}


def _to_fp8(x):
    fp8 = torch.float8_e4m3fn
    lim = torch.finfo(fp8).max
    return x.clamp(-lim, lim).to(fp8).float()


def forward(weights: Dict, model: Dict, seqs: Sequence[torch.Tensor],
            want: Sequence[Sequence[int]], fp8: bool = False
            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """For each session ``seqs[b]`` (its tokens), at positions
    ``want[b]``: the float32 logits over the real vocabulary,
    (len(want[b]), V), and the keys and values every layer caches there,
    (2, layers, len(want[b]), kv heads, d_head). ``fp8`` rounds the
    hidden state to float8 after the embedding and after every layer (the
    control)."""
    if model["family"] != "moe" or model["act"] != "silu":
        raise ValueError("olmoe_f32 computes SiLU-gated MoE decoders")
    eps, v = model["norm_eps"], model["vocab_size"]
    keep = _to_fp8 if fp8 else (lambda x: x)
    with torch.no_grad(), _no_tf32():
        table = weights["embed"]["tok"]
        xs = [keep(table[s.long()].float() * math.sqrt(model["d_model"]))
              for s in seqs]
        kvs = [[] for _ in seqs]
        for i in range(model["n_layers"]):
            w = _layer(weights, i)
            for b, x in enumerate(xs):
                o, keys, values = _attention(_rmsnorm(x, w["norm1"], eps),
                                             w["attn"], model)
                xs[b] = x + o
                at = list(want[b])
                kvs[b].append(torch.stack([keys[at], values[at]]))
            h2 = torch.cat([_rmsnorm(x, w["norm2"], eps) for x in xs])
            y = _experts(h2, w["ffn"], model).split(
                [x.shape[0] for x in xs])
            xs = [keep(x + yb) for x, yb in zip(xs, y)]
            del w, h2, y
        final = weights["final_norm"].float()
        head = (table[:v].float() if model["tie_embeddings"]
                else weights["embed"]["head"][:, :v].float().T)
        return ([_rmsnorm(x[list(p)], final, eps) @ head.T
                 for x, p in zip(xs, want)],
                [torch.stack(kv, dim=1) for kv in kvs])


def _sessions(outputs: Sequence, handed: Sequence):
    """The checked units as (logits, positions, written keys and values)
    with the inputs they were judged on, and each session's sequence and
    checked positions."""
    units = [(logits, [int(p) for p in pos.tolist()], kv)
             for logits, pos, kv in zip(outputs[0::3], outputs[1::3],
                                        outputs[2::3])]
    if len(units) != len(handed):
        raise ValueError("each unit gives its logits, its positions and "
                         "the keys and values it wrote")
    inputs = handed[0]
    start = inputs["start"]
    want = [sorted({pos[b] for _, pos, _ in units})
            for b in range(len(start))]
    seqs = []
    for b, p0 in enumerate(start):
        n_fed = want[b][-1] - p0 + 1
        seqs.append(torch.cat([inputs["prompts"][b, :p0],
                               inputs["fed"][b, :n_fed]]))
    return units, inputs, want, seqs


def _by_position(want, logits, kvs) -> Dict:
    """``{(session, position): (logits, keys and values)}`` of a
    forward's output."""
    return {(b, p): (r, kv[:, :, i])
            for b, (ps, rs, kv) in enumerate(zip(want, logits, kvs))
            for i, (p, r) in enumerate(zip(ps, rs))}


def _bad(t, like) -> bool:
    return (t is None or t.shape != like.shape
            or not bool(torch.isfinite(t).all()))


def token_numbers(got: torch.Tensor, ref: torch.Tensor, got_kv=None,
                  ref_kv=None) -> Dict[str, float]:
    """One decoded position's gap and error, the program's logits ``got``
    against the reference's ``ref`` (both over the real vocabulary), and
    where given its cache error, the keys and values it wrote ``got_kv``
    against the reference's ``ref_kv``."""
    if _bad(got, ref) or (ref_kv is not None and _bad(got_kv, ref_kv)):
        return {k: math.inf for k in ("gap", "err", "kv_err", *COMPARED)}
    got = got.float()
    out = {"gap": float(ref.max() - ref[int(got.argmax())]),
           "err": float(((got - ref).abs() / (1 + ref.abs())).max())}
    if ref_kv is not None:
        out["kv_err"] = float((got_kv.float() - ref_kv).norm()
                              / ref_kv.norm())
    return out


def summary(per_token: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The numbers compared over the sample, and beside them, for the
    calibration's record, the widest gap and error and the share of
    positions whose greedy token is not the reference's."""
    def col(k):
        return torch.tensor([t[k] for t in per_token], dtype=torch.float64)

    gaps, errs, kv = col("gap"), col("err"), col("kv_err")
    return {"logit_gap_mean": float(gaps.mean()),
            "logit_err_median": float(errs.median()),
            "kv_err_median": float(kv.median()),
            "logit_gap_max": float(gaps.max()),
            "logit_err_max": float(errs.max()),
            "kv_err_max": float(kv.max()),
            "flip_share": float((gaps > 0).double().mean())}


def readings(outputs: Sequence, handed: Sequence, device
             ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """The numbers over every checked (session, step), and each one's
    own; a unit's outputs are ``[logits, positions, written]``."""
    units, inputs, want, seqs = _sessions(outputs, handed)
    at = _by_position(want, *forward(inputs["weights"], inputs["model"],
                                     seqs, want))
    per_token = []
    for logits, pos, kv in units:
        for b in range(len(inputs["start"])):
            row = (None if logits is None or b >= logits.shape[0]
                   else logits[b])
            row_kv = (None if kv is None or kv.dim() != 5
                      or b >= kv.shape[2] else kv[:, :, b])
            ref, ref_kv = at[(b, pos[b])]
            per_token.append(token_numbers(row, ref, row_kv, ref_kv))
    return summary(per_token), per_token


def control_outputs(outputs: Sequence, handed: Sequence, device) -> List:
    """The control in the program's place: for the same units, the
    logits and the keys and values of the forward with the hidden state
    rounded to float8."""
    units, inputs, want, seqs = _sessions(outputs, handed)
    at = _by_position(want, *forward(inputs["weights"], inputs["model"],
                                     seqs, want, fp8=True))
    out = []
    for _, pos, _ in units:
        got = [at[(b, pos[b])] for b in range(len(inputs["start"]))]
        out += [torch.stack([g[0] for g in got]), torch.tensor(pos),
                torch.stack([g[1] for g in got], dim=2)]
    return out
