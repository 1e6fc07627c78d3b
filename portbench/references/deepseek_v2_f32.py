"""The plain reference of DeepSeek-V2's served logits and latent cache
(deepseek-v2-lite as the port computes it, its departures from the
published model included: see the configuration's ``departures``), and
its control.

The model: the token table's rows times sqrt(d_model); in each layer
RMSNorm, latent attention (MLA), a residual, RMSNorm, the FFN, a
residual; a final RMSNorm and the untied head. MLA, expanded: ``q = h
W_q``, heads of ``qk_nope + qk_rope`` split into a part without position
and a rotated part; ``[c | k_pe] = h W_kva``, the latent ``c``
RMS-normed with its own scale, ``k_pe`` rotated, one for all heads;
``W_kvb`` maps ``c`` to each head's key part and value; scores
``q_nope·k_nope + q_pe·k_pe`` at YaRN's softmax scale ``(qk_nope +
qk_rope)^-0.5 · mscale(factor, mscale_all_dim)^2``, causal. RoPE at
YaRN's frequencies (DeepSeek-V2's ``yarn_find_correction_range`` and
linear ramp between the plain and the interpolated ones), tables scaled
by ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``, half-split
pairs. The FFN of the leading layers is a dense SwiGLU; of the others a
softmax over all the router's logits, the top ``experts_per_token``
shares kept as they are (``routed_scaling_factor`` is 1), each token
through those experts (no capacity), plus the shared experts' SwiGLU on
every token.

For every checked session it runs one forward in float32 over the
session's prompt up to its start and the tokens it was fed, with no
cache, no capacity and no batching of sessions, and reads the logits at
each position the program decoded there, and the ``c`` and ``k_pe`` each
layer caches there. Attention runs in blocks of queries, so a session of
16k positions fits. TF32 is off, so every product is a float32 one. The
bfloat16 weights are upcast a layer at a time. It imports nothing of the
port and takes nothing the port made: the weights and tokens are the
benchmark's (``portbench.lm_inputs``), in the tree the port takes them,
and the program's outputs are read only to judge them.

Each checked (session, step) gives three numbers: its gap, by which the
logit, in the reference, of the token the program puts first lies below
the reference's best; its error, the widest ``|program - reference| / (1
+ |reference|)`` over its vocabulary; and its cache error, the norm of
the difference between the latents and rope keys the step wrote (read
back from the cache it returned; every layer) and the reference's, over
the norm of the reference's. Compared over the whole sample:
``logit_gap_mean``, ``logit_err_median`` and ``cache_err_median``. A
position with no finite answer of the right shape fails on its own.

The control is the same forward with the hidden state rounded to float8
(e4m3) after the embedding and after every layer, in the program's
place: its logits and the latents it computes."""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

#: The numbers compared; a position without an answer reads infinite in
#: each.
COMPARED = ("logit_gap_mean", "logit_err_median", "cache_err_median")

#: Queries a block of the attention.
QUERY_BLOCK = 1024


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


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


#: DeepSeek-V2's published ``rope_scaling`` beside its factor and
#: original length (config.json): the ramp's ends in rotations and the
#: two mscale values.
BETA_FAST, BETA_SLOW, MSCALE, MSCALE_ALL_DIM = 32.0, 1.0, 0.707, 0.707


def _inv_freq(model, device):
    """DeepSeek-V2's YaRN inverse frequencies of the rotary pairs."""
    dim, base = model["qk_rope_head_dim"], model["rope_theta"]
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim)
    factor = model.get("yarn_factor", 0.0)
    if not factor:
        return extra
    orig = model["yarn_original_len"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(BETA_FAST)), 0)
    high = min(math.ceil(corr(BETA_SLOW)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return extra / factor * (1 - mask) + extra * mask


def _scales(model):
    """(the cos and sin tables' factor, the softmax scale)."""
    factor = model.get("yarn_factor", 0.0)
    scale = (model["qk_nope_head_dim"] + model["qk_rope_head_dim"]) ** -0.5
    if not factor:
        return 1.0, scale
    table = _mscale(factor, MSCALE) / _mscale(factor, MSCALE_ALL_DIM)
    return table, scale * _mscale(factor, MSCALE_ALL_DIM) ** 2


def _rope(x, model):
    """x (L, ..., rope) at positions 0..L-1: half-split pairs rotated."""
    n, half = x.shape[0], x.shape[-1] // 2
    ang = (torch.arange(n, dtype=torch.float32, device=x.device)[:, None]
           * _inv_freq(model, x.device))
    m, _ = _scales(model)
    c, s = torch.cos(ang) * m, torch.sin(ang) * m
    shape = (n,) + (1,) * (x.dim() - 2) + (half,)
    c, s = c.reshape(shape), s.reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(h, w, model):
    """Causal MLA over one session, h (L, D): the output and the latents
    it caches, (L, kv_lora_rank + qk_rope) (``c`` normed, ``k_pe``
    rotated)."""
    n, d = h.shape
    heads, r = model["n_heads"], model["kv_lora_rank"]
    nope, dv = model["qk_nope_head_dim"], model["v_head_dim"]
    q = (h @ w["wq"].reshape(d, -1)).reshape(n, heads, -1)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], model)], dim=-1)
    kva = h @ w["wkv_a"]
    c = _rmsnorm(kva[:, :r], w["kv_norm"], model["norm_eps"])
    k_pe = _rope(kva[:, r:], model)
    kv = (c @ w["wkv_b"].reshape(r, -1)).reshape(n, heads, -1)
    k = torch.cat([kv[..., :nope], k_pe[:, None, :].expand(n, heads, -1)],
                  dim=-1)
    v = kv[..., nope:]
    _, scale = _scales(model)
    out = torch.empty(n, heads, dv, device=h.device)
    for q0 in range(0, n, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, n)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * scale
        future = torch.ones(q1 - q0, q1, dtype=torch.bool,
                            device=h.device).triu(q0 + 1)
        p = torch.softmax(s.masked_fill(future, -math.inf), dim=-1)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", p, v[:q1])
        del s, p
    return (out.reshape(n, heads * dv) @ w["wo"],
            torch.cat([c, k_pe], dim=-1))


def _swiglu(x, w):
    return (F.silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]


def _experts(h, w, model):
    """Each token of h (T, D) through its top experts, weighted by its
    softmax shares over all the router's logits, unrenormalised; no
    capacity; plus the shared experts."""
    probs = torch.softmax(h @ w["router"], dim=-1)
    share, idx = torch.topk(probs, model["experts_per_token"], dim=-1)
    out = torch.zeros_like(h)
    for e in range(model["n_experts"]):
        tok, which = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = (F.silu(x @ w["wg"][e]) * (x @ w["wi"][e])) @ w["wo"][e]
        out.index_add_(0, tok, y * share[tok, which, None])
    if "shared" in w:
        out = out + _swiglu(h, w["shared"])
    return out


def _layers(weights: Dict):
    """Each layer's weights in float32, in order: the leading blocks, then
    the stacked ones."""
    def f32(tree, i=None):
        if isinstance(tree, dict):
            return {k: f32(t, i) for k, t in tree.items()}
        return (tree if i is None else tree[i]).float()

    for block in weights.get("lead", ()):
        yield f32(block)
    stacked = weights["blocks"]["s0"]
    for i in range(stacked["norm1"].shape[0]):
        yield f32(stacked, i)


def _to_fp8(x):
    fp8 = torch.float8_e4m3fn
    lim = torch.finfo(fp8).max
    return x.clamp(-lim, lim).to(fp8).float()


def forward(weights: Dict, model: Dict, seqs: Sequence[torch.Tensor],
            want: Sequence[Sequence[int]], fp8: bool = False
            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """For each session ``seqs[b]`` (its tokens), at positions
    ``want[b]``: the float32 logits over the real vocabulary,
    (len(want[b]), V), and the latents every layer caches there, (layers,
    len(want[b]), kv_lora_rank + qk_rope). ``fp8`` rounds the hidden state
    to float8 after the embedding and after every layer (the control)."""
    if model["act"] != "silu" or not model.get("kv_lora_rank"):
        raise ValueError("deepseek_v2_f32 computes DeepSeek-V2 decoders")
    eps, v = model["norm_eps"], model["vocab_size"]
    keep = _to_fp8 if fp8 else (lambda x: x)
    with torch.no_grad(), _no_tf32():
        table = weights["embed"]["tok"]
        xs = [keep(table[s.long()].float() * math.sqrt(model["d_model"]))
              for s in seqs]
        lats = [[] for _ in seqs]
        for w in _layers(weights):
            for b, x in enumerate(xs):
                o, lat = _attention(_rmsnorm(x, w["norm1"], eps), w["attn"],
                                    model)
                xs[b] = x + o
                lats[b].append(lat[list(want[b])])
                del o, lat
            h2 = torch.cat([_rmsnorm(x, w["norm2"], eps) for x in xs])
            ffn = w["ffn"]
            y = (_experts(h2, ffn, model) if "router" in ffn
                 else _swiglu(h2, ffn))
            xs = [keep(x + yb) for x, yb in
                  zip(xs, y.split([x.shape[0] for x in xs]))]
            del w, h2, y
        final = weights["final_norm"].float()
        head = weights["embed"]["head"][:, :v].float()
        return ([_rmsnorm(x[list(p)], final, eps) @ head
                 for x, p in zip(xs, want)],
                [torch.stack(lat) for lat in lats])


def _sessions(outputs: Sequence, handed: Sequence):
    """The checked units as (logits, positions, written latents) with the
    inputs they were judged on, and each session's sequence and checked
    positions."""
    units = [(logits, [int(p) for p in pos.tolist()], lat)
             for logits, pos, lat in zip(outputs[0::3], outputs[1::3],
                                         outputs[2::3])]
    if len(units) != len(handed):
        raise ValueError("each unit gives its logits, its positions and "
                         "the latents it wrote")
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


def _by_position(want, logits, lats) -> Dict:
    """``{(session, position): (logits, latents)}`` of a forward's
    output."""
    return {(b, p): (r, lat[:, i])
            for b, (ps, rs, lat) in enumerate(zip(want, logits, lats))
            for i, (p, r) in enumerate(zip(ps, rs))}


def _bad(t, like) -> bool:
    return (t is None or t.shape != like.shape
            or not bool(torch.isfinite(t).all()))


def token_numbers(got: torch.Tensor, ref: torch.Tensor, got_lat=None,
                  ref_lat=None) -> Dict[str, float]:
    """One decoded position's gap and error, the program's logits ``got``
    against the reference's ``ref`` (both over the real vocabulary), and
    where given its cache error, the latents it wrote ``got_lat`` against
    the reference's ``ref_lat``."""
    if _bad(got, ref) or (ref_lat is not None and _bad(got_lat, ref_lat)):
        return {k: math.inf for k in ("gap", "err", "cache_err",
                                      *COMPARED)}
    got = got.float()
    out = {"gap": float(ref.max() - ref[int(got.argmax())]),
           "err": float(((got - ref).abs() / (1 + ref.abs())).max())}
    if ref_lat is not None:
        out["cache_err"] = float((got_lat.float() - ref_lat).norm()
                                 / ref_lat.norm())
    return out


def summary(per_token: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The numbers compared over the sample, and beside them, for the
    calibration's record, the widest of each and the share of positions
    whose greedy token is not the reference's."""
    def col(k):
        return torch.tensor([t[k] for t in per_token], dtype=torch.float64)

    gaps, errs, lat = col("gap"), col("err"), col("cache_err")
    return {"logit_gap_mean": float(gaps.mean()),
            "logit_err_median": float(errs.median()),
            "cache_err_median": float(lat.median()),
            "logit_gap_max": float(gaps.max()),
            "logit_err_max": float(errs.max()),
            "cache_err_max": float(lat.max()),
            "flip_share": float((gaps > 0).double().mean())}


def readings(outputs: Sequence, handed: Sequence, device
             ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """The numbers over every checked (session, step), and each one's
    own; a unit's outputs are ``[logits, positions, written]``, the last
    (layers, sessions, kv_lora_rank + qk_rope)."""
    units, inputs, want, seqs = _sessions(outputs, handed)
    at = _by_position(want, *forward(inputs["weights"], inputs["model"],
                                     seqs, want))
    per_token = []
    for logits, pos, lat in units:
        for b in range(len(inputs["start"])):
            row = (None if logits is None or b >= logits.shape[0]
                   else logits[b])
            row_lat = (None if lat is None or lat.dim() != 3
                       or b >= lat.shape[1] else lat[:, b])
            ref, ref_lat = at[(b, pos[b])]
            per_token.append(token_numbers(row, ref, row_lat, ref_lat))
    return summary(per_token), per_token


def control_outputs(outputs: Sequence, handed: Sequence, device) -> List:
    """The control in the program's place: for the same units, the
    logits and the latents of the forward with the hidden state rounded
    to float8."""
    units, inputs, want, seqs = _sessions(outputs, handed)
    at = _by_position(want, *forward(inputs["weights"], inputs["model"],
                                     seqs, want, fp8=True))
    out = []
    for _, pos, _ in units:
        got = [at[(b, pos[b])] for b in range(len(inputs["start"]))]
        out += [torch.stack([g[0] for g in got]), torch.tensor(pos),
                torch.stack([g[1] for g in got], dim=1)]
    return out
