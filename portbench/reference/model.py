"""Plain reference of the served models: float32 PyTorch with TF32 off.

It follows the port's model definition (the configuration file's
``assumed`` lists where that departs from the published model) and computes
every product in float32 from the weights and inputs the benchmark drew:
the embedding, the norms, rotary attention (self, cross over the encoder
output, causal over the whole sequence), the MLP and the head.  The DSLOT
up-projection is the paper's arithmetic written out: activations quantized
against the calibrated step to signed ``n_bits`` integers, each row's
integer truncated to its granted digit planes (the most significant
``planes`` bits of its magnitude, sign kept), the product with the weights
and ReLU.  Early termination only skips tiles that ReLU zeroes, so the
reference computes every tile.

``precision="fp8"`` is the control: every product's two operands rounded to
float8 e4m3 with one scale per tensor (its largest magnitude mapped to
448), the step a lower-precision port would take.  Nothing here imports the
program.
"""

from __future__ import annotations

import contextlib

import torch

from .layout import layer_params, stacks

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 or reduced-precision reductions."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale, in f32."""
    amax = t.abs().max().clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    x, w = x.to(torch.float32), w.to(torch.float32)
    if precision == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return x @ w


def norm(x: torch.Tensor, kind: str, p: dict, eps: float = 1e-6
         ) -> torch.Tensor:
    """LayerNorm: OLMo's non-parametric one, or with scale and bias."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        out = out * p["scale"].float() + p["bias"].float()
    return out


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the halves form: x (S, H, D), pos (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = (pos.to(torch.float32)[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, h: torch.Tensor, model: dict, precision: str, *,
              kv: torch.Tensor | None = None, causal: bool) -> torch.Tensor:
    """Multi-head attention of one sequence: h (S, d); ``kv`` the encoder
    output for cross-attention (keys at their own positions 0..)."""
    S = h.shape[0]
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    if Hkv != H:
        raise ValueError("the reference attends with one kv head a head")
    hd = model.get("head_dim") or model["d_model"] // H
    src = h if kv is None else kv
    T = src.shape[0]
    q = matmul(h, p["wq"]["w"], precision).reshape(S, H, hd)
    k = matmul(src, p["wk"]["w"], precision).reshape(T, Hkv, hd)
    v = matmul(src, p["wv"]["w"], precision).reshape(T, Hkv, hd)
    theta = float(model.get("rope_theta", 10000.0))
    q = rope(q, torch.arange(S, device=h.device), theta)
    k = rope(k, torch.arange(T, device=h.device), theta)
    q = q * hd ** -0.5
    out = torch.empty((S, H, hd), dtype=torch.float32, device=h.device)
    rows = max(1, (1 << 26) // max(1, H * T))     # score blocks of <= 256 MB
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        if precision == "fp8":
            s = torch.einsum("qhd,khd->hqk", fp8_round(q[r0:r1]), fp8_round(k))
        else:
            s = torch.einsum("qhd,khd->hqk", q[r0:r1], k)
        if causal:
            qi = torch.arange(r0, r1, device=h.device)[:, None]
            kj = torch.arange(T, device=h.device)[None]
            s = s.masked_fill((kj > qi)[None], float("-inf"))
        a = torch.softmax(s, dim=-1)
        if precision == "fp8":
            a, vv = fp8_round(a), fp8_round(v)
        else:
            vv = v
        out[r0:r1] = torch.einsum("hqk,khd->qhd", a, vv)
    return matmul(out.reshape(S, H * hd), p["wo"]["w"], precision)


def dslot_up(h: torch.Tensor, w: torch.Tensor, dslot: dict, step: float,
             planes: torch.Tensor, precision: str) -> torch.Tensor:
    """ReLU(q_D @ W) * step: q the signed ``n_bits`` quantization of ``h``
    against the calibrated ``step``, truncated row by row to ``planes``
    digit planes (``planes`` (S,) int)."""
    n_bits = int(dslot["n_bits"])
    qmax = float(2 ** (n_bits - 1) - 1)
    q = torch.clamp(torch.round(h / step), -qmax, qmax).to(torch.int64)
    shift = (n_bits - planes.to(torch.int64).clamp(1, n_bits))[:, None]
    mag = (q.abs() >> shift) << shift
    qd = (torch.sign(q) * mag).to(torch.float32)
    return torch.clamp_min(matmul(qd, w, precision), 0.0) * step


def mlp(p: dict, h: torch.Tensor, model: dict, dslot: dict | None,
        step: float | None, planes, precision: str) -> torch.Tensor:
    """The ReLU MLP: the DSLOT up-projection, or with ``dslot`` None the
    float one (calibration)."""
    if model["act"] != "relu" or model.get("glu", True):
        raise ValueError("the reference serves ReLU MLPs without a gate")
    if dslot is None:
        u = torch.clamp_min(matmul(h, p["up"]["w"], precision), 0.0)
    else:
        u = dslot_up(h, p["up"]["w"], dslot, step, planes, precision)
    return matmul(u, p["down"]["w"], precision)


def _stack(params: dict, model: dict, name: str, x: torch.Tensor, *,
           causal: bool, enc: torch.Tensor | None, dslot, step, planes,
           precision: str, taps: list | None) -> torch.Tensor:
    pattern, n_layers = stacks(model)[name]
    kind_norm = model["norm"]
    for i in range(n_layers):
        kind, p = layer_params(params[name], model, pattern, n_layers, i)
        x = x + attention(p["attn"], norm(x, kind_norm, p["norm1"]), model,
                          precision, causal=causal)
        if kind == "attn_cross":
            x = x + attention(p["cross"], norm(x, kind_norm, p["normx"]),
                              model, precision, kv=enc, causal=False)
        h = norm(x, kind_norm, p["norm2"])
        if taps is not None:
            taps.append(h.abs().max())
        x = x + mlp(p["mlp"], h, model, dslot, step, planes, precision)
    return x


def forward(params: dict, model: dict, seq: dict, *, dslot: dict | None,
            step: float | None, planes: int = 8,
            precision: str = "f32", rows: torch.Tensor | None = None,
            taps: list | None = None) -> torch.Tensor:
    """Logits (f32) of one sequence at the token positions ``rows`` (all
    token positions when None).

    ``seq``: ``tokens`` (S,) int; for an audio frontend ``frontend`` (F, d)
    frames before the tokens; for an encoder-decoder ``src`` (E, d).
    ``planes``: the request's DSLOT digit planes, every row of it.
    ``taps`` collects each MLP input's largest magnitude (calibration)."""
    with exact_f32(), torch.no_grad():
        tokens = seq["tokens"]
        dev = tokens.device
        x = params["embed"]["embedding"][tokens].float()
        F = 0
        if model.get("frontend") and "frontend" in seq:
            F = seq["frontend"].shape[0]
            x = torch.cat([seq["frontend"].float(), x], dim=0)
        enc = None
        if model["family"] == "encdec":
            src = seq["src"].float()
            enc = _stack(params, model, "encoder", src, causal=False,
                         enc=None, dslot=dslot, step=step,
                         planes=torch.full((src.shape[0],), planes,
                                           device=dev),
                         precision=precision, taps=taps)
            enc = norm(enc, model["norm"], params["enc_norm"])
        x = _stack(params, model, "decoder", x, causal=True, enc=enc,
                   dslot=dslot, step=step,
                   planes=torch.full((x.shape[0],), planes, device=dev),
                   precision=precision, taps=taps)
        x = norm(x[F:], model["norm"], params["final_norm"])
        if rows is not None:
            x = x[rows]
        if model.get("tie_embeddings"):
            w = params["embed"]["embedding"].t()
        else:
            w = params["head"]["w"]
        return matmul(x, w, precision)
