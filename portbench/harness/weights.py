"""Weights and inputs drawn from the seed, on the device, in the type they
are served in, laid out as the port's parameter tree
(``reference.layout``): one draw a stacked leaf, so a model is a few dozen
large calls on one generator."""

from __future__ import annotations

import torch

from portbench.reference import model as ref
from portbench.reference.layout import stack_plan, stacks

INPUT_SCALE = 0.02    # std of the frontend frames and source embeddings


class Drawer:
    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.device, self.dtype = device, dtype

    def normal(self, shape, scale: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=self.dtype)
        return t.mul_(scale)


def _norm(model: dict, lead: tuple, device) -> dict:
    if model["norm"] == "nonparam_ln":
        return {}
    ones = torch.ones(lead + (model["d_model"],), dtype=torch.float32,
                      device=device)
    return {"scale": ones, "bias": torch.zeros_like(ones)}


def _attn(model: dict, dr: Drawer, lead: tuple) -> dict:
    d, H, Hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    return {"wq": {"w": dr.normal(lead + (d, H * hd), d ** -0.5)},
            "wk": {"w": dr.normal(lead + (d, Hkv * hd), d ** -0.5)},
            "wv": {"w": dr.normal(lead + (d, Hkv * hd), d ** -0.5)},
            "wo": {"w": dr.normal(lead + (H * hd, d), (H * hd) ** -0.5)}}


def _layer(model: dict, kind: str, dr: Drawer, lead: tuple) -> dict:
    d, f = model["d_model"], model["d_ff"]
    dev = dr.device
    p = {"norm1": _norm(model, lead, dev), "attn": _attn(model, dr, lead)}
    if kind == "attn_cross":
        p["normx"] = _norm(model, lead, dev)
        p["cross"] = _attn(model, dr, lead)
    elif kind != "attn":
        raise ValueError(f"layer kind {kind!r} is not drawn by the harness")
    p["norm2"] = _norm(model, lead, dev)
    p["mlp"] = {"up": {"w": dr.normal(lead + (d, f), d ** -0.5)},
                "down": {"w": dr.normal(lead + (f, d), f ** -0.5)}}
    return p


def _stack(model: dict, pattern, n_layers: int, dr: Drawer) -> dict:
    kinds, n_groups, n_rest = stack_plan(model, pattern, n_layers)
    groups = [_layer(model, k, dr, (n_groups,)) for k in kinds] \
        if n_groups else []
    first_rest = n_groups * len(kinds)
    rest = [_layer(model, kinds[(first_rest + i) % len(kinds)], dr, ())
            for i in range(n_rest)]
    return {"groups": groups, "rest": rest}


def draw_params(model: dict, seed: int, device) -> dict:
    """The whole parameter tree of ``model`` (the configuration's numbers)
    from ``seed``."""
    dr = Drawer(seed, device, getattr(torch, model["dtype"]))
    d, V = model["d_model"], model["vocab_size"]
    p = {"embed": {"embedding": dr.normal((V, d), d ** -0.5)}}
    for name, (pattern, n) in stacks(model).items():
        p[name] = _stack(model, pattern, n, dr)
    p["final_norm"] = _norm(model, (), device)
    p["head"] = {} if model.get("tie_embeddings") else \
        {"w": dr.normal((d, V), d ** -0.5)}
    if model["family"] == "encdec":
        p["enc_norm"] = _norm(model, (), device)
    return p


def calibrate_step(params: dict, model: dict, seed: int, device,
                   n_bits: int, tokens: int, frontend: int = 0,
                   src: int = 0) -> float:
    """The DSLOT activation step: the largest MLP input magnitude of one
    seeded sequence through the float32 reference, over the signed
    ``n_bits`` range.  Both sides are handed the same step."""
    dr = Drawer(seed ^ 0x5EED, device, getattr(torch, model["dtype"]))
    seq = {"tokens": torch.randint(0, model["vocab_size"], (tokens,),
                                   generator=dr.gen, device=device)}
    if frontend:
        seq["frontend"] = dr.normal((frontend, model["d_model"]), INPUT_SCALE)
    if src:
        seq["src"] = dr.normal((src, model["d_model"]), INPUT_SCALE)
    taps: list = []
    ref.forward(params, model, seq, dslot=None, step=None,
                rows=torch.zeros(1, dtype=torch.long, device=device),
                taps=taps)
    return float(torch.stack(taps).max()) / float(2 ** (n_bits - 1) - 1)
