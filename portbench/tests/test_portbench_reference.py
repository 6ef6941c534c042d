"""The harness's weights in the port's layout, and the plain reference held
against the port at CPU sizes, both ways round: the port's float32 logits
equal the reference's, and the float8 control is refused by the cell's
limit."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from portbench.harness import weights
from portbench.reference import model as ref

from .conftest import ROOT, REDUCED


def _config(name: str, **model) -> dict:
    c = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                   .read_text())
    c["model"].update(REDUCED, **model)
    return c


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("name,layers", [("opt-1.3b", 4),
                                         ("opt-1.3b", 5),
                                         ("seamless-m4t-medium", 2)])
def test_drawn_weights_have_the_ports_layout(name, layers):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model_zoo import build_model
    c = _config(name, n_layers=layers, dtype="bfloat16")
    if c["model"]["family"] == "encdec":
        c["model"]["encoder_layers"] = 3
    mine = weights.draw_params(c["model"], 7, torch.device("cpu"))
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in c["model"].items()})
    port = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert _shapes(mine) == _shapes(port)


def test_same_seed_same_weights_and_another_seed_others():
    c = _config("opt-1.3b", n_layers=4, dtype="bfloat16")["model"]
    a = weights.draw_params(c, 2 ** 31 + 5, torch.device("cpu"))
    b = weights.draw_params(c, 2 ** 31 + 5, torch.device("cpu"))
    d = weights.draw_params(c, 6, torch.device("cpu"))
    assert torch.equal(a["embed"]["embedding"], b["embed"]["embedding"])
    assert not torch.equal(a["embed"]["embedding"], d["embed"]["embedding"])


def _port_logits(c: dict, params, step: float, seq: dict):
    """The port's own full forward (float32 config) at the token rows."""
    from repro_torch.configs.base import DslotConfig, ModelConfig
    from repro_torch.models.model_zoo import build_model
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in c["model"].items()},
                      dslot=DslotConfig(enabled=True, act_scale=step,
                                        **dict(c["dslot"], block_m=16,
                                               block_n=32)))
    model = build_model(cfg)
    prepared = model.prepare_dslot(params)
    batch = {"tokens": seq["tokens"][None]}
    if "frontend" in seq:
        batch["frontend"] = seq["frontend"][None]
    if "src" in seq:
        batch["src_embeds"] = seq["src"][None]
    with torch.no_grad():
        logits, _, _ = model.forward(prepared, batch, mode="train")
    return logits[0].float()


@pytest.mark.parametrize("name", ["opt-1.3b", "seamless-m4t-medium"])
def test_reference_equals_the_port_in_float32(name):
    c = _config(name, dtype="float32")
    m = c["model"]
    if m["family"] == "encdec":
        m.update(n_layers=2, encoder_layers=2, frontend_len=8)
    else:
        m["n_layers"] = 4
    dev = torch.device("cpu")
    params = weights.draw_params(m, 11, dev)
    g = torch.Generator().manual_seed(3)
    seq = {"tokens": torch.randint(0, m["vocab_size"], (24,), generator=g)}
    if m["family"] == "encdec":
        seq["frontend"] = torch.randn((8, m["d_model"]), generator=g) * 0.02
        seq["src"] = torch.randn((4, m["d_model"]), generator=g) * 0.02
    step = weights.calibrate_step(params, m, 11, dev, 8, tokens=24,
                                  frontend=8 if "frontend" in seq else 0,
                                  src=4 if "src" in seq else 0)
    want = ref.forward(params, m, seq, dslot=c["dslot"], step=step)
    got = _port_logits(c, params, step, seq)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_plane_truncation_keeps_the_top_digits():
    h = torch.tensor([[0.5, -1.0, 1.27, -0.03]])
    w = torch.eye(4)
    dslot = {"n_bits": 8}
    full = ref.dslot_up(h, w, dslot, 0.01, torch.tensor([8]), "f32")
    assert torch.allclose(full, torch.tensor([[0.5, 0.0, 1.27, 0.0]]))
    # 50 = 0b0110010 at 4 planes of 8 bits keeps 0b0110000 = 48;
    # 127 = 0b1111111 keeps 0b1110000 = 112
    four = ref.dslot_up(h, w, dslot, 0.01, torch.tensor([4]), "f32")
    assert torch.allclose(four, torch.tensor([[0.48, 0.0, 1.12, 0.0]]))


@pytest.mark.parametrize("seed", [13, 14, 15])
def test_float8_control_is_refused_by_the_cells_limit(seed):
    """The control at a CPU size (d_model 256, 4 layers, vocab 8192; 8
    prompts of 48 tokens, 48 served each): the bfloat16 port's greedy
    tokens keep inside the opt limit, and the tokens the reference
    computed in float8 puts first do not."""
    from repro_torch.configs.base import DslotConfig, ModelConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import generate

    from portbench.harness import check
    c = _config("opt-1.3b", dtype="bfloat16", n_layers=4, d_model=256,
                n_heads=4, n_kv_heads=4, d_ff=1024, vocab_size=8192)
    m = c["model"]
    dev = torch.device("cpu")
    params = weights.draw_params(m, seed, dev)
    step = weights.calibrate_step(params, m, seed, dev, 8, tokens=64)
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in m.items()},
                      dslot=DslotConfig(enabled=True, act_scale=step,
                                        **dict(c["dslot"], block_m=16,
                                               block_n=128)))
    model = build_model(cfg)
    prompts = torch.randint(0, m["vocab_size"], (8, 48),
                            generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        res = generate(model, model.prepare_dslot(params),
                       {"tokens": prompts}, 48)
    samples = [dict(prompt=prompts[i].numpy(),
                    served=res.tokens[i].tolist(), planes=8)
               for i in range(8)]
    got = check.gaps(params, m, c["dslot"], step, samples, dev,
                     control=True)
    limit = c["check"]["logit_gap_limit"]
    assert got["logit_gap"] < limit < got["control_gap"]
