"""Port parity: the model-axis split of the sharded train step, module by
module, on a ``gloo`` world of 2 ranks over a (1, 2) mesh on the CPU.

Megatron's "f" (``copy_to_model``) and "g" (``reduce_from_model``), the
detached max (``all_reduce_max``), the recurrent mixers' sum whose
backward sums (``sum_over_model``) and gather whose backward is a
reduce-scatter (``gather_over_model``), the vocab-parallel cross-entropy
of ``model_zoo.loss_fn``, and the split attention (the "kv" and "group"
schemes, a group whose q heads read their kv heads unevenly, cross and
sliding-window attention), MLP (f32 and bf16), expert FFN, embedding and
head (tied, untied, and a vocab that does not divide), the Mamba2 mixer
(by SSD head, f32 and bf16) and the RG-LRU (by width) are run on each
rank's slices inside ``pspec.model_shard`` (``torch_split_ranks``, which
imports no JAX) and held against the port's unsplit functions at the full
width in one process.  The mixers are held over 4 ranks as well, in
``test_torch_sharded_train.py``'s world of 4.  Those are held against the reference by
``test_torch_models.py``, ``test_torch_zoo.py`` and
``test_torch_train_lm.py``; the split train step as a whole is held against
the reference by ``test_torch_sharded_train.py``.  The "repeat" scheme
needs a model axis of 4 and is covered there.

Tolerances: the split sums the same products in another order, so f32
outputs and gradients agree within ``REL`` of the largest |value|; bf16
ones within ``BF16_REL`` (one or two bf16 roundings of such sums).  What
involves no reordered sum is exact: "f"'s forward, "g" of two partials
against their f32 sum rounded once, the max, the mixers' sum of two
partials and their gather, and an embedding lookup.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

import torch_split_ranks as ranks
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import run_world
from repro_torch.models.attention import attention_forward, init_attention
from repro_torch.models.layers import (embed_tokens, init_embedding,
                                       init_lm_head, lm_logits)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.model_zoo import loss_fn
from repro_torch.models.moe import expert_ffn, init_moe
from repro_torch.models.rglru import apply_rglru, init_rglru
from repro_torch.models.ssm import apply_ssm, init_ssm
from repro_torch.train.sharding import PART, SPLIT, WHOLE
from repro_torch.tree import flatten_with_path, leaves, tree_map

REL = 1e-5
BF16_REL = 2.0 ** -6


def cfg_of(arch, **over):
    return dataclasses.replace(ARCHS[arch].reduced(), **over)


def rng(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def np_tree(tree):
    return tree_map(lambda a: a.detach().float().numpy().copy(), tree)


SSM_READS = {"w_in": PART, "conv_w": PART, "conv_b": PART, "A_log": PART,
             "D_skip": PART, "dt_bias": PART, "norm_scale": SPLIT,
             "w_out": SPLIT}
# name -> (kind, config, what the split reads of each leaf over model 2:
# by the leaf's parent for attention, the mixer leaf's name for "ssm")
MODULES = {
    "attn-kv": ("attn", cfg_of("olmo-1b"), {"wq": SPLIT, "wk": SPLIT,
                                            "wv": SPLIT, "wo": SPLIT}),
    "attn-group": ("attn", cfg_of("qwen2.5-3b", n_kv_heads=1),
                   {"wq": SPLIT, "wk": PART, "wv": PART, "wo": SPLIT}),
    "attn-group-uneven": ("attn", cfg_of("qwen2.5-3b", n_heads=6,
                                         n_kv_heads=3),
                          {"wq": SPLIT, "wk": PART, "wv": PART,
                           "wo": SPLIT}),
    "attn-cross": ("attn", cfg_of("seamless-m4t-medium"),
                   {"wq": SPLIT, "wk": SPLIT, "wv": SPLIT, "wo": SPLIT}),
    "attn-swa": ("attn", cfg_of("h2o-danube-3-4b"),
                 {"wq": SPLIT, "wk": SPLIT, "wv": SPLIT, "wo": SPLIT}),
    "mlp-f32": ("mlp", cfg_of("olmo-1b"), {"mlp": SPLIT}),
    "mlp-bf16": ("mlp", cfg_of("olmo-1b", dtype="bfloat16"),
                 {"mlp": SPLIT}),
    "mlp-gelu": ("mlp", cfg_of("recurrentgemma-2b"), {"mlp": SPLIT}),
    "moe": ("moe", cfg_of("granite-moe-1b-a400m"), {"moe": SPLIT}),
    "embed-tied": ("embed", cfg_of("olmo-1b"), {"embed": SPLIT}),
    "embed-untied": ("embed", cfg_of("qwen2.5-3b"),
                     {"embed": SPLIT, "head": SPLIT}),
    "embed-v251": ("embed", cfg_of("olmo-1b", vocab_size=251),
                   {"embed": WHOLE}),
    # 8 SSD heads of 16 channels, 16 states; a 64-wide RG-LRU
    "ssm": ("ssm", cfg_of("mamba2-780m"), SSM_READS),
    "ssm-bf16": ("ssm", cfg_of("mamba2-780m", dtype="bfloat16"), SSM_READS),
    "rglru": ("rglru", cfg_of("recurrentgemma-2b"), {"mixer": SPLIT}),
}
B, S = 2, 40
MIXERS = {"ssm": (init_ssm, apply_ssm), "rglru": (init_rglru, apply_rglru)}
MIXER_VECTORS = ("conv_b", "A_log", "D_skip", "dt_bias", "norm_scale",
                 "ba", "bx", "lam")


def module_inputs(i, kind, cfg):
    """(params, x, kv_x, cotangent) for one case, from seeds."""
    gen = torch.Generator().manual_seed(i)
    D = cfg.d_model
    if kind == "attn":
        p = {"attn": init_attention(cfg, gen, "cpu")}
        for d in p["attn"].values():                 # nonzero q/k/v biases
            if "b" in d:
                d["b"] = torch.as_tensor(rng(50 + i, d["b"].shape, 0.1)
                                         ).to(d["b"].dtype)
        x, ct = rng(i, (B, S, D)), rng(100 + i, (B, S, D))
        kv = rng(200 + i, (B, 24, D)) if cfg.cross_attention else None
        return p, x, kv, ct
    if kind == "mlp":
        return ({"mlp": init_mlp(cfg, gen, "cpu")}, rng(i, (B, S, D)), None,
                rng(100 + i, (B, S, D)))
    if kind in MIXERS:
        p = MIXERS[kind][0](cfg, gen, "cpu")
        for k in MIXER_VECTORS:                      # per-channel leaves
            if k in p:
                v = rng(50 + i, p[k].shape, 0.3)
                p[k] = torch.as_tensor(1 + v if k == "norm_scale" else v
                                       ).to(p[k].dtype)
        return ({"mixer": p}, rng(i, (B, S, D)), None,
                rng(100 + i, (B, S, D)))
    if kind == "moe":
        p = init_moe(cfg, gen, "cpu")
        p.pop("router")
        shape = (1, cfg.n_experts, 8, D)
        return {"moe": p}, rng(i, shape), None, rng(100 + i, shape)
    p = {"embed": init_embedding(cfg, gen, "cpu"),
         "head": init_lm_head(cfg, gen, "cpu")}
    tok = np.random.default_rng(i).integers(0, cfg.vocab_size, (B, 8))
    return p, tok, None, rng(100 + i, (B, 8, cfg.vocab_size))


def run_whole(kind, cfg, p, x, kv, ct):
    """The unsplit function at the full width in this process: output,
    input gradient and parameter gradients (numpy)."""
    dt = getattr(torch, cfg.dtype)
    p = tree_map(lambda a: a.to(dt).clone().requires_grad_(), p)
    xt = torch.as_tensor(x)
    if xt.is_floating_point():
        xt = xt.to(dt).requires_grad_()
    if kind == "attn":
        pos = torch.arange(S, dtype=torch.int32)
        kvt = None if kv is None else torch.as_tensor(kv).to(dt)
        y, _ = attention_forward(p["attn"], xt, cfg, positions=pos, kv_x=kvt,
                                 causal=kvt is None)
    elif kind == "mlp":
        y = apply_mlp(p["mlp"], xt, cfg)
    elif kind == "moe":
        y = expert_ffn(p["moe"], xt, cfg)
    elif kind in MIXERS:
        y, _ = MIXERS[kind][1](p["mixer"], xt, cfg)
    else:
        y = lm_logits(p["head"], p["embed"], embed_tokens(p["embed"], xt,
                                                          cfg), cfg)
    flat = leaves(p)
    wrt = flat + ([xt] if xt.requires_grad else [])
    gs = torch.autograd.grad((y.float() * torch.as_tensor(ct)).sum(), wrt,
                             allow_unused=True)
    gs = [torch.zeros_like(a) if g is None else g for a, g in zip(wrt, gs)]
    it = iter(gs[:len(flat)])
    return (y.detach().float().numpy(),
            gs[-1].float().numpy() if xt.requires_grad else None,
            np_tree(tree_map(lambda _: next(it), p)))


OPS = {"f32": "float32", "bf16": "bfloat16"}


def ops_inputs(i, dtype):
    return dict(x=rng(i, (3, 16)), w=rng(i + 1, (16, 8)),
                ct=rng(i + 2, (3, 8)), h=rng(i + 3, (3, 32)),
                wd=rng(i + 4, (32, 16), 0.2), ct2=rng(i + 5, (3, 16)),
                m=rng(i + 6, (2, 5)),
                s=rng(i + 7, (2, 3, 1)), sct=rng(i + 8, (2, 3, 1)),
                u=rng(i + 9, (3, 16)), uw=rng(i + 10, (2, 16, 4)),
                uct=rng(i + 11, (2, 3, 4)), dtype=dtype)


def ce_inputs(i, dtype):
    cfg = cfg_of("olmo-1b", vocab_size=64)
    labels = np.random.default_rng(i).integers(0, 64, (2, 8))
    labels[0, :3] = -1                                   # masked positions
    labels[1, -1] = 63                                   # the last id
    return dict(cfg=cfg, logits=rng(i, (2, 8, 64), 3.0), labels=labels,
                dtype=dtype)


class World:
    def __init__(self):
        torch.set_num_threads(1)
        self.ops = {k: ops_inputs(10 * j, d) for j, (k, d) in
                    enumerate(OPS.items())}
        self.ce = {k: ce_inputs(20 + j, d) for j, (k, d) in
                   enumerate(OPS.items())}
        self.modules, self.whole = {}, {}
        for i, (name, (kind, cfg, _)) in enumerate(MODULES.items()):
            p, x, kv, ct = module_inputs(i, kind, cfg)
            self.modules[name] = dict(kind=kind, cfg=cfg, params=np_tree(p),
                                      x=x, kv_x=kv, ct=ct)
            self.whole[name] = run_whole(kind, cfg, p, x, kv, ct)
        self.res = run_world(ranks.split_world, 2, backend="gloo",
                             device="cpu", timeout=60, deadline=300,
                             args=({"ops": self.ops, "ce": self.ce,
                                    "modules": self.modules},))


@pytest.fixture(scope="module")
def world():
    threads = torch.get_num_threads()
    try:
        return World()
    finally:
        torch.set_num_threads(threads)


def close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(
        float(np.abs(want).max()), 1e-30))


# ------------------------------------------------------------ operators

def test_copy_to_model_forward_and_gradient(world):
    """"f" before a column-parallel product: each rank's columns of
    ``x @ w`` exactly, and the gradient of ``x`` summed over the ranks
    equals one process's ``ct @ w.T`` within ``REL``."""
    c = world.ops["f32"]
    y = c["x"] @ c["w"]
    gx = c["ct"] @ c["w"].T
    for r, res in enumerate(world.res):
        o = res["ops"]["f32"]
        np.testing.assert_array_equal(o["f_y"], y[:, r * 4:(r + 1) * 4])
        close(o["f_gx"], gx, REL)
        np.testing.assert_array_equal(o["f_gx"], world.res[0]["ops"]["f32"]
                                      ["f_gx"])


@pytest.mark.parametrize("dt", sorted(OPS))
def test_reduce_from_model_sums_in_f32_and_rounds_once(world, dt):
    """"g" after a row-parallel product: the two ranks' f32 partials
    summed in f32 and rounded once to the value dtype, the same bits on
    both ranks, within ``REL`` (f32) or ``BF16_REL`` (bf16) of one
    process's product; the backward hands each rank's partial the
    gradient unchanged."""
    c = world.ops[dt]
    torch_dt = getattr(torch, OPS[dt])
    o0, o1 = (res["ops"][dt] for res in world.res)
    want = torch.as_tensor(o0["g_part"] + o1["g_part"]).to(torch_dt)
    for o in (o0, o1):
        assert o["g_dtype"] == str(torch_dt)
        np.testing.assert_array_equal(o["g_y"], want.float().numpy())
    h = torch.as_tensor(c["h"]).to(torch_dt)
    wd = torch.as_tensor(c["wd"]).to(torch_dt)
    full = torch.matmul(h, wd).float().numpy()
    close(o0["g_y"], full, REL if dt == "f32" else BF16_REL)
    ct = torch.as_tensor(c["ct2"]).to(torch_dt).float()
    gh = (ct @ wd.float().T).numpy()
    for r, o in enumerate((o0, o1)):
        assert o["g_gh_dtype"] == str(torch_dt)
        close(o["g_gh"], gh[:, r * 16:(r + 1) * 16],
              REL if dt == "f32" else BF16_REL)


def test_sum_over_model_sums_forward_and_backward(world):
    """The mixers' sum read by every rank: the two partials summed exactly
    (one f32 addition), the same bits on both ranks; each rank's partial
    gets the sum of both ranks' cotangents, as the whole sum's gradient
    is."""
    c = world.ops["f32"]
    want = c["s"][0] + c["s"][1]
    grad = c["sct"][0] + c["sct"][1]
    for res in world.res:
        o = res["ops"]["f32"]
        np.testing.assert_array_equal(o["sum_y"], want)
        np.testing.assert_array_equal(o["sum_gs"], grad)


def test_gather_over_model_gathers_and_reduce_scatters(world):
    """The RG-LRU's gate input: every rank's block gathered in rank order
    exactly; the gradient of each rank's block, where each rank reads the
    whole through its own columns, equals that block of the whole's
    gradient (the sum over the ranks' readers) within ``REL``."""
    c = world.ops["f32"]
    gu = sum(c["uct"][r] @ c["uw"][r].T for r in range(2))
    for r, res in enumerate(world.res):
        o = res["ops"]["f32"]
        np.testing.assert_array_equal(o["gather_y"], c["u"])
        close(o["gather_gu"], gu[:, r * 8:(r + 1) * 8], REL)


def test_all_reduce_max_is_detached(world):
    m = world.ops["f32"]["m"].max(axis=0)
    for res in world.res:
        np.testing.assert_array_equal(res["ops"]["f32"]["max"], m)
        assert res["ops"]["f32"]["max_grad"] is False


def test_model_shard_sizes(world):
    """Inside ``model_shard`` over (1, 2) ``tp_size`` is 2, ``tp_rank`` the
    rank's model coordinate, and the model code splits over 2; outside it
    nothing splits."""
    for r, res in enumerate(world.res):
        assert res["sizes"] == (2, r, 2)
        assert res["outside"] == (0, 1)


# ------------------------------------------------------------ the loss

@pytest.mark.parametrize("dt", sorted(OPS))
def test_vocab_parallel_cross_entropy(world, dt):
    """``loss_fn`` on each rank's half of the vocab (masked labels and the
    last id included) against ``loss_fn`` on the whole logits in one
    process: the loss within ``REL`` relative, the logits' gradient within
    ``REL`` (f32) or ``BF16_REL`` (bf16) of its largest."""
    c = world.ce[dt]
    torch_dt = getattr(torch, c["dtype"])
    logits = torch.as_tensor(c["logits"]).to(torch_dt).requires_grad_()
    tot, (loss, _) = loss_fn(ranks._Logits(c["cfg"], logits), None,
                             {"labels": torch.as_tensor(c["labels"])})
    g, = torch.autograd.grad(tot, logits)
    g = g.float().numpy()
    for res in world.res:
        got = res["ce"][dt]["loss"]
        want = float(loss.detach())
        assert abs(got - want) <= REL * abs(want), (got, want)
        assert got == world.res[0]["ce"][dt]["loss"]
    grad = np.concatenate([res["ce"][dt]["grad"] for res in world.res], -1)
    close(grad, g, REL if dt == "f32" else BF16_REL)


# ------------------------------------------------------------ modules

@pytest.mark.parametrize("name", sorted(MODULES))
def test_split_module_matches_whole(world, name):
    """The split module against the unsplit one at the full width: output
    and input gradient on every rank, and the whole parameter gradient as
    the sharded step assembles it (SPLIT leaves gathered over ``model``,
    PART leaves summed), within ``REL`` (f32) or ``BF16_REL`` (bf16) of
    each one's largest; each leaf read as the table says."""
    kind, cfg, want_reads = MODULES[name]
    rel = REL if cfg.dtype == "float32" else BF16_REL
    y, gx, grads = world.whole[name]
    for res in world.res:
        got = res["modules"][name]
        for path, k in flatten_with_path(got["reads"]):
            top = "embed" if path.startswith("embed") else \
                path.split("/")[-2] if kind == "attn" else \
                path.split("/")[-1] if kind == "ssm" else path.split("/")[0]
            if kind == "attn" and path.endswith("wo/b"):
                top = None
            assert k == want_reads.get(top, WHOLE), (path, k)
        close(got["y"], y, rel)
        if gx is not None:
            close(got["gx"], gx, rel)
        for (path, a), (_, b) in zip(flatten_with_path(got["grads"]),
                                     flatten_with_path(grads)):
            assert a.shape == b.shape, path
            close(a, b, rel)
