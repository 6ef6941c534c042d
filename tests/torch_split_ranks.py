"""Rank bodies of ``test_torch_model_split.py``: the model-axis operators
("f", "g", the max, the mixers' sum and gather), the vocab-parallel
cross-entropy and the split attention, MLP, expert FFN, embedding, head
and recurrent mixers, on a ``gloo`` world of 2 ranks over a (1, 2) mesh
(``module_case`` also runs in ``test_torch_sharded_train.py``'s world of
4).

Spawned ranks import this module, which imports only numpy, torch and
``repro_torch``.  The test process hands them numpy inputs; each rank runs
the split function inside ``pspec.model_shard`` on its slices (cut from the
full parameters as ``train.sharding.model_reads`` says the sharded step
reads them), and returns numpy results.
"""

import numpy as np
import torch

from repro_torch.distributed import (all_reduce_max, all_reduce_sum_,
                                     copy_to_model, gather_over_model,
                                     reduce_from_model, sum_over_model)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import pspec
from repro_torch.models.model_zoo import loss_fn
from repro_torch.train.sharding import (PART, SPLIT, gather_tree,
                                        local_slice, make_param_shardings,
                                        model_reads)
from repro_torch.tree import leaves, tree_map

AXES = ("data", "model")


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def npy(x):
    return x.detach().float().numpy().copy()


def ops_case(case, mesh):
    """"f" before a column slice, "g" after a row slice, and the max."""
    r, n = mesh.get_coordinate()[1], 2
    x = t(case["x"]).requires_grad_()
    w = t(case["w"])                                   # (D, N)
    cols = w.shape[1] // n
    y = copy_to_model(x, mesh) @ w[:, r * cols:(r + 1) * cols]
    ct = t(case["ct"])[:, r * cols:(r + 1) * cols]
    gx, = torch.autograd.grad((y * ct).sum(), x)
    out = {"f_y": npy(y), "f_gx": npy(gx)}

    dt = getattr(torch, case["dtype"])
    h = t(case["h"]).to(dt)                           # (B, F)
    wd = t(case["wd"]).to(dt)                         # (F, D)
    rows = h.shape[1] // n
    hr = h[:, r * rows:(r + 1) * rows].detach().requires_grad_()
    part = torch.matmul(hr.float(), wd[r * rows:(r + 1) * rows].float())
    y = reduce_from_model(part, mesh, dt)
    ct = t(case["ct2"]).to(dt)
    gh, = torch.autograd.grad((y.float() * ct.float()).sum(), hr)
    out.update(g_y=npy(y), g_dtype=str(y.dtype), g_part=npy(part),
               g_gh=npy(gh), g_gh_dtype=str(gh.dtype))

    m = t(case["m"])[r]
    mx = all_reduce_max(m.requires_grad_(), mesh)
    out.update(max=npy(mx), max_grad=mx.requires_grad)

    # the mixers' two: a sum read by every rank, a gather read in part
    s = t(case["s"])[r].requires_grad_()
    y = sum_over_model(s, mesh)
    gs, = torch.autograd.grad((y * t(case["sct"])[r]).sum(), s)
    u = t(case["u"])
    cols = u.shape[1] // n
    ur = u[:, r * cols:(r + 1) * cols].clone().requires_grad_()
    whole = gather_over_model(ur, mesh, -1)
    gu, = torch.autograd.grad(
        ((whole @ t(case["uw"])[r]) * t(case["uct"])[r]).sum(), ur)
    out.update(sum_y=npy(y), sum_gs=npy(gs), gather_y=npy(whole),
               gather_gu=npy(gu))
    return out


class _Logits:
    """A stand-in model whose train forward returns given logits."""

    def __init__(self, cfg, logits):
        self.cfg, self.logits = cfg, logits

    def forward(self, params, batch, mode="train"):
        return self.logits, torch.zeros(()), None


def ce_case(case, mesh):
    """``loss_fn`` on this rank's vocab slice of the logits: the loss and
    the gradient of the slice."""
    cfg = case["cfg"]
    r = mesh.get_coordinate()[1]
    dt = getattr(torch, case["dtype"])
    full = t(case["logits"]).to(dt)
    vl = full.shape[-1] // 2
    mine = full[..., r * vl:(r + 1) * vl].detach().requires_grad_()
    with pspec.model_shard(mesh):
        tot, (loss, _) = loss_fn(_Logits(cfg, mine), None,
                                 {"labels": t(case["labels"])})
        g, = torch.autograd.grad(tot, mine)
    return {"loss": float(loss.detach()), "grad": npy(g)}


def _full_grads(grads, reads, specs, mesh):
    """The whole gradient from the ranks' parts, as the sharded step
    assembles it: SPLIT leaves gathered over ``model``, PART leaves summed
    over it, WHOLE leaves as they are."""
    for g, k in zip(leaves(grads), leaves(reads)):
        if k == PART:
            all_reduce_sum_(g, mesh, "model")
    over_model = tree_map(
        lambda k, s: tuple(e if e == "model" else None for e in s)
        if k == SPLIT else (), reads, specs)
    return gather_tree(grads, over_model, mesh)


def module_case(case, mesh):
    """One split module: its output, the gradient of its input and the
    whole gradient of its parameters (``_full_grads``), and each leaf's
    read (``model_reads``)."""
    from repro_torch.models.attention import attention_forward
    from repro_torch.models.layers import embed_tokens, lm_logits
    from repro_torch.models.mlp import apply_mlp
    from repro_torch.models.moe import expert_ffn
    from repro_torch.models.rglru import apply_rglru
    from repro_torch.models.ssm import apply_ssm

    cfg = case["cfg"]
    dt = getattr(torch, cfg.dtype)
    tree = tree_map(lambda a: t(a).to(dt), case["params"])
    reads = model_reads(mesh, cfg, tree)
    specs = make_param_shardings(mesh, tree)
    # what the step's gather_tree gives a rank: over a data axis of one
    # rank, its model slice of a SPLIT leaf, any other leaf whole
    mine = tree_map(lambda a, s, k: (local_slice(a, s, mesh) if k == SPLIT
                                     else a).clone().requires_grad_(),
                    tree, specs, reads)
    x = t(case["x"])
    if x.is_floating_point():
        x = x.to(dt).requires_grad_()
    kind = case["kind"]
    with pspec.model_shard(mesh):
        if kind == "attn":
            pos = torch.arange(x.shape[1], dtype=torch.int32)
            kv = None if case.get("kv_x") is None else t(case["kv_x"]).to(dt)
            y, _ = attention_forward(mine["attn"], x, cfg, positions=pos,
                                     kv_x=kv, causal=kv is None)
        elif kind == "mlp":
            y = apply_mlp(mine["mlp"], x, cfg)
        elif kind == "moe":
            y = expert_ffn(mine["moe"], x, cfg)
        elif kind in ("ssm", "rglru"):
            mixer = apply_ssm if kind == "ssm" else apply_rglru
            y, _ = mixer(mine["mixer"], x, cfg)
        else:                                   # embed then head
            h = embed_tokens(mine["embed"], x, cfg)
            y = lm_logits(mine["head"], mine["embed"], h, cfg)
        ct = t(case["ct"]).to(y.dtype)
        if y.shape[-1] != ct.shape[-1]:         # this rank's vocab slice
            vl = y.shape[-1]
            ct = ct[..., pspec.tp_rank() * vl:(pspec.tp_rank() + 1) * vl]
        flat = leaves(mine)
        wrt = flat + ([x] if x.requires_grad else [])
        gs = torch.autograd.grad((y.float() * ct.float()).sum(), wrt,
                                 allow_unused=True)
        if y.shape[-1] != t(case["ct"]).shape[-1]:
            y = gather_tree(y.detach(), (None,) * (y.ndim - 1) + ("model",),
                            mesh)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(wrt, gs)]
    it = iter(gs[:len(flat)])
    grads = tree_map(lambda _: next(it).detach().clone(), mine)
    whole = _full_grads(grads, reads, specs, mesh)
    return {"y": npy(y), "gx": npy(gs[-1]) if x.requires_grad else None,
            "grads": tree_map(npy, whole), "reads": reads}


def split_world(rank, cases):
    """Every case of ``test_torch_model_split.py`` on a (1, 2) mesh."""
    mesh = make_mesh((1, 2), AXES)
    out = {"ops": {k: ops_case(c, mesh) for k, c in cases["ops"].items()},
           "ce": {k: ce_case(c, mesh) for k, c in cases["ce"].items()},
           "modules": {k: module_case(c, mesh)
                       for k, c in cases["modules"].items()}}
    with pspec.model_shard(mesh):
        out["sizes"] = (pspec.tp_size(), pspec.tp_rank(),
                        pspec.model_split())
    out["outside"] = (pspec.tp_rank(), pspec.model_split())
    return out
