"""Rank bodies of the port's sharded-training tests
(``test_torch_sharded_train.py``, and ``test_torch_launch_tools.py``'s
counted step).

Spawned ranks import this module, which imports only numpy, torch and
``repro_torch``: the test process makes the inputs from numpy seeds (the
reference's initial states, through ``convert``), runs the references, and
hands the ranks numpy arrays.  ``train_world`` runs every check of one
world and returns numpy results.
"""

import contextlib

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import make_global_batch
from repro_torch.distributed.fault_tolerance import (NodeFailure,
                                                     ResilientTrainer)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import pspec
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.sharding import (gather_tree, make_batch_shardings,
                                        make_state_shardings, shard_tree)
from repro_torch.train.step import make_sharded_train_step
from repro_torch.tree import tree_map

MESHES = ((2, 2), (4, 1), (1, 4))
AXES = ("data", "model")
# the gather's backward over (2, 2): name -> (one layer's shape, its storage
# spec, how the split reads it, stacked over GATHER_GROUPS groups)
GATHER_GROUPS = 2
GATHER_LEAVES = {"part_both": ((8, 4), ("data", "model"), "part", True),
                 "whole_both": ((8, 4), ("data", "model"), "whole", False),
                 "split": ((8, 4), ("data", "model"), "split", False),
                 "part_repl": ((4,), (None,), "part", False),
                 "whole_repl": ((6,), (None,), "whole", False)}


def np_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def t_batch(host: dict, dev="cpu") -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def sharded_placement(mesh, state, host_batch):
    """The state's shardings and this rank's slice of ``host_batch``."""
    ssh = make_state_shardings(mesh, state)
    global_batch = host_batch["tokens"].shape[0] * host_batch["tokens"].shape[1]
    bsh = make_batch_shardings(mesh, host_batch, global_batch, batch_axis=1)
    return ssh, bsh


def one_step(cfg, state_np, host, opt, shape, dev="cpu", counter=None):
    """One sharded step over mesh ``shape`` from the reference's state: the
    gathered new state (numpy), the metrics, this rank's batch slice and its
    mesh coordinate.  ``counter``: a context manager around the step alone
    (``launch.op_cost.OpCost``)."""
    mesh = make_mesh(shape, AXES)
    pspec.set_mesh(mesh)
    try:
        state = convert.train_state(state_np, device=dev)
        ssh, bsh = sharded_placement(mesh, state, host)
        mine = shard_tree(state, ssh.specs, mesh)
        local = make_global_batch(mesh, host, bsh)
        step = make_sharded_train_step(build_model(cfg), AdamWConfig(**opt),
                                       ssh)
        with counter if counter is not None else contextlib.nullcontext():
            new, m = step(mine, t_batch(local, dev))
        full = gather_tree(new, ssh.specs, mesh)
    finally:
        pspec.set_mesh(None)
    metrics = {k: float(v) for k, v in m.items()}
    return np_tree(full), metrics, local, list(mesh.get_coordinate())


class RecordingCheckpointer(Checkpointer):
    """Keeps what each ``restore`` gave, gathered to full leaves."""

    def __init__(self, directory):
        super().__init__(directory)
        self.restored = []

    def restore(self, step, target_tree, shardings=None):
        out = super().restore(step, target_tree, shardings)
        full = out if shardings is None else gather_tree(
            out, shardings.specs, shardings.mesh)
        self.restored.append((step, np_tree(full)))
        return out


def elastic(cfg, state_np, batches, opt, ckdir, n_steps, fail_at,
            lost_nodes, ckpt_every):
    """``ResilientTrainer`` over (2, 2) on 4 ranks; a ``NodeFailure`` of
    ``lost_nodes`` at ``fail_at``; the survivors (the first ranks) go on
    over (1, 4 - lost) with the state restored resharded."""
    model = build_model(cfg)
    aopt = AdamWConfig(**opt)
    template = convert.train_state(state_np, device="cpu")

    def make(n_lost):
        n = 4 - n_lost
        shape = (2, 2) if n == 4 else (1, n)
        mesh = make_mesh(shape, AXES)          # collective: every rank
        if mesh.get_coordinate() is None:
            return None
        ssh, bsh = sharded_placement(mesh, template, batches[0])

        def place(host):
            return t_batch(make_global_batch(mesh, host, bsh))

        return mesh, ssh, make_sharded_train_step(model, aopt, ssh), place

    ck = RecordingCheckpointer(ckdir)
    mesh0 = make_mesh((2, 2), AXES)
    state = shard_tree(template, make_state_shardings(mesh0, template).specs,
                       mesh0)
    trainer = ResilientTrainer(checkpointer=ck, make_mesh_and_step=make,
                               ckpt_every=ckpt_every)
    state, rep = trainer.run(state, lambda s: batches[s], n_steps,
                             inject={fail_at: NodeFailure(
                                 "ranks 2 and 3 died", lost_nodes=lost_nodes)})
    return dict(steps_done=rep.steps_done, restarts=rep.restarts,
                reshards=rep.reshards, losses=rep.losses, final=state,
                restored=ck.restored)


def train_world(rank, cases, ck_case, el_case, mixers, gather_grads):
    """Every check of ``test_torch_sharded_train.py`` in a world of 4: the
    sharded step of each case over ``MESHES``; the olmo case's step over
    (1, 4) counted by ``launch.op_cost`` (its dot FLOPs); a sharded
    checkpoint of the olmo case's stepped state over (2, 2), restored onto
    (4, 1); the elastic restart; ``mixers``, recurrent mixer cases of
    ``torch_split_ranks.module_case``, over (1, 4); and the layer gather's
    backward (``gather_case``) with ``gather_grads``."""
    from torch_split_ranks import module_case

    from repro_torch.launch.op_cost import OpCost

    mesh14 = make_mesh((1, 4), AXES)
    out = {"rank": rank, "steps": {},
           "mixers": {k: module_case(c, mesh14) for k, c in mixers.items()},
           "gather": gather_case(rank, gather_grads)}
    for name, (cfg, state_np, host, opt) in cases.items():
        for shape in MESHES:
            full, metrics, local, coord = one_step(
                cfg, state_np, host, opt, shape)
            res = {"metrics": metrics, "coord": coord, "local": local}
            if rank == 0:
                res["state"] = full
            out["steps"][(name, shape)] = res
    cost = OpCost()
    one_step(*cases["olmo-1b"], (1, 4), counter=cost)
    out["flops14"] = cost.totals()["dot_flops"]

    # a sharded save over (2, 2), read back onto (4, 1)
    cfg, state_np, host, opt, ckdir = ck_case
    mesh22 = make_mesh((2, 2), AXES)
    state = convert.train_state(state_np, device="cpu")
    ssh22, _ = sharded_placement(mesh22, state, host)
    mine = shard_tree(state, ssh22.specs, mesh22)
    ck = Checkpointer(ckdir)
    ck.save(7, mine, ssh22)
    mesh41 = make_mesh((4, 1), AXES)
    ssh41, _ = sharded_placement(mesh41, state, host)
    back = ck.restore(7, mine, ssh41)
    out["ckpt"] = dict(coord41=list(mesh41.get_coordinate()),
                       slices=np_tree(back))

    cfg, state_np, batches, opt, ckdir, kw = el_case
    rep = elastic(cfg, state_np, batches, opt, ckdir, **kw)
    mesh = make_mesh((1, 4 - kw["lost_nodes"]), AXES)  # collective: all ranks
    if rep["final"] is not None:
        ssh, _ = sharded_placement(mesh, convert.train_state(
            state_np, device="cpu"), batches[0])
        rep["final"] = np_tree(gather_tree(rep["final"], ssh.specs, mesh))
    out["elastic"] = rep
    return out


def card_step(rank, cfg, state_np, host, opt, shape=(2, 1)):
    """One sharded step over ``shape`` on this rank's card (the ranks share
    it): the gathered new state (numpy) and the metrics."""
    dev = torch.device("cuda", torch.cuda.current_device())
    full, metrics, _, _ = one_step(cfg, state_np, host, opt, shape, dev)
    return full, metrics


def counted_step(rank, cfg):
    """One sharded step of a state from ``Model.init`` over a (2, 1) mesh
    under ``launch.op_cost.OpCost``, M = 1: the collectives it counted, and
    the ones the port's plan says it issues, output bytes each: an
    ``all_gather`` per ``sharding.buckets`` run of the leaves outside the
    layer stacks that are sharded over data, and one per use of each stack
    leaf sharded over data (a group's leaves twice under remat: forward
    and recompute); a reduce-scatter of each such leaf's f32 gradient, an
    ``all_reduce`` of each stack leaf stored whole; an ``all_reduce`` per
    bucket of the other leaves' f32 gradients with loss and aux, and one of
    the gradient norm."""
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.train.sharding import _spec_axes, buckets, stack_plan
    from repro_torch.train.step import init_train_state
    from repro_torch.tree import leaves

    mesh = make_mesh((2, 1), AXES)
    pspec.set_mesh(mesh)
    try:
        model = build_model(cfg)
        state = init_train_state(model, torch.Generator().manual_seed(3),
                                 device="cpu")
        ssh = make_state_shardings(mesh, state)
        mine = shard_tree(state, ssh.specs, mesh)
        batch = {k: torch.zeros((1, 1, 16), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = make_sharded_train_step(model, AdamWConfig(), ssh)
        with OpCost() as cost:
            step(mine, batch)
    finally:
        pspec.set_mesh(None)
    plans, specs = [], []
    tree_map(lambda t, p, s: (plans.append(p), specs.append(s)),
             mine.params, stack_plan(mesh, ssh.specs.params, None,
                                     mine.params), ssh.specs.params)
    sharded = [any("data" in _spec_axes(e) for e in s) for s in specs]
    outside, grads = [], []
    plan = {"all-gather": [], "reduce-scatter": [], "all-reduce": []}
    for t, full, p, on_data in zip(leaves(mine.params),
                                   leaves(state.params), plans, sharded):
        nbytes = t.numel() * t.element_size()
        if p is None:
            grads.append(torch.zeros(full.shape))
            if on_data:
                outside.append(t)
            continue
        groups = t.shape[0] if p.stacked else 1   # one layer's slice each
        if on_data:
            uses = 2 if p.stacked and cfg.remat else 1
            plan["all-gather"] += [2 * nbytes // groups] * (groups * uses)
            plan["reduce-scatter"] += [t.numel() * 4 // groups] * groups
        else:
            plan["all-reduce"] += [t.numel() * 4 // groups] * groups

    def sizes(ts):
        return [sum(ts[i].numel() * ts[i].element_size() for i in run)
                for run in buckets(ts)]

    plan["all-gather"] += [2 * b for b in sizes(outside)]
    plan["all-reduce"] += sizes(grads + [torch.zeros(2)]) + [4]
    t = cost.totals()
    return {"counts": t["coll_counts"], "bytes": t["coll_bytes"],
            "plan": plan}


# ------------------------------------------------------------ the gather

def _spec(name) -> tuple:
    _, spec, _, stacked = GATHER_LEAVES[name]
    return (None,) + spec if stacked else spec


def _cut(x, spec, coord, axes):
    """``x``'s block along each dimension of ``spec`` that names one of
    ``axes`` (each of 2 ranks), at ``coord`` (data, model)."""
    at = dict(zip(AXES, coord))
    for dim, e in enumerate(spec):
        if e in axes:
            n = x.shape[dim] // 2
            x = np.take(x, range(at[e] * n, (at[e] + 1) * n), axis=dim)
    return x


def leaf_value(name):
    """The whole leaf, exact in bf16 (each group its own values)."""
    shape, _, _, stacked = GATHER_LEAVES[name]
    shape = ((GATHER_GROUPS,) if stacked else ()) + shape
    return (np.arange(int(np.prod(shape))).reshape(shape) % 97 - 48) / 16


def seen_by(name, x, coord):
    """What the gathered forward holds of ``x`` on the rank at ``coord``:
    the leaf whole, or a SPLIT leaf's model block."""
    read = GATHER_LEAVES[name][2]
    return _cut(x, _spec(name), coord, ("model",) if read == "split" else ())


def stored_of(name, x, coord):
    """The rank's stored block of ``x``, a tensor shaped like what the
    gathered forward holds."""
    read = GATHER_LEAVES[name][2]
    return _cut(x, _spec(name), coord,
                ("data",) if read == "split" else AXES)


def gather_case(rank, grads):
    """Every leaf of ``GATHER_LEAVES`` stored over (2, 2), gathered through
    ``sharding.stack_plan`` and ``pspec.layer_gather`` as ``Stack.apply``
    reads a layer (``transformer._index``), and differentiated with this
    rank's cotangents ``grads[name][rank]``: the forward and each slice's
    f32 sink."""
    from repro_torch.models.transformer import _index
    from repro_torch.train.sharding import local_slice, stack_plan

    mesh = make_mesh((2, 2), AXES)
    stacks = {k: {"groups": [{}], "rest": [{}]} for k in ("p", "s", "r")}
    for name, (_, spec, read, stacked) in GATHER_LEAVES.items():
        where = "groups" if stacked else "rest"
        full = torch.from_numpy(leaf_value(name)).to(torch.bfloat16)
        stacks["p"][where][0][name] = local_slice(full, _spec(name),
                                                  mesh).clone()
        stacks["s"][where][0][name] = _spec(name)
        stacks["r"][where][0][name] = read
    params = {"decoder": stacks["p"]}
    plan = stack_plan(mesh, {"decoder": stacks["s"]},
                      {"decoder": stacks["r"]}, params)
    table, sinks = {}, {}
    names = {id(t): n for n, t in {**stacks["p"]["groups"][0],
                                   **stacks["p"]["rest"][0]}.items()}

    def sink(t, lg):
        sinks[names[id(t)]] = torch.zeros(t.shape, dtype=torch.float32)
        table[id(t)] = (lg, sinks[names[id(t)]])

    tree_map(sink, params, plan)
    token = torch.empty(0, requires_grad=True)
    outs, cots, fwd = [], [], {}
    with pspec.layer_gather(mesh, table, token):
        layers = [_index(params["decoder"]["groups"][0], g)
                  for g in range(GATHER_GROUPS)]
        rest = _index(params["decoder"]["rest"][0])
    for name, (_, _, _, stacked) in GATHER_LEAVES.items():
        cot = torch.from_numpy(grads[name][rank]).to(torch.bfloat16)
        got = [lay[name] for lay in layers] if stacked else [rest[name]]
        outs += got
        cots += list(cot) if stacked else [cot]
        fwd[name] = torch.stack(got).detach().float().numpy() if stacked \
            else got[0].detach().float().numpy()
    torch.autograd.grad(outs, [token], cots, allow_unused=True)
    return {"coord": list(mesh.get_coordinate()), "forward": fwd,
            "sinks": {k: v.numpy() for k, v in sinks.items()}}
