"""Port parity: sharded training (``repro_torch.train.step.
make_sharded_train_step`` over ``train.sharding``'s FSDP x TP specs,
``data.pipeline.make_global_batch``, ``Checkpointer`` with shardings,
``distributed.fault_tolerance.ResilientTrainer``, and the launcher's
``--devices`` / ``--mesh`` path) on ``torch.distributed`` with ``gloo`` on
the CPU.

The reference's sharded-training tests (``tests/test_distributed.py``) fail
on the reference itself, so the sharded step is held against single-device
steps: the port's ``make_train_step`` and the reference's jitted
``make_train_step``, from the reference's initial state
(``convert.train_state``).  The step splits its compute over the ``model``
axis (Megatron's column- and row-parallel products, the vocab-parallel
embedding, head and cross-entropy; ``models/pspec.py`` ``model_shard``), so
the cases cover each way a leaf is read (``train.sharding.model_reads``):

* reduced olmo-1b (tied vocab split; heads under "repeat" over model 4,
  "kv" over 2) and the same with ``n_kv_heads`` 4 ("kv" over 4 and 2);
* reduced qwen2.5-3b (untied head, q/k/v biases; ``n_heads`` 4,
  ``n_kv_heads`` 2: "repeat" over 4, "kv" over 2) and the same at
  ``n_heads`` 8 ("group" over 4);
* granite-moe-1b-a400m (the experts' ``d_ff`` split), at a dropless
  capacity, so that the reference's per-shard dispatch groups and the
  single device's one group drop nothing;
* mamba2-780m (the Mamba2 mixer split by SSD head: its ``w_in``, conv
  and per-head leaves gathered whole and read in part, ``norm_scale`` and
  ``w_out`` read as the rank's slice; 8 heads split 4 and 2 ways) and
  reduced recurrentgemma-2b (the RG-LRU split by width, 64 over 4 and 2;
  4 q heads over 1 kv head: "repeat" over 4, "group" over 2);
* reduced olmo-1b with ``vocab_size`` 250, which does not divide 4 (the
  embedding gathered whole, the logits whole);
* layers stacked into remat groups, whose leaves the step gathers group by
  group at use (``pspec.layer_gather``; a stacked leaf's spec is
  ``P(None, *spec)``): olmo-1b at 4 layers in four groups of one, with
  remat and without; granite-moe-1b-a400m at 4 layers in two groups of two
  (stacked expert leaves ``P(None, None, f, t)``); recurrentgemma-2b at 7
  layers, two groups of three and one rest layer (the RG-LRU split by
  width inside a group).

The gather's backward (``distributed.gather_for_use``) is held apart from
the step over (2, 2) against a reduction by hand: a stored slice of every
kind of leaf (PART and WHOLE split over both axes, PART and WHOLE
replicated, SPLIT, stacked) gathered, and per-rank gradients whose pairwise
sums need f32 summed back into the slices: over the batch axes and, for
PART, over ``model`` in f32, WHOLE only cut to the rank's block, exactly.

A rank's forward takes its batch slice as one MoE dispatch group, as the
reference's GSPMD forward does for each data shard, and averages the
router's load statistics over the data shards, as the reference's means
over the whole batch do; at a dropless capacity the groups change nothing,
so one device is the yardstick.  The spawned ranks
(``torch_sharded_ranks.train_world``, one world of 4 ranks for the file,
each on one thread) import only torch and ``repro_torch``.  The same world
runs ``test_torch_model_split.py``'s recurrent mixer cases over (1, 4):
output, input gradient and every parameter gradient (PART leaves summed)
against the unsplit mixer at that file's bounds.  Tolerances:

* over every mesh, (1, 4), (2, 2) and (4, 1), the gradient is an f32 sum
  in another order than one device's (the row-parallel products' partial
  sums over ``model``, the data shards' means over ``data``): loss and
  grad_norm within ``GRAD_REL`` relative, the moments within ``GRAD_REL``
  of each leaf's largest, and the parameters within ``1e-3 * lr`` where
  the single device's |m| exceeds 1e-3 of its leaf's largest (an AdamW
  step is about ``lr * sign(g)``, so near-zero gradients may step either
  way) and ``2 * lr`` everywhere;
* against the reference the same bounds, as in ``test_torch_train_lm.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

import torch_sharded_ranks as ranks
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models.model_zoo import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.train.step import init_train_state as jinit
from repro.train.step import make_train_step as jstep
from repro_torch import convert
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import run_world
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig, OptState
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.tree import flatten_with_path, tree_map

import test_torch_model_split as split_cases
from test_torch_models import cfg_pair, to_np

GRAD_REL = 1e-5
OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)   # the reference test's
LR = OPT["peak_lr"]
# name -> (architecture, reduced-config overrides); dropless MoE: capacity
# for every (token, choice) of a batch shard
CASES = {"olmo-1b": ("olmo-1b", {}),
         "olmo-1b-kv4": ("olmo-1b", {"n_kv_heads": 4}),
         "olmo-1b-v250": ("olmo-1b", {"vocab_size": 250}),
         "qwen2.5-3b": ("qwen2.5-3b", {}),
         "qwen2.5-3b-h8": ("qwen2.5-3b", {"n_heads": 8}),
         "granite-moe-1b-a400m": ("granite-moe-1b-a400m",
                                  {"capacity_factor": 8.0}),
         "mamba2-780m": ("mamba2-780m", {}),
         "recurrentgemma-2b": ("recurrentgemma-2b", {}),
         # layers stacked into remat groups
         "olmo-1b-g": ("olmo-1b", {"n_layers": 4, "scan_unroll": 1}),
         "olmo-1b-g-noremat": ("olmo-1b", {"n_layers": 4, "scan_unroll": 1,
                                           "remat": False}),
         "granite-moe-1b-a400m-g": ("granite-moe-1b-a400m",
                                    {"n_layers": 4, "scan_unroll": 2,
                                     "capacity_factor": 8.0}),
         "recurrentgemma-2b-g": ("recurrentgemma-2b",
                                 {"n_layers": 7, "scan_unroll": 1})}
MIXER_CASES = ("ssm", "ssm-bf16", "rglru")   # test_torch_model_split's
SPLIT_FLOPS = 0.35      # rank 0's dot FLOPs over (1, 4) against one device's
ELASTIC = dict(n_steps=6, fail_at=3, lost_nodes=2, ckpt_every=2)


def port_state(js) -> TrainState:
    """The reference's state as numpy leaves in the port's named tuples
    (the spawned ranks cannot unpickle the reference's)."""
    s = to_np(js)
    return TrainState(params=s.params, opt=OptState(m=s.opt.m, v=s.opt.v,
                                                    count=s.opt.count),
                      step=s.step)


def one_thread_step(tc, state_np, host, n=1):
    """``n`` single-device port steps on one thread, from ``state_np``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        st = convert.train_state(state_np, device="cpu")
        fn = make_train_step(build_model(tc), AdamWConfig(**OPT))
        hosts = host if isinstance(host, list) else [host]
        ms = []
        for h in hosts[:n]:
            st, m = fn(st, {k: torch.from_numpy(v) for k, v in h.items()})
            ms.append({k: float(v) for k, v in m.items()})
    finally:
        torch.set_num_threads(threads)
    return st, ms


def ref_leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


def port_np_leaves(tree):
    """Leaves of a port tree of tensors or numpy arrays, in
    ``jax.tree.leaves`` order, as f32 numpy."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif torch.is_tensor(node):
            out.append(node.detach().float().numpy())
        else:
            out.append(np.asarray(node, np.float32))
    walk(tree)
    return out


def hold_state(state, ref_params, ref_m, ref_v, what):
    """The AdamW rule of the module docstring on params and moments."""
    for a, b, m in zip(port_np_leaves(state.params), ref_params, ref_m):
        d = np.abs(a - b)
        assert d.max() <= 2 * LR * 1.0001, what
        firm = np.abs(m) > 1e-3 * np.abs(m).max()
        if firm.any():
            assert d[firm].max() <= 1e-3 * LR, (what, float(d[firm].max()))
    for a, b in zip(port_np_leaves(state.opt.m) + port_np_leaves(state.opt.v),
                    ref_m + ref_v):
        np.testing.assert_allclose(a, b, rtol=0, err_msg=what,
                                   atol=GRAD_REL * max(float(np.abs(b).max()),
                                                       1e-30))


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


class Cases:
    """Inputs from numpy seeds and the reference's init, the single-device
    steps of both packages, and the world's results."""

    def __init__(self, tmp):
        self.cfg, self.state, self.host = {}, {}, {}
        self.single, self.ref = {}, {}
        for name, (arch, over) in CASES.items():
            jc, tc = cfg_pair(arch, **over)
            pipe = TokenPipeline(vocab=tc.vocab_size, seq_len=16,
                                 global_batch=8, microbatches=2)
            js = jinit(jbuild(jc), jax.random.PRNGKey(0))
            self.cfg[name], self.state[name] = tc, port_state(js)
            self.host[name] = pipe.next_host_batch()
            self.single[name] = one_thread_step(tc, self.state[name],
                                                self.host[name])
            jfn = jax.jit(jstep(jbuild(jc), jadamw.AdamWConfig(**OPT)))
            self.ref[name] = jfn(js, jax.tree.map(jnp.asarray,
                                                  self.host[name]))
        self.single_flops = counted_single_step(
            self.cfg["olmo-1b"], self.state["olmo-1b"], self.host["olmo-1b"])
        olmo = self.cfg["olmo-1b"]
        # the checkpoint: olmo's state after one step (moments nonzero)
        st = self.single["olmo-1b"][0]
        self.ck_state = tree_map(lambda t: t.numpy(), st)
        self.ck_dir = str(tmp / "sharded_ckpt")
        pipe = TokenPipeline(vocab=olmo.vocab_size, seq_len=16,
                             global_batch=8, microbatches=2)
        self.batches = [pipe.next_host_batch()
                        for _ in range(ELASTIC["n_steps"])]
        self.el_dir = str(tmp / "elastic_ckpt")
        self.mixers, self.mixers_whole = {}, {}
        for i, name in enumerate(MIXER_CASES):
            kind, cfg, _ = split_cases.MODULES[name]
            p, x, kv, ct = split_cases.module_inputs(i, kind, cfg)
            self.mixers[name] = dict(kind=kind, cfg=cfg,
                                     params=split_cases.np_tree(p), x=x,
                                     kv_x=kv, ct=ct)
            self.mixers_whole[name] = split_cases.run_whole(kind, cfg, p, x,
                                                            kv, ct)
        self.gather_grads = gather_inputs()
        self.world = run_world(
            ranks.train_world, 4, backend="gloo", device="cpu", timeout=60,
            deadline=300, args=(
                {a: (self.cfg[a], self.state[a], self.host[a], OPT)
                 for a in CASES},
                (olmo, self.ck_state, self.host["olmo-1b"], OPT,
                 self.ck_dir),
                (olmo, self.state["olmo-1b"], self.batches, OPT,
                 self.el_dir, ELASTIC), self.mixers, self.gather_grads))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return Cases(tmp_path_factory.mktemp("sharded"))


# ------------------------------------------------------------ the step


@pytest.mark.parametrize("arch", sorted(CASES))
@pytest.mark.parametrize("shape", ranks.MESHES)
def test_sharded_step_matches_single_device(cases, arch, shape):
    single, sm = cases.single[arch]
    res = [w["steps"][(arch, shape)] for w in cases.world]
    for r in res:                               # equal metrics on every rank
        assert r["metrics"] == res[0]["metrics"]
    got, m = res[0]["state"], res[0]["metrics"]
    assert int(got.step) == 1 and int(got.opt.count) == 1
    for k in ("loss", "grad_norm"):
        assert rel(m[k], sm[0][k]) <= GRAD_REL, (k, m[k], sm[0][k])
    assert m["lr"] == sm[0]["lr"]
    hold_state(got, port_np_leaves(single.params),
               port_np_leaves(single.opt.m), port_np_leaves(single.opt.v),
               f"{arch} {shape}")


@pytest.mark.parametrize("arch", sorted(CASES))
@pytest.mark.parametrize("shape", ranks.MESHES)
def test_sharded_step_matches_reference(cases, arch, shape):
    js, jm = cases.ref[arch]
    r = cases.world[0]["steps"][(arch, shape)]
    for k in ("loss", "grad_norm"):
        assert rel(r["metrics"][k], jm[k]) <= GRAD_REL, k
    assert rel(r["metrics"]["lr"], jm["lr"]) <= 1e-6
    hold_state(r["state"], ref_leaves(js.params), ref_leaves(js.opt.m),
               ref_leaves(js.opt.v), f"{arch} {shape} vs reference")


def test_split_step_computes_a_quarter_over_model_4(cases):
    """Over (1, 4) rank 0's step counts at most ``SPLIT_FLOPS`` of one
    device's dot FLOPs on the same batch (``launch.op_cost``): the heads,
    the MLP columns and the vocab are split four ways, not repeated."""
    got = cases.world[0]["flops14"]
    assert 0 < got <= SPLIT_FLOPS * cases.single_flops, (
        got, cases.single_flops, got / cases.single_flops)


@pytest.mark.parametrize("name", MIXER_CASES)
def test_split_mixer_matches_whole_over_model_4(cases, name):
    """A recurrent mixer over (1, 4) against the unsplit one at the full
    width, as ``test_torch_model_split.py`` holds it over 2: output and
    input gradient on every rank, the whole parameter gradient (SPLIT
    leaves gathered, PART leaves summed) within that file's bound."""
    _, cfg, _ = split_cases.MODULES[name]
    rel = split_cases.REL if cfg.dtype == "float32" else split_cases.BF16_REL
    y, gx, grads = cases.mixers_whole[name]
    for w in cases.world:
        got = w["mixers"][name]
        split_cases.close(got["y"], y, rel)
        split_cases.close(got["gx"], gx, rel)
        for (path, a), (_, b) in zip(flatten_with_path(got["grads"]),
                                     flatten_with_path(grads)):
            assert a.shape == b.shape, path
            split_cases.close(a, b, rel)


def gather_inputs() -> dict:
    """Each rank's bf16 cotangent of every leaf of ``ranks.GATHER_LEAVES``
    as the gathered forward holds it: 1 + k/128, exact in bf16, whose sums
    over two or four ranks are exact in f32 and not in bf16."""
    rng = np.random.default_rng(24)
    out = {}
    for name in ranks.GATHER_LEAVES:
        shape = ranks.seen_by(name, ranks.leaf_value(name), (0, 0)).shape
        out[name] = [1 + rng.integers(0, 128, shape) / 128
                     for _ in range(4)]
    return out


def test_layer_gather_backward_is_the_hand_reduction(cases):
    """Over (2, 2), the stored slice of each leaf of
    ``ranks.GATHER_LEAVES`` gathered by ``stack_plan``'s plan through
    ``pspec.layer_gather`` (``transformer._index``, as ``Stack.apply``
    reads a layer): the forward is the leaf as the split reads it (SPLIT:
    the rank's model block), and the slice's f32 sink holds, exactly, the
    ranks' bf16 cotangents summed in f32 over ``data`` and, for a PART
    leaf, over ``model``, then cut to the rank's block (a WHOLE leaf's
    model block only cut)."""
    world = [w["gather"] for w in cases.world]
    coords = [tuple(w["coord"]) for w in world]
    for name, (_, _, read, _) in ranks.GATHER_LEAVES.items():
        grads = cases.gather_grads[name]
        full = ranks.leaf_value(name)
        summed = (0, 1) if read == "part" else (0,)    # data, model
        for w, c in zip(world, coords):
            assert np.array_equal(w["forward"][name],
                                  ranks.seen_by(name, full, c)), name
            tot = sum(g for g, o in zip(grads, coords)
                      if all(o[i] == c[i] for i in (0, 1)
                             if i not in summed))
            want = ranks.stored_of(name, tot, c)
            got = w["sinks"][name]
            assert got.dtype == np.float32 and got.shape == want.shape, name
            assert np.array_equal(got, want.astype(np.float32)), name


def counted_single_step(tc, state_np, host) -> float:
    """The dot FLOPs ``launch.op_cost`` counts in one single-device step."""
    from repro_torch.launch.op_cost import OpCost
    st = convert.train_state(state_np, device="cpu")
    fn = make_train_step(build_model(tc), AdamWConfig(**OPT))
    with OpCost() as cost:
        fn(st, {k: torch.from_numpy(v) for k, v in host.items()})
    return cost.totals()["dot_flops"]


@pytest.mark.parametrize("shape", ranks.MESHES)
def test_make_global_batch_slices(cases, shape):
    """Each rank holds rows ``d * mb/D .. (d+1) * mb/D`` of every
    microbatch, d its data coordinate; ranks of one model group hold the
    same rows."""
    host = cases.host["olmo-1b"]
    D = shape[0]
    for w in cases.world:
        r = w["steps"][("olmo-1b", shape)]
        d = r["coord"][0]
        n = host["tokens"].shape[1] // D
        for k, v in host.items():
            assert np.array_equal(r["local"][k], v[:, d * n:(d + 1) * n]), k


# ------------------------------------------------------------ checkpoints

def test_sharded_checkpoint_restores_in_reference_bit_for_bit(cases):
    """The (2, 2) ranks' save, gathered and written by rank 0 alone, read
    by the reference's ``Checkpointer.restore``: every leaf equal bit for
    bit, bf16 and int leaves included."""
    jc, _ = cfg_pair("olmo-1b")
    target = jinit(jbuild(jc), jax.random.PRNGKey(1))
    back = JCheckpointer(cases.ck_dir).restore(7, target)
    mine = [np.asarray(a) for a in jax.tree.leaves(back)]
    want = _np_flat(cases.ck_state)
    assert len(mine) == len(want)
    for a, b in zip(mine, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _np_flat(tree):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append(np.asarray(node))
    walk(tree)
    return out


def test_sharded_checkpoint_reshards_onto_another_mesh(cases):
    """Restored onto (4, 1), each rank holds exactly its block of every
    saved leaf: rows ``d * n .. (d + 1) * n`` of each dimension sharded
    over ``data`` (the model axis has one rank)."""
    from repro_torch.train.sharding import make_state_shardings
    specs = make_state_shardings(_FakeMesh({"data": 4, "model": 1}),
                                 cases.ck_state).specs
    flat_specs = []
    tree_map(lambda a, s: flat_specs.append(s), cases.ck_state, specs)
    saved = []
    tree_map(lambda a: saved.append(np.asarray(a)), cases.ck_state)
    for w in cases.world:
        d = w["ckpt"]["coord41"][0]
        got = []
        tree_map(lambda a: got.append(np.asarray(a)), w["ckpt"]["slices"])
        assert len(got) == len(saved)
        for a, full, spec in zip(got, saved, flat_specs):
            want = full
            for dim, e in enumerate(spec):
                if e == "data":
                    n = full.shape[dim] // 4
                    want = np.take(want, range(d * n, (d + 1) * n), axis=dim)
            assert a.dtype == want.dtype and np.array_equal(a, want)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


# ------------------------------------------------------------ elastic

def test_elastic_restart_from_four_ranks_to_two(cases):
    """A failure of 2 ranks at step 3 of 6, checkpoints every 2 steps: the
    first 2 ranks restore step 2 onto (1, 2) and finish; the others leave.
    The report is the reference test's; the restored state equals the
    committed checkpoint bit for bit; every loss, replayed steps included,
    matches an uninterrupted single-device run within ``GRAD_REL``; the
    survivors' final state holds to ``hold_state``'s rule against the
    port's single device stepping from the committed checkpoint (the steps
    before the failure ran over (2, 2), whose reordered gradient means an
    uninterrupted run would carry into the comparison)."""
    el = [w["elastic"] for w in cases.world]
    for r, rep in enumerate(el):
        assert rep["restarts"] == 1 and rep["reshards"] == 1
        assert (rep["final"] is not None) == (r < 2)
    for rep in el[:2]:
        assert rep["steps_done"] == ELASTIC["n_steps"]
        assert np.isfinite(rep["losses"]).all()
    # losses: steps 0-2, then 2-5 again from the step-2 checkpoint
    _, ms = one_thread_step(cases.cfg["olmo-1b"], cases.state["olmo-1b"],
                            cases.batches, n=ELASTIC["n_steps"])
    want = [m["loss"] for m in ms]
    order = [0, 1, 2, 2, 3, 4, 5]
    assert len(el[0]["losses"]) == len(order)
    for got, k in zip(el[0]["losses"], order):
        assert rel(got, want[k]) <= GRAD_REL, (k, got, want[k])
    # the restore: step 2 as committed
    (step, restored), = el[0]["restored"]
    assert step == 2
    committed = convert.train_state(
        port_state_from_dir(cases.el_dir, 2, cases.state["olmo-1b"]),
        device="cpu")
    for a, b in zip(_np_flat(restored), _np_flat(
            tree_map(lambda t: t.numpy(), committed))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the steps after the restart: one device from the committed step 2
    replay, rms = one_thread_step(
        cases.cfg["olmo-1b"],
        port_state_from_dir(cases.el_dir, 2, cases.state["olmo-1b"]),
        cases.batches[2:], n=ELASTIC["n_steps"] - 2)
    for got, m in zip(el[0]["losses"][ELASTIC["fail_at"]:], rms):
        assert rel(got, m["loss"]) <= GRAD_REL
    hold_state(el[0]["final"], port_np_leaves(replay.params),
               port_np_leaves(replay.opt.m), port_np_leaves(replay.opt.v),
               "elastic")


def port_state_from_dir(directory, step, like):
    """Step ``step`` of a checkpoint directory, read by the port's
    unsharded ``restore`` into numpy leaves shaped like ``like``."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    target = convert.train_state(like, device="cpu")
    back = Checkpointer(directory).restore(step, target)
    return tree_map(lambda t: t.numpy(), back)


# ------------------------------------------------------------ launcher

def test_sharded_launcher_matches_single_device_launcher():
    """``python -m repro_torch.launch.train --reduced --devices 4 --mesh
    2x2 --device cpu`` logs the single-device launcher's losses and norms
    within ``GRAD_REL`` and its learning rates exactly."""
    argv = ["--arch", "olmo-1b", "--reduced", "--steps", "3", "--seq-len",
            "16", "--log-every", "1", "--device", "cpu"]
    one = tlaunch.main(argv)
    four = tlaunch.main(argv + ["--devices", "4", "--mesh", "2x2"])
    assert one["params"] == four["params"]
    assert [s for s, _ in four["log"]] == [1, 2, 3]
    for (s1, a), (s4, b) in zip(one["log"], four["log"]):
        assert s1 == s4
        for k in ("loss", "grad_norm"):
            assert rel(b[k], a[k]) <= GRAD_REL, (s1, k)
        assert b["lr"] == a["lr"]
