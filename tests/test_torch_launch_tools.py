"""The port's launch tools against the reference's (``repro.launch``):
``roofline``, ``op_cost`` (the counterpart of ``hlo_cost``), ``dryrun``,
``summarize`` and ``sweep``.

FLOPs are held against ``analyze_hlo`` of the jitted reference exactly; a
fake trace is held against a real CPU run of the same program exactly (its
counts and tracked peak).  The reference's ``dryrun`` module sets
``XLA_FLAGS`` when imported, so it is imported inside the tests that need
it, after JAX has started, and the flag is put back."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import SHAPES as JSHAPES
from repro.launch import roofline as jroof
from repro.launch.hlo_cost import analyze_hlo
from repro.models.model_zoo import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train.step import init_train_state as jinit
from repro.train.step import make_train_step as jstep
from repro_torch.configs.registry import ARCHS, SHAPES, live_cells
from repro_torch.launch import dryrun, op_cost, roofline, summarize, sweep
from repro_torch.launch.mesh import run_world
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

import torch_sharded_ranks as ranks

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def ref_dryrun():
    """``repro.launch.dryrun``, imported without leaving its XLA flag."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


class FakeMesh:
    """The reference test's mesh stand-in (shape and axis names only)."""

    def __init__(self, multi_pod=False):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


# ------------------------------------------------------------ roofline

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_reference(arch):
    assert roofline.param_counts(arch) == jroof.param_counts(arch)


def test_model_flops_per_device_match_reference():
    for arch, shape in live_cells():
        for chips in (256, 512):
            assert roofline.model_flops_per_device(arch, shape, chips) == \
                jroof.model_flops_per_device(arch, shape, chips), \
                (arch, shape, chips)


def _record(arch="olmo-1b", shape="train_4k", multi_pod=False, **kw):
    c = {"dot_flops": 3.1e15, "vector_flops": 2.0e12, "hbm_bytes": 4.2e12,
         "hbm_bytes_upper": 9.9e12, "coll_total_bytes": 7.2e9}
    c.update(kw)
    mesh = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
            "mesh": mesh, "tag": "", "lower_s": 1.5, "compile_s": 1.5,
            "memory": {"argument_size_in_bytes": 6e9,
                       "temp_size_in_bytes": 90e9},
            "collectives": {"total_bytes": c["coll_total_bytes"]},
            "corrected": c}


def test_analyze_cell_and_tp_scaling_match_reference_at_its_constants():
    consts = dict(peak_flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW,
                  link_bw=jroof.LINK_BW)
    for rec in (_record(), _record("mixtral-8x22b", "decode_32k", True,
                                   hbm_bytes=9e13),
                _record("mamba2-780m", "prefill_32k",
                        coll_total_bytes=5e15)):
        assert roofline.analyze_cell(rec, **consts) == \
            jroof.analyze_cell(rec)
    for m, k, n, s in ((16, 2048, 8192, 2), (4096, 1024, 4096, 8)):
        assert roofline.predict_tp_scaling(m, k, n, s, **consts) == \
            jroof.predict_tp_scaling(m, k, n, s)


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


# ------------------------------------------------------------ op_cost

def test_op_cost_counts_every_loop_iteration():
    """The reference's scan of 10 products, as a Python loop: eager
    dispatch runs every iteration, so nothing needs a trip count."""
    x = torch.randn(128, 128)
    with op_cost.OpCost() as cost:
        c = x
        for _ in range(10):
            c = torch.tanh(c @ x)
    assert cost.totals()["dot_flops"] == 2 * 128 ** 3 * 10


def test_op_cost_nested_loops():
    x = torch.randn(64, 64)
    with op_cost.OpCost() as cost:
        c = x
        for _ in range(5):
            for _ in range(3):
                c = c @ x
    assert cost.totals()["dot_flops"] == 2 * 64 ** 3 * 15


def test_op_cost_counts_vector_and_bytes():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with op_cost.OpCost() as cost:
        torch.tanh(a) + b
    t = cost.totals()
    assert t["dot_flops"] == 0
    assert t["vector_flops"] >= 256 * 256
    # elementwise work has no compulsory traffic, but the upper model sees
    # the 2 reads and 1 write
    assert t["hbm_bytes_upper"] >= 3 * 256 * 256 * 4
    assert t["hbm_bytes"] <= t["hbm_bytes_upper"]


def _jax_dot_flops(fn, *shapes) -> float:
    return analyze_hlo(jax.jit(fn).lower(*shapes).compile().as_text())[
        "dot_flops"]


def _sds(shape, dtype=jnp.int32):
    return jax.ShapeDtypeStruct(shape, dtype)


@pytest.mark.parametrize("arch,want", [("olmo-1b", 12_582_912),
                                       ("h2o-danube-3-4b", 12_582_912)])
def test_forward_dot_flops_equal_analyze_hlo(arch, want):
    """A reduced forward at B 2, S 32: op_cost on a fake trace of the port
    against analyze_hlo of the jitted reference."""
    jm = jbuild(JARCHS[arch].reduced())
    pshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    ref = _jax_dot_flops(lambda p, b: jm.forward(p, b)[0], pshapes,
                         {"tokens": _sds((2, 32))})
    model = build_model(ARCHS[arch].reduced())
    with FakeTensorMode():
        params = model.init(torch.Generator(), device="cpu")
        batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32)}
        with op_cost.OpCost() as cost:
            model.forward(params, batch)
    t = cost.totals()
    assert t["dot_flops"] == ref == want


def test_train_step_dot_flops_equal_analyze_hlo():
    """A reduced olmo-1b ``make_train_step`` with remat at M 2, mb 2, S 32:
    forward, remat recompute, backward."""
    jm = jbuild(JARCHS["olmo-1b"].reduced())
    sshapes = jax.eval_shape(lambda k: jinit(jm, k), jax.random.PRNGKey(0))
    batch = {"tokens": _sds((2, 2, 32)), "labels": _sds((2, 2, 32))}
    ref = _jax_dot_flops(jstep(jm, JAdamW()), sshapes, batch)
    cfg = ARCHS["olmo-1b"].reduced()
    assert cfg.remat
    model = build_model(cfg)
    with FakeTensorMode():
        state = init_train_state(model, torch.Generator(), device="cpu")
        tb = {k: torch.zeros((2, 2, 32), dtype=torch.int32)
              for k in ("tokens", "labels")}
        with op_cost.OpCost() as cost:
            make_train_step(model, AdamWConfig())(state, tb)
    t = cost.totals()
    assert t["dot_flops"] == ref == 75_497_472


def test_dslot_call_is_one_opaque_op():
    """On CPU tensors the kernel's plain version runs in its place, and its
    products are not counted: one launch, its operand and output bytes."""
    from repro_torch.kernels.ops import dslot_execute, dslot_prepare

    g = torch.Generator().manual_seed(0)
    w = torch.randn((64, 48), generator=g)
    x = torch.randn((32, 64), generator=g)
    prep = dslot_prepare(w, block_m=16, block_n=16)
    with op_cost.OpCost() as cost:
        out, _ = dslot_execute(prep, x)
    t = cost.totals()
    assert t["dslot_launches"] == 1 and t["dot_flops"] == 0
    assert t["hbm_bytes"] >= 32 * 64 + 64 * 48 * 4 + 32 * 48 * 4
    want, _ = dslot_execute(prep, x)
    assert torch.equal(out, want)


def test_sharded_step_collectives_follow_the_bucket_plan():
    """In a gloo world of 2 over a (2, 1) mesh, reduced olmo-1b at 4 layers
    in two remat groups: one all_gather per bucket of the leaves outside
    the layer stacks sharded over data and two per group of each stack
    leaf (forward and recompute), one reduce-scatter per group of each
    stack leaf's gradient, one all_reduce per bucket of the other
    gradients and one of the norm, each of the bytes the plan says
    (``ranks.counted_step``)."""
    cfg = dataclasses.replace(ARCHS["olmo-1b"].reduced(), n_layers=4,
                              scan_unroll=2)
    assert cfg.remat
    world = run_world(ranks.counted_step, 2, backend="gloo", device="cpu",
                      timeout=60, deadline=180, args=(cfg,))
    for r in world:
        for kind, sizes in r["plan"].items():
            assert r["counts"][kind] == len(sizes) > 0, kind
            assert r["bytes"][kind] == sum(sizes), kind
        assert sum(r["counts"].values()) == sum(
            len(v) for v in r["plan"].values())


# ------------------------------------------------------------ dryrun

@pytest.mark.parametrize("multi_pod", [False, True])
def test_input_specs_and_microbatches_match_reference(multi_pod):
    jdry = ref_dryrun()
    mesh = FakeMesh(multi_pod)
    for arch, shape in live_cells():
        a, s = ARCHS[arch], SHAPES[shape]
        ja, js = JARCHS[arch], JSHAPES[shape]
        assert dryrun.microbatches_for(a, s, mesh) == \
            jdry.microbatches_for(ja, js, mesh)
        got = dryrun.input_specs(a, s, mesh)
        want = jdry.input_specs(ja, js, mesh)
        assert sorted(got) == sorted(want), (arch, shape)
        for k, v in want.items():
            assert got[k].shape == v.shape, (arch, shape, k)
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k


_CORE = {"k": 4, "v": 4, "ssm": 4, "conv": 3, "h": 2}   # dims a spec names


def _spec_suffixes(flat) -> dict:
    """{state field: the set of its specs' last ``_CORE`` entries}: the
    reference stacks layers (a leading replicated dimension), the port
    keeps a list."""
    out = {}
    for path, spec in flat:
        field = path.rsplit("/", 1)[-1].lstrip(".")
        n = _CORE.get(field, 0)
        out.setdefault(field, set()).add(tuple(spec)[-n:] if n else
                                         tuple(spec))
    return out


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m",
                                  "recurrentgemma-2b", "seamless-m4t-medium"])
def test_decode_state_shardings_match_reference(arch):
    from jax.sharding import AbstractMesh

    from repro_torch.tree import flatten_with_path, tree_map

    jdry = ref_dryrun()
    shape = SHAPES["decode_32k"]
    for multi_pod in (False, True):
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        jm = jbuild(JARCHS[arch])
        enc = JARCHS[arch].frontend_len \
            if JARCHS[arch].family == "encdec" else 0
        jstate = jax.eval_shape(lambda: jm.init_decode_state(
            shape.global_batch, shape.seq_len, enc))
        jspecs = jdry.decode_state_shardings(AbstractMesh(sizes, names),
                                             jstate)
        want = _spec_suffixes(
            (jax.tree_util.keystr(p, simple=True, separator="/"),
             tuple(s.spec))
            for p, s in jax.tree_util.tree_flatten_with_path(jspecs)[0])
        with FakeTensorMode():
            state = build_model(ARCHS[arch]).init_decode_state(
                shape.global_batch, shape.seq_len, enc, device="cpu")
        specs = []
        tree_map(lambda t, s: specs.append(s), state,
                 dryrun.decode_state_shardings(FakeMesh(multi_pod), state))
        got = _spec_suffixes((path, spec) for (path, _), spec in
                             zip(flatten_with_path(state), specs))
        assert got == want, (arch, multi_pod)


_WORLD = """
import json, sys
import torch
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import pspec

out = {}
dryrun.start_world(4)
mesh = make_test_mesh(model=2)
pspec.set_mesh(mesh)
for shape in ("train_4k", "decode_32k"):
    s = get_shape(shape).reduced()
    for arch in ("olmo-1b", "mamba2-780m"):
        a = get_arch(arch).reduced()
        out[f"{arch} {shape}"] = [dryrun.trace_cell(a, s, mesh, fake=f)
                                  for f in (True, False)]
# reduced olmo-1b at 4 layers in four remat groups: the stacks' leaves
# gathered at use, one group at a time
import dataclasses
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.models.model_zoo import build_model
from repro_torch.train.sharding import (_spec_axes, gather_specs,
                                        make_param_shardings, model_reads)
from repro_torch.tree import leaves, tree_map
g = dataclasses.replace(get_arch("olmo-1b").reduced(), n_layers=4,
                        scan_unroll=1)
s = get_shape("train_4k").reduced()
out["grouped"] = [dryrun.trace_cell(g, s, mesh, fake=f)
                  for f in (True, False)]
with FakeTensorMode():
    params = build_model(g).init(torch.Generator(), device="cpu")
specs = make_param_shardings(mesh, params)
gspecs = gather_specs(specs, model_reads(mesh, g, params), mesh)


def model_cut(sp):
    return any("model" in _spec_axes(e) for e in sp)


sizes = []   # a leaf the split reads as its model slice: half of it
tree_map(lambda t, sp, gs: sizes.append(t.numel() * t.element_size() // (
    2 if model_cut(sp) and not model_cut(gs) else 1)), params, specs, gspecs)
out["grouped_whole"] = sum(sizes)
pspec.set_mesh(None)
# a step of 4 microbatches traced at 1 and 2 and extrapolated, against the
# whole step run
a = get_arch("olmo-1b").reduced()
s = ShapeConfig("t", "train", 32, 8, microbatches=2)
ext = dryrun.trace_cell(a, s, None, fake=False)
specs = dryrun.input_specs(a, s, None)
from repro_torch.models.model_zoo import build_model
whole = dryrun._train_run(build_model(a), None, specs, 8, 4)
out["extrapolated"] = [ext, whole]
print(json.dumps(out))
"""


def test_fake_trace_counts_what_a_cpu_run_does():
    """In its own process, a fake world of 4 ranks over a (2, 2) mesh: the
    fake trace and a real CPU run of rank 0's program give equal op_cost
    totals and equal tracked peaks, for a train step (also of a model in
    four remat groups, whose step gathers one group of a quarter of the
    stacks' gathered bytes at a time and reduce-scatters the gradients)
    and a decode step; and a 4-microbatch step traced at 1 and 2 and
    extrapolated equals the whole step.  Over the model axis of 2 the
    decode state splits: olmo's KV rings, and mamba2's SSM states by head,
    their conv tails' whole B/C channels counted apart."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _WORLD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    ext, whole = res.pop("extrapolated")
    stacks = res.pop("grouped_whole")
    grouped = res["grouped"][0]
    parts = grouped["peak_breakdown"]
    assert 4 * parts["group_gathered"] == stacks - parts["outside_gathered"]
    assert parts["grad_slices_f32"] > 0 and parts["leaf_grad"] > 0
    assert grouped["collectives"]["counts"]["reduce-scatter"] > 0
    for name, (fake, real) in res.items():
        assert fake["corrected"] == real["corrected"], name
        assert fake["memory"] == real["memory"], name
        assert fake["corrected"]["dot_flops"] > 0, name
    assert ext["microbatches"] == 4 and ext["microbatches_traced"] == [1, 2]
    assert ext["corrected"] == whole["totals"]
    assert ext["memory"]["argument_size_in_bytes"] == whole["argument"]
    assert ext["memory"]["argument_size_in_bytes"] + \
        ext["memory"]["temp_size_in_bytes"] == whole["peak"]
    mam = res["mamba2-780m decode_32k"][0]
    assert mam["state_split_over_model"], "the SSM states split by head"
    assert not mam["state_whole_over_model"]
    assert 0 < mam["state_bc_tail_bytes"] < \
        mam["state_split_over_model_bytes"]
    olmo = res["olmo-1b decode_32k"][0]
    assert olmo["state_split_over_model"], "the KV rings split over model"
    assert not olmo["state_whole_over_model"]


# ------------------------------------------------------------ summarize, sweep

def test_roofline_and_summarize_render_records(tmp_path, capsys):
    for rec in (_record(), _record("olmo-1b", "decode_32k"),
                _record("olmo-1b", "train_4k", True)):
        name = f"{rec['arch']}__{rec['shape']}__" \
            f"{'multi' if rec['multi_pod'] else 'single'}.json"
        (tmp_path / name).write_text(json.dumps(rec))
    md = tmp_path / "roofline.md"
    roofline.main(["--dir", str(tmp_path), "--md", str(md)])
    text = md.read_text()
    assert "| olmo-1b | train_4k |" in text and "decode_32k" in text
    assert "Per-cell bottleneck notes" in text
    capsys.readouterr()
    summarize.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("| olmo-1b")]
    assert len(rows) == 3
    assert all("| NO (96.0) |" in ln for ln in rows)    # 96 GB > 80 GB


def test_sweep_skips_cells_whose_record_exists(tmp_path, monkeypatch):
    cells = live_cells()
    for arch, shape in cells[1:]:
        (tmp_path / f"{arch}__{shape}__single.json").write_text("{}")
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "")

    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    sweep.main(["--out", str(tmp_path), "--meshes", "single"])
    assert len(ran) == 1
    arch, shape = cells[0]
    assert ran[0][ran[0].index("--arch") + 1] == arch
    assert ran[0][ran[0].index("--shape") + 1] == shape
    assert "--multi-pod" not in ran[0]


def test_sweep_keeps_the_cells_of_the_named_shapes_and_archs(tmp_path,
                                                           monkeypatch):
    ran = []

    def fake_run(cmd, **kw):
        ran.append((cmd[cmd.index("--arch") + 1],
                    cmd[cmd.index("--shape") + 1], "--multi-pod" in cmd))
        return subprocess.CompletedProcess(cmd, 1, "", "")

    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    archs = ("mamba2-780m", "recurrentgemma-2b")
    sweep.main(["--out", str(tmp_path), "--archs", ",".join(archs),
                "--shapes", "train_4k,long_500k"])
    want = {(a, s, m) for a, s in live_cells() if a in archs
            and s in ("train_4k", "long_500k") for m in (False, True)}
    assert len(ran) == len(want) == 8 and set(ran) == want
