"""Port parity for the paper-level simulators (``repro_torch.core``):
quantize, SD digits, the online multiplier and adder, the PE, Algorithm 1,
the SIP baseline, the Table-I cycle model and CSD.

Each function gets the same seeded numpy inputs in both packages.  Integer
results (digits, cycle counts, SOPs, CSD planes and counts) must be equal,
with the same dtypes; float results of these modules are exact dyadic
values, so they must be equal too (only a mean over fractions is held to
f32 rounding); the cycle model is pure Python floats
and must match to 1e-12.  The second half mirrors the properties of
``tests/test_online.py``, ``test_pe.py``, ``test_digits.py``,
``test_early_term.py``, ``test_cycle_model.py`` and ``test_csd.py`` on the
port, as parametrised cases.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

import repro.core as J
import repro_torch.core as T
from repro.core import cycle_model as jcm
from repro.core import early_term as jet
from repro_torch.core import cycle_model as tcm
from repro_torch.core import early_term as tet

TORCH_DTYPE = {"bool": torch.bool, "int8": torch.int8, "int32": torch.int32,
               "float32": torch.float32}


def assert_same(port, ref, what=""):
    """Port tensor equal to the reference array, dtype included."""
    ref = np.asarray(ref)
    assert port.dtype == TORCH_DTYPE[ref.dtype.name], (what, port.dtype,
                                                        ref.dtype)
    np.testing.assert_array_equal(port.numpy(), ref, err_msg=what)


def t(a):
    return torch.as_tensor(np.array(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def test_core_exports_reference_all():
    assert sorted(T.__all__) == sorted(J.__all__)
    for name in T.__all__:
        assert hasattr(T, name), name


# ------------------------------------------------------------ quantize

@pytest.mark.parametrize("kind,n_bits,scale", [
    ("signed", 8, None), ("signed", 4, None), ("signed", 8, 0.75),
    ("unsigned", 8, None), ("unsigned", 6, 2.0)])
def test_quantize_matches_reference(kind, n_bits, scale):
    rng = np.random.default_rng(n_bits)
    x = rng.normal(size=(6, 33)).astype(np.float32)
    if kind == "unsigned":
        x = np.abs(x)
    # ties at exact halves exercise round-half-to-even in both packages
    x[0, :4] = np.array([0.5, 1.5, -2.5, 3.5], np.float32) / 7 * x.max()
    fj, ft = ((J.quantize, T.quantize) if kind == "signed"
              else (J.quantize_unsigned, T.quantize_unsigned))
    rq, tq = fj(j(x), n_bits, scale), ft(t(x), n_bits, scale)
    assert tq.n_bits == rq.n_bits
    assert_same(tq.q, rq.q, "q")
    assert_same(tq.scale, rq.scale, "scale")
    assert_same(tq.frac, rq.frac, "frac")
    assert_same(T.dequantize(tq), J.dequantize(rq), "value")


# ------------------------------------------------------------ digits

def _digit_cases():
    rng = np.random.default_rng(11)
    q = rng.integers(-255, 256, size=(3, 40))
    digits = rng.integers(-1, 2, size=(12, 5, 7)).astype(np.int8)
    vals = (rng.integers(-4095, 4096, size=(50,)) / 4096.0).astype(np.float32)
    off = rng.uniform(-0.99, 0.99, size=(50,)).astype(np.float32)
    bits = rng.integers(0, 2, size=(8, 9))
    return {
        "fixed_to_sd": (lambda m: m.fixed_to_sd, (q, 9)),
        "sd_from_value_grid": (lambda m: m.sd_from_value, (vals, 12)),
        "sd_from_value_offgrid": (lambda m: m.sd_from_value, (off, 10)),
        "sd_to_value": (lambda m: m.sd_to_value, (digits,)),
        "sd_prefix_values": (lambda m: m.sd_prefix_values, (digits,)),
        "sd_split_posneg": (lambda m: m.sd_split_posneg, (digits,)),
        "sd_from_bits_lsb": (lambda m: m.digits.sd_from_bits_lsb, (bits,)),
        "first_negative_prefix": (lambda m: m.first_negative_prefix,
                                  (digits,)),
    }


@pytest.mark.parametrize("name", list(_digit_cases()))
def test_digits_match_reference(name):
    get, args = _digit_cases()[name]
    targs = [t(a) if isinstance(a, np.ndarray) else a for a in args]
    jargs = [j(a) if isinstance(a, np.ndarray) else a for a in args]
    out, ref = get(T)(*targs), get(J)(*jargs)
    if isinstance(ref, tuple):
        for o, r in zip(out, ref):
            assert_same(o, r, name)
    else:
        assert_same(out, ref, name)


# ------------------------------------------------------------ online

@pytest.mark.parametrize("case", ["mult", "mult_broadcast", "add",
                                  "add_unequal", "tree_odd", "tree_pow2",
                                  "emit_short"])
def test_online_matches_reference(case):
    rng = np.random.default_rng(5)
    xq = rng.integers(0, 256, size=(24,))
    xd = np.asarray(J.fixed_to_sd(j(xq), 9))
    if case == "mult":
        y = (rng.integers(-255, 256, size=(24,)) / 512.0).astype(np.float32)
        out = T.online_mult_sp(t(xd), t(y), n_out=18)
        ref = J.online_mult_sp(j(xd), j(y), n_out=18)
    elif case == "mult_broadcast":
        xd4 = np.asarray(J.fixed_to_sd(j(rng.integers(0, 128, (25, 1, 6))),
                                       8))
        y = (rng.integers(-127, 128, size=(25, 4, 1)) / 256.0).astype(
            np.float32)
        out = T.online_mult_sp(t(xd4), t(y), n_out=16, delta=3)
        ref = J.online_mult_sp(j(xd4), j(y), n_out=16, delta=3)
    elif case in ("add", "add_unequal"):
        a = np.asarray(J.fixed_to_sd(j(rng.integers(-16000, 16000, 30)), 16))
        nb = 16 if case == "add" else 11
        b = np.asarray(J.fixed_to_sd(j(rng.integers(-1000, 1000, 30)), nb))
        out = T.online_add(t(a), t(b), n_out=17)
        ref = J.online_add(j(a), j(b), n_out=17)
    elif case.startswith("tree"):
        n_terms = 25 if case == "tree_odd" else 8
        terms = rng.integers(-12000, 12000, size=(n_terms, 10))
        streams = np.stack([np.asarray(J.fixed_to_sd(j(r), 16))
                            for r in terms])
        out, s_t = T.online_add_tree(t(streams), n_out=21)
        ref, s_j = J.online_add_tree(j(streams), n_out=21)
        assert s_t == s_j
    else:   # a stream shorter than n_out + delta is zero-padded
        u = (rng.integers(-3, 4, size=(5, 7)) / 4.0).astype(np.float32)
        out = T.online_emit(t(u), n_out=9, delta=2)
        ref = J.online_emit(j(u), n_out=9, delta=2)
    assert_same(out, ref, case)


def test_online_emit_too_long_raises():
    with pytest.raises(ValueError, match="longer"):
        T.online_emit(torch.zeros((12, 3)), n_out=8, delta=2)


# ------------------------------------------------------------ pe

@pytest.mark.parametrize("k,n_fmaps,p_mult", [(5, 1, 16), (3, 1, 16),
                                              (5, 4, 16), (7, 1, 12),
                                              (1, 1, 8)])
def test_pe_schedule_matches_reference(k, n_fmaps, p_mult):
    s_t = T.pe_schedule(k=k, n_fmaps=n_fmaps, p_mult=p_mult)
    s_j = J.pe_schedule(k=k, n_fmaps=n_fmaps, p_mult=p_mult)
    assert tuple(s_t) == tuple(s_j)
    assert T.pe_output_scale(s_t) == J.pe_output_scale(s_j)
    assert s_t.cycle_of_digit(3) == s_j.cycle_of_digit(3)


@pytest.mark.parametrize("k,wmean", [(3, 0), (5, -40)])
def test_pe_sop_digits_match_reference(k, wmean):
    rng = np.random.default_rng(k)
    sch = J.pe_schedule(k=k, p_mult=16)
    xq = rng.integers(0, 128, size=(k * k, 20))
    wq = np.clip(rng.integers(-127, 128, size=(k * k,)) + wmean, -127, 127)
    xd = np.asarray(J.fixed_to_sd(j(xq), 8))
    wf = (wq / 256.0).astype(np.float32)[:, None]
    out = T.pe_sop_digits(t(xd), t(wf), T.pe_schedule(k=k, p_mult=16))
    assert_same(out, J.pe_sop_digits(j(xd), j(wf), sch))


def test_pe_tree_deeper_than_schedule_raises():
    sch = T.pe_schedule(k=2, p_mult=8)          # 2 stages for 4 taps
    xd = T.fixed_to_sd(torch.zeros((9, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="tree deeper"):
        T.pe_sop_digits(xd, torch.zeros((9, 1)), sch)


# ------------------------------------------------------------ early_term

@pytest.mark.parametrize("wlo,whi", [(-127, 32), (-127, -32), (16, 127)])
def test_early_termination_matches_reference(wlo, whi):
    # SOP streams from the port's PE (equal to the reference's, above)
    rng = np.random.default_rng(abs(whi))
    xq = rng.integers(0, 128, size=(25, 64))
    wq = rng.integers(wlo, whi, size=(25,))
    sch = J.pe_schedule(k=5, p_mult=16)
    sop = T.pe_sop_digits(T.fixed_to_sd(t(xq), 8), torch.as_tensor(
        wq / 256.0, dtype=torch.float32)[:, None],
        T.pe_schedule(k=5, p_mult=16)).numpy()
    rt = T.early_termination(t(sop), T.pe_schedule(k=5, p_mult=16))
    rj = J.early_termination(j(sop), sch)
    assert rt.cycles_full == rj.cycles_full
    for field in ("is_negative", "term_digit", "cycles_used", "cycles_saved",
                  "savings_frac"):
        assert_same(getattr(rt, field), getattr(rj, field), field)
    # the rate is a count over N (exact); the mean saving sums fractions
    # of 1/cycles_full in another order, so it agrees to f32 rounding
    assert_same(rt.negative_rate, rj.negative_rate, "negative_rate")
    np.testing.assert_allclose(float(rt.mean_savings), float(rj.mean_savings),
                               rtol=1e-6)
    assert_same(tet.prefix_sign_trace(t(sop)), jet.prefix_sign_trace(j(sop)))


# ------------------------------------------------------------ sip

@pytest.mark.parametrize("n_bits,shape", [(8, (25, 40)), (6, (9, 3, 11))])
def test_sip_matches_reference(n_bits, shape):
    rng = np.random.default_rng(n_bits)
    xq = rng.integers(0, 2 ** n_bits, size=shape).astype(np.int32)
    wq = rng.integers(-127, 128, size=shape[:1] + (1,) * (len(shape) - 1)
                      ).astype(np.int32)
    assert_same(T.sip_sop(t(xq), t(wq), n_bits), J.sip_sop(j(xq), j(wq),
                                                             n_bits))
    assert_same(T.sip_sop_trace(t(xq), t(wq), n_bits),
                J.sip_sop_trace(j(xq), j(wq), n_bits))
    assert tuple(T.sip_schedule(5, n_bits)) == tuple(J.sip_schedule(5,
                                                                     n_bits))


# ------------------------------------------------------------ cycle model

@pytest.mark.parametrize("p_mult,n_bits,k", [(16, 8, 5), (12, 6, 3),
                                             (20, 10, 7)])
def test_cycle_model_matches_reference(p_mult, n_bits, k):
    assert tcm.TABLE1_PUBLISHED == jcm.TABLE1_PUBLISHED
    for fn in ("t_sip", "t_dslot"):
        assert abs(getattr(tcm, fn)(k) - getattr(jcm, fn)(k)) <= 1e-12
    for fn in ("t_olm", "t_ola"):
        assert abs(getattr(tcm, fn)() - getattr(jcm, fn)()) <= 1e-12
    mt, mj = (T.table1_model(p_mult, n_bits, k),
              J.table1_model(p_mult, n_bits, k))
    assert set(mt) == set(mj)
    for name in mj:
        for a, b in ((mt[name], mj[name]),
                     (mt[name].with_early_termination(0.06),
                      mj[name].with_early_termination(0.06))):
            assert a.name == b.name and a.luts == b.luts
            for f in ("cpd_ns", "dynamic_power_mw", "init_interval_cycles",
                      "ops_per_window", "gops", "gops_per_watt"):
                assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12, (name, f)
            assert abs(a.energy_per_window_nj()
                       - b.energy_per_window_nj()) <= 1e-12


# ------------------------------------------------------------ csd

@pytest.mark.parametrize("n_bits", [2, 5, 8])
def test_csd_matches_reference(n_bits):
    rng = np.random.default_rng(n_bits)
    lim = 2 ** n_bits - 1
    q = rng.integers(-lim, lim + 1, size=(12, 20)).astype(np.int32)
    w_q = rng.integers(-127, 128, size=(20, 6)).astype(np.int32)
    planes = T.csd_recode(t(q), n_bits)
    assert_same(planes, J.csd_recode(j(q), n_bits), "planes")
    assert_same(T.essential_digit_count(planes),
                J.essential_digit_count(j(planes.numpy())), "essential")
    assert_same(T.binary_digit_count(t(q), n_bits),
                J.binary_digit_count(j(q), n_bits), "binary")
    assert_same(T.csd_planes_nonzero(planes),
                J.csd_planes_nonzero(j(planes.numpy())), "nonzero planes")
    out, nz = T.csd_matmul(t(q), t(w_q), n_bits)
    ref, rnz = J.csd_matmul(j(q), j(w_q), n_bits)
    assert_same(out, ref, "csd_matmul")
    assert_same(nz, rnz, "csd_matmul planes")


# ------------------------------------------------------------ properties
# The reference's property tests, run on the port.

def test_olm_bit_exact_batch():
    rng = np.random.default_rng(0)
    xq = rng.integers(0, 256, size=(256,))
    wq = rng.integers(-255, 256, size=(256,))
    z = T.online_mult_sp(T.fixed_to_sd(t(xq), 9),
                         torch.as_tensor(wq / 512.0, dtype=torch.float32),
                         n_out=18)
    got = T.sd_to_value(z).double().numpy() * 2.0 ** 18
    np.testing.assert_array_equal(got, xq * wq)
    assert set(np.unique(z.numpy())) <= {-1, 0, 1}


@pytest.mark.parametrize("xq,wq", [(0, 0), (127, 127), (127, -127),
                                   (97, -113), (1, -1), (64, 3), (5, -128 + 1),
                                   (100, 0)])
def test_olm_property_and_msdf_prefix(xq, wq):
    """Exact product, and MSDF: the prefix after j digits is within 2^-j of
    the result (the basis of early sign detection)."""
    z = T.online_mult_sp(T.fixed_to_sd(torch.tensor([xq]), 8),
                         torch.tensor(wq / 256.0), n_out=16)
    assert float(T.sd_to_value(z)[0]) * 2 ** 16 == xq * wq
    true, prefix = xq * wq / 2.0 ** 16, 0.0
    for jj in range(16):
        prefix += float(z[jj, 0]) * 2.0 ** -(jj + 1)
        assert abs(prefix - true) <= 2.0 ** -(jj + 1) + 1e-9


@pytest.mark.parametrize("aq,bq", [(0, 0), (16000, 16000), (-16000, -16000),
                                   (12345, -6789), (-1, 1), (1, 1)])
def test_ola_property(aq, bq):
    s = T.online_add(T.fixed_to_sd(torch.tensor([aq]), 16),
                     T.fixed_to_sd(torch.tensor([bq]), 16), n_out=17)
    assert float(T.sd_to_value(s)[0]) * 2 ** 17 == aq + bq


def test_adder_tree_scaling_and_exactness():
    rng = np.random.default_rng(3)
    terms = rng.integers(-12000, 12000, size=(25, 32))
    streams = torch.stack([T.fixed_to_sd(t(r), 16) for r in terms])
    out, stages = T.online_add_tree(streams, n_out=21)
    assert stages == 5 and T.DELTA_MULT == 2 and T.DELTA_ADD == 2
    got = T.sd_to_value(out).double().numpy() * 2.0 ** (16 + 5)
    np.testing.assert_array_equal(got, terms.sum(0))


@pytest.mark.parametrize("k,n_fmaps,p_mult,expected", [
    (5, 1, 16, 33),                            # the paper's example
    (3, 1, 16, 2 + 2 * 4 + (16 + 4)),          # ceil(log2 9) = 4
    (5, 4, 16, 2 + 2 * 5 + 2 * 2 + (16 + 5)),  # fmap stages = 2
    (7, 1, 16, 2 + 2 * 6 + (16 + 6)),
])
def test_eq6(k, n_fmaps, p_mult, expected):
    s = T.pe_schedule(k=k, n_fmaps=n_fmaps, p_mult=p_mult)
    assert s.total_cycles == expected
    assert s.cycle_of_digit(s.p_out) == s.total_cycles


@pytest.mark.parametrize("k", [3, 5])
def test_pe_sop_bit_exact(k):
    rng = np.random.default_rng(k)
    sch = T.pe_schedule(k=k, p_mult=16)
    xq = rng.integers(0, 128, size=(k * k, 24))
    wq = rng.integers(-127, 128, size=(k * k,))
    sop = T.pe_sop_digits(T.fixed_to_sd(t(xq), 8),
                          torch.as_tensor(wq / 256.0,
                                          dtype=torch.float32)[:, None], sch)
    assert sop.shape[0] == sch.p_out
    got = T.sd_to_value(sop).double().numpy() * 2.0 ** (16 + sch.tree_stages)
    np.testing.assert_array_equal(got, (xq * wq[:, None]).sum(0))


def test_sd_roundtrips_exact():
    rng = np.random.default_rng(0)
    q = rng.integers(-255, 256, size=(512,))
    d = T.fixed_to_sd(t(q), 9)
    assert set(np.unique(d.numpy())) <= {-1, 0, 1}
    np.testing.assert_array_equal(T.sd_to_value(d).numpy() * 2.0 ** 9, q)
    d = T.sd_from_value(torch.as_tensor(q / 256.0, dtype=torch.float32), 8)
    np.testing.assert_array_equal(T.sd_to_value(d).numpy(), q / 256.0)
    pv = T.sd_prefix_values(T.fixed_to_sd(t(q), 9))
    assert pv.shape == (9, 512)
    np.testing.assert_array_equal(pv[-1].numpy(), q / 512.0)


@pytest.mark.parametrize("seed", range(4))
def test_posneg_and_first_negative_prefix_bruteforce(seed):
    rng = np.random.default_rng(seed)
    digits = rng.integers(-1, 2, size=(int(rng.integers(1, 19)), 16))
    d = torch.as_tensor(digits, dtype=torch.int8)
    pos, neg = T.sd_split_posneg(d)
    assert torch.equal(pos - neg, d) and not bool((pos & neg).any())
    idx = T.first_negative_prefix(d).numpy()
    prefix = np.cumsum(digits * 0.5 ** np.arange(1, len(digits) + 1)[:, None],
                       axis=0)
    for col in range(16):
        negs = np.nonzero(prefix[:, col] < 0)[0]
        assert idx[col] == (negs[0] + 1 if len(negs) else len(digits) + 1)


def _sop(xq, wq, k=5):
    sch = T.pe_schedule(k=k, p_mult=16)
    wf = torch.as_tensor(wq / 256.0, dtype=torch.float32)[:, None]
    return T.pe_sop_digits(T.fixed_to_sd(t(xq), 8), wf, sch), sch


@pytest.mark.parametrize("seed", range(4))
def test_termination_soundness(seed):
    """Termination fires only on SOPs whose true value is negative."""
    rng = np.random.default_rng(seed)
    k = 5 if seed % 2 else 3
    xq = rng.integers(0, 128, size=(k * k, 256))
    wq = rng.integers(-127, 32 if seed < 2 else 128, size=(k * k,))
    sop, sch = _sop(xq, wq, k)
    fired = T.early_termination(sop, sch).is_negative.numpy()
    true = (xq * wq[:, None]).sum(0)
    assert ((~fired) | (true < 0)).all(), "unsound termination"
    if seed < 2:
        assert fired.any(), "the case should exercise termination"


def test_savings_on_negatives_and_none_on_positives():
    rng = np.random.default_rng(1)
    sop, sch = _sop(rng.integers(32, 128, size=(25, 256)),
                    rng.integers(-127, -32, size=(25,)))
    rep = T.early_termination(sop, sch)
    assert bool(rep.is_negative.all())
    assert 0.30 <= float(rep.mean_savings) <= 0.65
    sop, sch = _sop(rng.integers(0, 128, size=(25, 128)),
                    rng.integers(16, 127, size=(25,)))
    rep = T.early_termination(sop, sch)
    assert not bool(rep.is_negative.any())
    assert bool((rep.cycles_used == sch.total_cycles).all())


def test_sip_partial_sign_is_unreliable():
    """LSB-first accumulators change sign late: why SIP cannot terminate
    early."""
    rng = np.random.default_rng(2)
    for _ in range(60):
        trace = T.sip_sop_trace(t(rng.integers(0, 256, size=(25, 1))),
                                t(rng.integers(-127, 128, size=(25, 1))))
        col = trace[:, 0].numpy()
        if np.any(np.sign(col[:-1]) != np.sign(col[-1])):
            return
    pytest.fail("expected at least one sign flip in SIP partial sums")


def test_cycle_model_reproduces_table1():
    assert abs(tcm.t_sip(5) - 30.075) < 1e-6
    assert abs(tcm.t_dslot(5) - 15.436) < 1e-6
    assert abs(1 - tcm.t_dslot(5) / tcm.t_sip(5) - 0.4867) < 0.01
    m = T.table1_model()
    for name, eng in m.items():
        pub = T.TABLE1_PUBLISHED[name]["gops_per_watt"]
        assert abs(eng.gops_per_watt - pub) / pub < 0.02, name
    gain = m["dslot"].gops_per_watt / m["stripes"].gops_per_watt - 1
    assert 0.40 <= gain <= 0.60
    better = m["dslot"].with_early_termination(0.06)
    assert better.gops_per_watt > m["dslot"].gops_per_watt
    assert better.energy_per_window_nj() < m["dslot"].energy_per_window_nj()


@pytest.mark.parametrize("n_bits", range(2, 9))
def test_csd_exact_canonical_and_minimal(n_bits):
    q = torch.arange(-(2 ** n_bits - 1), 2 ** n_bits, dtype=torch.int32)
    planes = T.csd_recode(q, n_bits)
    assert planes.shape == (n_bits + 1, q.shape[0])
    scales = 2 ** (n_bits - torch.arange(n_bits + 1))
    assert torch.equal((planes.long() * scales[:, None]).sum(0), q.long())
    nz = planes != 0
    assert set(planes.unique().tolist()) <= {-1, 0, 1}
    assert not bool((nz[1:] & nz[:-1]).any()), "adjacent nonzeros"
    assert int(T.essential_digit_count(planes)) <= \
        int(T.binary_digit_count(q, n_bits))


def test_csd_matmul_exact_and_sparser_than_dense():
    rng = np.random.default_rng(9)
    q = t(rng.integers(-255, 256, size=(16, 24)).astype(np.int32))
    w_q = t(rng.integers(-127, 128, size=(24, 8)).astype(np.int32))
    out, nz = T.csd_matmul(q, w_q, 8)
    assert torch.equal(out, q @ w_q) and 0 < int(nz) <= 9
    a = t(np.clip(np.round(np.abs(rng.normal(size=(32, 32))) * 40), 0, 255)
          .astype(np.int32))
    essential = int(T.essential_digit_count(T.csd_recode(a, 8)))
    binary = int(T.binary_digit_count(a, 8))
    assert essential <= binary < 8 * a.numel()
    assert int(T.csd_planes_nonzero(T.csd_recode(torch.zeros(
        (4, 4), dtype=torch.int32), 8))) == 0
