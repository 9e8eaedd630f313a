"""The benchmark's arithmetic on synthetic inputs: the segment tail, the
busy union and idle gaps of a trace, the per-layer readers, K2's and the
A contraction's frozen byte counts and their roofline shares, and the
check's log-prob gap and DE proposal."""
import statistics
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, plan as plans
from portbench.roofline import a_contract, k2_tof_hist, peaks


def test_p95_is_pythons_quantile():
    values = [float(v) for v in np.random.default_rng(0).gamma(5, 30, 250)]
    assert harness.p95(values) == statistics.quantiles(values, n=100)[94]
    assert harness.p95(list(range(1, 101))) == pytest.approx(95.95)


def test_busy_union_and_idle_gaps_clip_to_the_window():
    intervals = [(0, 10), (5, 20), (30, 40), (38, 45), (90, 120)]
    assert harness.union_s(intervals, 0, 100) == 20 + 15 + 10
    assert harness.union_s(intervals, 8, 35) == 12 + 5
    assert harness.idle_gaps(intervals, -5, 100) == [
        (-5, 0), (20, 30), (45, 90)]
    assert harness.idle_gaps([], 0, 7) == [(0, 7)]


def test_reduce_trace_on_a_synthetic_sub_window():
    events = [
        (harness.SUBWINDOW, "host", 0.0, 1000.0),
        (harness.SUBWINDOW, "device", 0.0, 1000.0),   # the profiler's twin
        ("launch_a", "host", 10.0, 30.0),
        ("aten::mul", "host", 40.0, 400.0),
        ("aten::inner", "host", 100.0, 300.0),
        ("k2 tof_hist_kernel<10>", "device", 20.0, 60.0),
        ("tof_hist_bwd_kernel", "device", 70.0, 80.0),
        ("gemm", "device", 500.0, 900.0),
    ]
    r = harness.reduce_trace(events, steps=4)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(450e-6)
    assert r["n_ops"] == 3 and r["steps"] == 4
    assert r["breakdown"]["device_ops"][0] == ["gemm", pytest.approx(4e-4)]
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::inner", pytest.approx(420e-6)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps),
                                          reverse=True)


def test_k2_bytes_are_pinned_by_hand():
    # simultFit: 128 walkers x 4 runs x 10 x 50 cells, 10 segments, 70
    # bins: times and draws 2 x 256,000 floats, segment tables 2 x 500,
    # histogram 128 x 4 x 70 = 35,840 floats
    simult = dict(rows=128, runs=4, n_x=10, n_ed=50, n_seg=10, n_pad=70)
    assert k2_tof_hist.bytes_moved(**simult) == 4 * (512_000 + 1_000
                                                     + 35_840)
    # oneBD hardcore: 128 x 3 x 20 x 400 cells, one segment, 25 bins
    onebd = dict(rows=128, runs=3, n_x=20, n_ed=400, n_seg=1, n_pad=25)
    assert k2_tof_hist.bytes_moved(**onebd) == 4 * (6_144_000 + 800
                                                    + 9_600)
    h100 = peaks.peaks_of("NVIDIA H100 80GB HBM3")
    for shape, ms in ((simult, 0.000655), (onebd, 0.007349)):
        least, by = k2_tof_hist.bound_s(shape, h100)
        assert by == "bytes" and least * 1e3 == pytest.approx(ms, rel=1e-3)
    assert peaks.peaks_of("cpu") is None


def _campaign(runs, n_x, n_ed, n_seg, n_pad):
    """What K2's shape reads of a campaign."""
    return SimpleNamespace(
        n_runs=runs, x=SimpleNamespace(n=n_x), ed=SimpleNamespace(n=n_ed),
        zt=np.zeros((n_ed, n_seg)),
        windows=[SimpleNamespace(n_bins=n_pad - 1),
                 SimpleNamespace(n_bins=n_pad)])


def _readings(**kw):
    base = dict(plan=None, campaign=None, walkers=0, spans=None,
                profile=None, device_name="cpu")
    base.update(kw)
    return harness.Readings(**base)


def test_k2_shape_from_a_campaign():
    camp = _campaign(runs=3, n_x=20, n_ed=400, n_seg=1, n_pad=25)
    assert k2_tof_hist.shape(camp, 256) == dict(
        rows=128, runs=3, n_x=20, n_ed=400, n_seg=1, n_pad=25)


def test_readers_on_synthetic_readings():
    spans = {"segment_ms": [100.0, 120.0], "logp_ms": [5.0] * 40,
             "steps": 20}
    profile = {"window_s": 0.2, "busy_s": 0.05, "n_ops": 9000, "steps": 10,
               "kernel_s": {"void tof_hist_kernel<10>": [8e-6, 8e-6],
                            "tof_hist_bwd_kernel": [1.0]}}
    shape = dict(rows=128, runs=4, n_x=10, n_ed=50, n_seg=10, n_pad=70)
    r = _readings(spans=spans, profile=profile,
                  campaign=_campaign(4, 10, 50, 10, 70), walkers=256,
                  device_name="NVIDIA H100 80GB HBM3")

    def read(name):
        return plans.metric_reader(name)(r)

    assert read("sampler_self_ms_per_step") == pytest.approx(1.0)
    assert read("logp_ms_per_eval") == pytest.approx(5.0)
    assert read("device_idle_pct") == pytest.approx(75.0)
    assert read("device_ops_per_step") == pytest.approx(900.0)
    least, _ = k2_tof_hist.bound_s(shape, peaks.peaks_of("H100"))
    assert read("k2_tof_hist_roofline") == pytest.approx(
        100 * least / 8e-6)


def test_readers_with_nothing_to_read_return_nothing():
    empty = _readings()
    for name in ("sampler_self_ms_per_step", "logp_ms_per_eval",
                 "device_idle_pct", "device_ops_per_step",
                 "k2_tof_hist_roofline"):
        assert plans.metric_reader(name)(empty) is None
    no_k2 = _readings(profile={"window_s": 1.0, "busy_s": 0.5, "n_ops": 3,
                               "steps": 1, "kernel_s": {"gemm": [1e-3]}},
                      campaign=_campaign(1, 1, 1, 1, 1), walkers=2,
                      device_name="NVIDIA H100 80GB HBM3")
    assert plans.metric_reader("k2_tof_hist_roofline")(no_k2) is None


@pytest.mark.parametrize("cell, shape, nbytes, ms", [
    # 128 walkers x 4 runs of 4 x 512 moments into 10 x 50 cells; A
    # 1.6% nonzero
    ("simult-counts", dict(rows=512, k=2048, n_cols=500, nnz=16_772),
     4 * (1_048_576 + 256_000) + 8 * 16_772, 0.0015978),
    # 128 walkers x 3 runs of 4 x 1,024 moments into 20 x 400 cells; A
    # 0.19% nonzero (the same nonzeros after its bfloat16 rounding)
    ("onebd-hardcore-counts", dict(rows=384, k=4096, n_cols=8000,
                                   nnz=63_612),
     4 * (1_572_864 + 3_072_000) + 8 * 63_612, 0.0056980)])
def test_a_contract_shape_and_bytes_are_pinned_by_hand(cell, shape, nbytes,
                                                       ms):
    plan = plans.resolve(cell, plans.benchmark())
    camp = plans.reference_of(plan.traffic).campaign(plan.config,
                                                     plan.traffic)
    assert a_contract.shape(camp, 256) == shape
    assert a_contract.bytes_moved(**shape) == nbytes
    assert a_contract.operations(**shape) == 2 * shape["rows"] * shape["nnz"]
    least, by = a_contract.bound_s(shape, peaks.peaks_of("H100"))
    assert by == "bytes" and least * 1e3 == pytest.approx(ms, rel=1e-4)
    if cell.startswith("onebd"):
        assert nbytes == 19_088_352            # 19.1 MB
        a = torch.as_tensor(camp.operator.a_matrix)
        assert int((a.to(torch.bfloat16) != 0).sum()) == shape["nnz"]


def test_the_a_contract_reader_reads_its_kernel_alone():
    op = SimpleNamespace(a_matrix=np.eye(8, 6, dtype=np.float32))
    camp = SimpleNamespace(n_runs=2, operator=op)
    shape = dict(rows=4, k=8, n_cols=6, nnz=6)
    kernel_s = {"void mcmctof::a_contract_kernel<4>(float const*)":
                [2e-6, 4e-6],
                "void tof_hist_kernel<10>": [1.0], "gemm": [1.0]}
    r = _readings(profile={"window_s": 1.0, "busy_s": 0.5, "n_ops": 4,
                           "steps": 1, "kernel_s": kernel_s},
                  campaign=camp, walkers=4,
                  device_name="NVIDIA H100 80GB HBM3")
    least, _ = a_contract.bound_s(shape, peaks.peaks_of("H100"))
    assert least == pytest.approx((4 * (32 + 24) + 48) / 3.35e12)
    reader = plans.metric_reader("a_contract_roofline")
    assert reader(r) == pytest.approx(100 * least / 3e-6)
    # nothing to read: no profile, no launch of the kernel, no known chip
    assert reader(_readings()) is None
    r.profile = dict(r.profile, kernel_s={"gemm": [1e-3]})
    assert reader(r) is None
    r.profile["kernel_s"] = kernel_s
    r.device_name = "cpu"
    assert reader(r) is None


def test_logp_gaps():
    inf = np.inf
    cand = np.array([-1.0, -inf, -inf, -2.0, 5.0], np.float32)
    ref = np.array([-1.5, -inf, -3.0, -inf, 5.0], np.float32)
    assert harness.logp_gaps(cand, ref).tolist() == [0.5, 0.0, inf, inf, 0.0]


def test_de_proposals_drawn_again_match_and_a_wrong_one_does_not():
    """The DE move's draws, made again from the generator's state, give
    the sampler's own proposal; a wrong factor or partner does not."""
    from mcmctoffitting_tpu_torch.sampler import stretch
    from portbench.reference import de_move
    gen = torch.Generator().manual_seed(7)
    pos = torch.randn(16, 5, generator=torch.Generator().manual_seed(1))
    lp = torch.zeros(16)
    seen = []

    def logp(thetas, _):
        seen.append(thetas.clone())
        return torch.zeros(len(thetas))

    start = gen.get_state()
    stretch._half_update_de(pos.clone(), lp.clone(), 0, gen, None, logp,
                            2.38 / 10 ** 0.5, 1e-5)
    replay = torch.Generator()
    replay.set_state(start)
    j1, j2, g, _ = de_move.draws(replay, 8, 5, 0)
    active, passive = pos[0::2].numpy(), pos[1::2].numpy()
    prop = seen[0].numpy()
    assert de_move.proposal_mismatches(prop, active, passive, j1, j2, g) == 0
    assert de_move.proposal_mismatches(prop, active, passive, j1, j2,
                                       g * 1.001) == 8
    assert de_move.proposal_mismatches(prop, active, passive, j2, j1,
                                       g) == 8
