"""The dry run's extrapolation in depth and cohort against exact traces.

``repro_torch.launch.dryrun.run_case`` traces a deep case at 2 and 3
pattern units, and a large cohort at 2 and 3 clients a pod, and fits each
reported quantity linearly in each to the whole case (``trace_points``).
Here ``dryrun.check_fit`` holds the report of such a fit, on a fake
(2, 2, 2) world with sequences of 32 tokens, to an ``--exact`` trace of
the same case: the reduced qwen2 cut to 4 and to 6 units with 3 clients a
pod (the depth fitted), and the reduced qwen3-moe cut to 4 units with 4
clients a pod (depth and cohort fitted, so the fit's cross term too).
Peak and bytes a device within 0.1%, dot FLOPs and the collectives'
counts and bytes exact but for the one remainder the report carries
(``fit_wire_row_remainder_bytes``: each leaf's packed wire row rounds up,
so the cross-pod gather of the rows is off by it times the rows; 0 on
qwen2's shards, -128 B a row on the MoE's). The two qwen2 fits share their traces (the same
cut configs), so each is traced once. A depth or cohort of at most 3 (the
reduced qwen3-moe at 3 units and 3 clients a pod) is traced whole, so its
report is the exact trace's.
"""

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig

MESH = (2, 2, 2)
CASES = {  # (arch, units, clients a pod)
    "qwen2-4u": ("qwen2-1.5b", 4, 3),
    "qwen2-6u": ("qwen2-1.5b", 6, 3),
    "moe-4u-4c": ("qwen3-moe-30b-a3b", 4, 4),
}
EXACT = ("dot_flops_per_device", "collective_link_bytes", "cross_pod_link_bytes", "n_collectives", "collectives_by_kind",
         "collectives_by_dim", "collective_calls_by_dim")
WITHIN = ("peak_bytes_per_device", "bytes_per_device")


@pytest.fixture(scope="module")
def reports():
    """Each case's ``check_fit``, one torch thread, the fits' traces shared
    where their cut configs are the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    orig_trace = dryrun._trace
    seen = {}

    def shared_trace(cfg, shape, mesh, device, pod_stride, **kw):
        key = (repr(cfg), shape, pod_stride, tuple(sorted(kw.items())))
        if key not in seen:
            seen[key] = orig_trace(cfg, shape, mesh, device, pod_stride, **kw)
        return seen[key]

    out = {}
    try:
        dryrun._trace = shared_trace
        for name, (arch, units, per_pod) in CASES.items():
            shape = ShapeConfig("train_32", 32, 2 * per_pod, "train")
            unit = dryrun.configs.get_config(arch).unit
            out[name] = dryrun.check_fit(arch, shape, True, fl_clients=2 * per_pod, device="cpu", mesh_shape=MESH,
                                         reduced=True, layers=units * unit)
    finally:
        dryrun._trace = orig_trace
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fitted_report_equals_exact_trace(reports, case):
    fit, exact, apart = reports[case]["fit"], reports[case]["exact"], reports[case]["apart"]
    assert fit["status"] == "ok", fit.get("traceback")
    assert exact["status"] == "ok", exact.get("traceback")
    arch, units, per_pod = CASES[case]
    assert exact["traces"] == [{"units": units, "clients_per_pod": per_pod}] and not exact["extrapolated"]
    want_units = [units] if units <= 3 else [2, 3]
    want_clients = [per_pod] if per_pod <= 3 else [2, 3]
    assert fit["extrapolated"] and fit["traces"] == [{"units": u, "clients_per_pod": c}
                                                     for u in want_units for c in want_clients]
    # the one remainder: each leaf's packed wire row rounds up (none in
    # qwen2's shards); the cross-pod gather moves each pod's rows once
    rem = fit["fit_wire_row_remainder_bytes"]
    assert (rem != 0) == (arch == "qwen3-moe-30b-a3b")
    gather = -rem * per_pod * (MESH[0] - 1)
    kind, by_dim = exact["collectives_by_kind"], exact["collectives_by_dim"]
    want = dict(exact, collective_link_bytes=exact["collective_link_bytes"] + gather,
                cross_pod_link_bytes=exact["cross_pod_link_bytes"] + gather,
                collectives_by_kind=dict(kind, **{"all-gather": kind["all-gather"] + gather}),
                collectives_by_dim=dict(by_dim, pod=by_dim["pod"] + gather))
    for k in EXACT:
        assert fit[k] == want[k], k
        assert (k in apart) == (fit[k] != exact[k]), k
    for k in WITHIN:
        assert abs(fit[k] - exact[k]) <= 1e-3 * exact[k], (k, fit[k], exact[k])
        assert k not in apart or abs(apart[k]["relative"]) <= 1e-3


def test_trace_points():
    """Each of depth and cohort traced whole up to 3, else at 2 and 3;
    ``exact`` traces the whole case."""
    assert dryrun.trace_points(48, 8) == [(2, 2), (2, 3), (3, 2), (3, 3)]
    assert dryrun.trace_points(3, 8) == [(3, 2), (3, 3)]
    assert dryrun.trace_points(48, 1) == [(2, 1), (3, 1)]
    assert dryrun.trace_points(2, 3) == [(2, 3)]
    assert dryrun.trace_points(3, 3) == dryrun.trace_points(3, 3, exact=True) == [(3, 3)]
    assert dryrun.trace_points(48, 8, exact=True) == [(48, 8)]
