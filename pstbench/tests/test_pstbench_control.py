"""The control (the reference in bfloat16 in the program's place) fails
every cell's limit, and the program passes it, at a small size on the
CPU; on the card the same readings come from ``python -m pstbench.control``
at each cell's own size."""

import pytest

from pstbench import control, run

from .conftest import SMALL


@pytest.mark.parametrize("workload", ["low.oneshot", "low.stream", "low.dada"])
def test_control_fails_the_limit_and_the_program_passes(bench, workload):
    limit = run.load_json(run.HERE / "limits" / f"{workload}.json")["max_rel_err"]["limit"]
    r = control.readings(workload, 2**31 + 5, device="cpu", bench=bench,
                         traffic_params=SMALL[workload])
    assert r["program"] < limit < r["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["low.oneshot", "mid.oneshot", "low.stream"])
def test_control_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limit = run.load_json(run.HERE / "limits" / f"{workload}.json")["max_rel_err"]["limit"]
    r = control.readings(workload, 2**31 + 5)
    assert r["program"] < limit < r["control"]
