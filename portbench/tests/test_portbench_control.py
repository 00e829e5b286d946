"""On the card: the control (the reference in the program's place, one
precision below the configuration's) comes out not correct in every cell."""

import pytest

from portbench import control, manifest


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_the_control_is_not_correct(cuda_device, name):
    cell = manifest.load_cell(name)
    res = control.run_control(cell, 20261018, 4, cuda_device)
    assert res["checked"] >= 1
    assert any(res[k] > lim for k, lim in cell.limits.items()), res
