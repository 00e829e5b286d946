"""The reference against plain autograd and against tiny runs of the
port's entries on the CPU; each fault a cell can have, planted under a
run, makes ``correct`` false."""

import json
import math

import pytest
import torch

from portbench import harness as H
from portbench import manifest, run
from portbench.reference import gp64 as R
from portbench.reference import judge as J
from portbench.tests import tiny

GP = {"kernel": "matern52", "noise_floor": 1e-4, "jitter": 1e-6, "lengthscale_bounds": [0.005, 2.0],
      "outputscale_bounds": [0.05, 20.0], "noise_bounds": [1e-4, 0.2], "fit_lr": 0.1}


def _plain_loss(x, y_std, raw):
    h = R.constrain(raw, GP)
    k = R.kernel(x, None, h, GP)
    c = R.train_shift(h, GP["jitter"], GP["jitter"])
    k = k + c * torch.eye(x.shape[0], dtype=x.dtype)
    l_mat = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(y_std[:, None], l_mat)[:, 0]
    n = x.shape[0]
    return 0.5 * ((y_std * alpha).sum() + 2 * torch.log(l_mat.diagonal()).sum() + n * math.log(2 * math.pi)) / n


def test_closed_form_gradient_equals_autograd():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((40, 3), generator=g, dtype=torch.float64)
    y_std = R.standardize(torch.sin(5 * x).sum(dim=1))[0]
    raw = torch.tensor([0.3, -0.2, 0.1, 0.4, -3.0, 0.0], dtype=torch.float64, requires_grad=True)
    want_loss = _plain_loss(x, y_std, raw)
    (want,) = torch.autograd.grad(want_loss, raw)
    loss, grad = R.loss_and_grad(x, y_std, raw, GP)
    assert float(loss) == pytest.approx(float(want_loss.detach()), rel=1e-12)
    assert torch.allclose(grad[:-1], want[:-1], rtol=1e-8, atol=1e-12) and grad[-1] == 0


def test_judge_reads_picks_and_values():
    values = torch.tensor([[0.0, 1.0, 2.0, 3.0], [0.0, 0.5, 2.0, 3.0]], dtype=torch.float64)
    assert J.pick_mismatch(values, torch.tensor([0, -1])) == 1
    assert J.pick_mismatch(values, torch.tensor([0, 1])) == 0
    assert J.pick_mismatch(values, torch.tensor([0, 2])) == 1
    assert J.value_gap(values + 0.01, values) == pytest.approx(0.01 / float(values[0].std()))
    assert J.value_gap(None, values) == math.inf


def test_check_sample_keeps_the_largest_history():
    n = [3, 9, 1, 7, 5]
    picked = H.check_sample(5, 2, 11, key=lambda i: n[i])
    assert 1 in picked and len(picked) == 2
    assert H.check_sample(5, 0, 11) == list(range(5))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("portbench")))


CELLS = [f"tiny_{w['name']}" for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_of_the_port_is_correct(root, name):
    cell = manifest.load_cell(name, root)
    res = run.run_cell(cell, 2**31 + 7, 0.4, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])


def _stale(monkeypatch, entry):
    """The surrogate is not refreshed with the batches: the GP conditions
    on the initial design alone, its shapes unchanged."""
    from turbojax_torch import bo_distributed as BD
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch import gp as G
    from turbojax_torch.linalg import row_mask

    n0 = entry.n_init

    def refactor(x, y, raw, config, **kw):
        mask = row_mask(x.shape[0], n0, x.device)
        return DL._adapt_dense(G.make_gp_state(x, y, mask, raw, config), y, mask, config)

    def fit(x, y, config, warm_start=None, **kw):
        raw = warm_start if warm_start is not None else G.default_params(x.shape[1], config, x.dtype, x.device)
        return refactor(x, y, raw, config)

    monkeypatch.setattr(BD, "refactor_gp_auto", refactor)
    monkeypatch.setattr(BD, "fit_gp_auto", fit)


def _fit_unchanged(monkeypatch, entry):
    """The fit returns the hypers it was started from."""
    from turbojax_torch import bo_distributed as BD
    from turbojax_torch import gp as G

    def fit(x, y, config, warm_start=None, **kw):
        raw = warm_start if warm_start is not None else G.default_params(x.shape[1], config, x.dtype, x.device)
        return BD.refactor_gp_auto(x, y, raw, config)

    monkeypatch.setattr(BD, "fit_gp_auto", fit)


def _half(monkeypatch, entry):
    """Half of the observations left out of the posterior (and of y's
    standardization, whose mean is taken over the rest)."""
    from turbojax_torch import gp as G
    from turbojax_torch.linalg import row_mask

    make = G.make_gp_state

    def half(x_buf, y_buf, mask, raw, config):
        n = int(mask.sum())
        return make(x_buf, y_buf, mask & row_mask(mask.shape[-1], n // 2, mask.device), raw, config)

    monkeypatch.setattr(G, "make_gp_state", half)
    if hasattr(entry, "carry"):  # the suggest entry's posterior, cached in set-up
        c = entry.carry
        st = half(c.x_buf, c.y_buf, row_mask(c.n, c.n, c.x_buf.device), c.raw, entry.gp)
        entry.carry = c._replace(n=c.n // 2, chol=st.chol, y_mean=st.y_mean, y_std=st.y_std)


def _altered(monkeypatch, entry):
    """Row 0's answer replaced, where it is produced, by its worst candidate."""
    from turbojax_torch import acq as A

    select = A.select_q_batch

    def altered(samples, *a, **kw):
        idx, vals = select(samples, *a, **kw)
        idx = idx.clone()
        idx[0] = torch.argmax(samples[0])
        return idx, vals

    monkeypatch.setattr(A, "select_q_batch", altered)


FAULTS = {"stale": _stale, "fit_unchanged": _fit_unchanged, "half": _half, "altered": _altered}


def _faults(name):
    """The faults a cell can have: a GP not refreshed and a fit left
    unchanged only where the window refreshes or fits it."""
    out = ["half", "altered"]
    if "exact" not in name:
        out.insert(0, "stale")
        if "pinned" not in name:
            out.insert(1, "fit_unchanged")
    return out


REAL = [w["name"] for w in manifest.load_manifest()["workloads"]]
CASES = [(f"tiny_{c}", f) for c in REAL for f in _faults(c)]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(root, monkeypatch, name, fault):
    cell = manifest.load_cell(name, root)
    res = run.run_cell(cell, 2**31 + 7, 0.4, False, "cpu", entry_hook=lambda entry: FAULTS[fault](monkeypatch, entry))
    assert not res["correct"], res["checks"]


CARD_SEEDS = (3000000001, 3000000019, 3000000037)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("name,fault", [(c, f) for c in REAL for f in _faults(c)])
def test_a_planted_fault_is_not_correct_at_the_cells_size(cuda_device, monkeypatch, name, fault, seed):
    """Each fault at the cell's own sizes on the card, over a window of
    three seconds (two refit batches: a GP left stale differs from the
    program's from the second batch of a segment on); the numbers compared
    are printed (``pytest -s``) for the limits' upper readings."""
    cell = manifest.load_cell(name)
    res = run.run_cell(cell, seed, 3.0, False, cuda_device,
                       entry_hook=lambda entry: FAULTS[fault](monkeypatch, entry))
    readings = {k: v["value"] for k, v in res["checks"].items()}
    print(f"\nportbench fault {name} {fault} seed {seed} batches {res['attempted']} {json.dumps(readings)}")
    assert not res["correct"], res["checks"]
