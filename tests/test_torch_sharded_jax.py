"""The port's 4-rank data x rays train step (data 2 x rays 2, gloo on the
CPU) against the JAX ``Trainer(mesh=make_train_mesh(4, data_parallel=2))``
on conftest's CPU devices: the same weights, batch, host generator and the
JAX trainer's render draws (``test_torch_sharded``'s setup), loss and
``grad_norm`` at each of 3 steps within
``test_train_pipeline.py::test_trainer_mesh_sharded_step``'s rtol 2e-3."""

import numpy as np
import pytest

from test_torch_sharded import jax_mesh_steps, jax_step_draws, run, spec, train_leg
from test_torch_train_step import setup  # noqa: F401


@pytest.fixture(scope="module")
def both(setup, tmp_path_factory):  # noqa: F811
    jax_steps = jax_mesh_steps(setup, tmp_path_factory.mktemp("jax_mesh"))
    port = run(4, spec(setup, tmp_path_factory.mktemp("four"),
                       [train_leg("mesh22", jax_step_draws(), data=2, state=False)]))
    return jax_steps, port["mesh22"]


def test_four_ranks_match_the_jax_mesh_step(both):
    jax_steps, port = both
    assert len(port["rank_wall_s"]) == 4
    for step, (s, j) in enumerate(zip(port["steps"], jax_steps)):
        assert np.isfinite(s["t"])
        np.testing.assert_allclose(s["t"], j["t"], rtol=2e-3, err_msg=f"step {step}")
        np.testing.assert_allclose(s["grad_norm"], j["grad_norm"], rtol=2e-3,
                                   err_msg=f"step {step}")


def test_every_rank_ends_on_the_same_loss_keys(both):
    """The sharded step reports the JAX step's losses (rc, rf, t) and the
    gradient norm, averaged over the ranks."""
    jax_steps, port = both
    for s, j in zip(port["steps"], jax_steps):
        assert sorted(s) == sorted(j)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """``entry.dryrun_multichip(4, "cpu")``: sn64 at full width over data 2 x
    rays 2, its three legs within the JAX dry run's bars (it raises
    otherwise), printed in the JAX wording; the resumed step 2 against one
    process from the same checkpoint at step 1's bars, and fewer than 1e-3
    of the weights more than lr/2 from one process's after 2 steps."""
    from pixelnerf_tpu_torch import entry

    res = entry.dryrun_multichip(4, "cpu")
    out = capsys.readouterr().out
    for leg in ("train", "resume", "eval"):
        assert f"dryrun_multichip {leg} OK" in out
    assert "mesh {'data': 2, 'rays': 2}, SB=2, R=32" in out
    assert res["mesh"] == (2, 2) and len(res["sharded"]["train"]["rank_wall_s"]) == 4
    assert res["train"][0] < 1e-4 and res["train"][1] < 1e-3
    assert res["resume_control"][0] < 1e-4 and res["resume_control"][1] < 1e-3
    assert res["drift"][0] < 1e-3 * res["drift"][1]
