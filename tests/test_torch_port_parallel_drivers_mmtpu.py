"""The drivers with their own steps on a data-parallel mesh of two, the port
against mmtpu, on the CPU: mmtpu's `--data-parallel 2` over two of the
eight virtual devices (`tests/conftest.py`), the port's as two gloo ranks
from mmtpu's initial weights (`tests/_mesh_ranks.py::probed_main`), for
DualCMAM through `train_cmam` and MMIN, RedCore and Self-MM through
`train_multimodal`, on the configs of `tests/test_torch_port_parallel_drivers.py`
(a padded train tail whose rank 1 holds no real row). Dropout is 0 in both
(DualCMAM's config edited; RedCore's dropouts and ε taken out of both,
`tests/_redcore_neutral.py`). The C-MAM loss's MI term stays off: the
drivers hand it no critic, in both packages, and its permutation is drawn
from different generators (ROADMAP §3).

Held: every value of every metrics JSON that both write, under the same
keys in the same order, within 1e-4.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_ranks  # noqa: E402
from _cli_harness import run_cli_inproc  # noqa: E402
from _redcore_neutral import neutralised  # noqa: E402
from test_torch_port_parallel_drivers import (  # noqa: E402
    DRIVERS,
    argv,
    assert_close_records,
    driver_config,
    metrics_values,
)

from mmtpu.cli import common as jax_common  # noqa: E402
from mmtpu_torch.parallel import MeshConfig, create_mesh  # noqa: E402
from mmtpu_torch.parallel.launch import launch  # noqa: E402

CPU = torch.device("cpu")


def _mmtpu_run(root: Path, driver: str, cfg: Path) -> list:
    """mmtpu's CLI with `--data-parallel 2`; the initial variables of the
    models it trains, in the order the port's driver builds them."""
    mp = pytest.MonkeyPatch()
    inits, states = [], []
    real_init, real_state = jax_common.init_model, jax_common.make_state

    def tree(params, stats):
        return jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})

    def jax_init(model, sample, seed):
        params, stats = real_init(model, sample, seed)
        inits.append(tree(params, stats))
        return params, stats

    def jax_make_state(model, params, batch_stats, training, clip=None):
        states.append(tree(params, batch_stats))
        return real_state(model, params, batch_stats, training, clip=clip)

    try:
        mp.setattr(jax_common, "init_model", jax_init)
        mp.setattr(jax_common, "make_state", jax_make_state)
        if driver == "redcore":
            neutralised(mp)
        module = DRIVERS[driver][0].replace("mmtpu_torch.", "mmtpu.")
        assert run_cli_inproc(module, cfg, run_id="2", extra=("--data-parallel", "2"),
                              cwd=root) == 0
    finally:
        mp.undo()
    # train_cmam builds its frozen base (init_model), then the C-MAM
    # (make_state, after the encoders' copy); the others one model
    return inits[:1] + states[-1:] if driver == "dual_cmam" else states[-1:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per driver: mmtpu's run 2 on its 2-device mesh, then the port's run 1
    as two ranks from mmtpu's initial weights."""
    out = {}
    mesh = create_mesh(MeshConfig(data_parallel=2), devices=[CPU] * 2)
    for driver in DRIVERS:
        root = tmp_path_factory.mktemp(f"mesh_mmtpu_{driver}")
        cfg = driver_config(root, driver)
        weights = root / "weights.pt"
        torch.save(_mmtpu_run(root, driver, cfg), weights)
        assert launch(mesh, _mesh_ranks.probed_main,
                      (DRIVERS[driver][0], argv(cfg, 1, 2), str(root), str(weights)),
                      timeout=300) == 0
        out[driver] = root / "experiments_output" / DRIVERS[driver][3] / "metrics"
    return out


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_two_ranks_match_mmtpus_mesh_of_two(runs, driver):
    ours, theirs = metrics_values(runs[driver] / "1"), metrics_values(runs[driver] / "2")
    files = {k.split("[")[0].split("/")[0] for k in ours}
    assert files == {k.split("[")[0].split("/")[0] for k in theirs} >= {"epoch_metrics.json"}
    assert_close_records(ours, theirs)
    assert len(json.loads((runs[driver] / "1" / "epoch_metrics.json").read_text())) >= 2
