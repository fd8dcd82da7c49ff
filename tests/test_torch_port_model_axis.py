"""The model axis in the port (`mmtpu_torch/parallel/tensor.py`, the AVMNIST
head on a (dp, mp) mesh) against mmtpu on one device and against the port
in one process, on the CPU. Every check that needs ranks runs inside ONE
launch of four gloo ranks, a (2, 2) mesh (`tests/_mesh_ranks.py`
`model_axis_case`):

- mmtpu's `tests/test_parallel.py:157` setting: its small AVMNIST (ConvBlock
  8/16, hidden 32, dropout 0) carried across with `from_jax_variables`,
  the same numpy-seeded batch of 16, two SGD steps (lr 1e-2): the loss
  within 1e-5 relative, the gathered parameters within rtol 2e-5 / atol
  2e-6, the predictions equal; two Adam steps (`__graft_entry__.py:261`:
  lr 5e-4, weight decay 1e-4): the losses within 1e-5; the eval step's
  predictions equal and the recorder's `accuracy_AI` equal;
- a step whose global-norm clip binds against the port in one process
  within 1e-5 (a norm that counted a replicated leaf mp times, or a shard
  once, would move it);
- the ranks of a model group hold bit-identical replicated parameters; the
  eval forward calls the kernel's wrapper twice per step (the shard pair,
  then the one-layer tail); rank 0 alone writes the checkpoint, which
  loads into one process whole and back into each rank's shards;
- the streaming `TrainLoop` with its head sharded against one process.

Outside the launch: `create_mesh`'s (dp, mp) layout and mmtpu's errors for
a wrong mesh shape and a batch that does not divide over dp; joining what
`shard_module` keeps on each model rank gives the model back at mp = 1
and 2; the paths mmtpu never runs on a model axis raise.
"""

import dataclasses
import sys
from pathlib import Path
from typing import Optional

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_ranks  # noqa: E402
from test_parallel import build_avmnist_state_and_task, make_avmnist_batch  # noqa: E402

from mmtpu.config.optim import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from mmtpu.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from mmtpu.train.state import TrainState as JaxTrainState  # noqa: E402
from mmtpu.train.step import make_eval_step as jax_make_eval_step  # noqa: E402
from mmtpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from mmtpu_torch.checkpoints import from_jax_variables  # noqa: E402
from mmtpu_torch.config.spec import specs_from_dicts  # noqa: E402
from mmtpu_torch.models import build_module  # noqa: E402
from mmtpu_torch.models.avmnist import AVMNIST  # noqa: E402
from mmtpu_torch.models.fc import FcEncoder  # noqa: E402
from mmtpu_torch.parallel import MeshConfig, create_mesh, shard_batch  # noqa: E402
from mmtpu_torch.parallel.launch import launch  # noqa: E402
from mmtpu_torch.parallel.tensor import join_shards, shard_dims, shard_module  # noqa: E402
from _torch_threads import passive_children  # noqa: E402,F401 — its ranks wait passively

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6  # mmtpu's tests/test_parallel.py:187
CLIP_TOL = 1e-5
LOOP_TOL = 1e-5
DP, MP = 2, 2
ENC_ARGS = dict(
    conv_block_one_one_args={"conv_one_in": 1, "conv_one_out": 8},
    conv_block_one_two_args={"conv_one_in": 8, "conv_one_out": 8},
    conv_block_two_one_args={"conv_one_in": 8, "conv_one_out": 16},
    conv_block_two_two_args={"conv_one_in": 16, "conv_one_out": 16},
)
AVMNIST_KWARGS = {
    "audio_encoder": {"__module_spec__": "mnist_audio", "hidden_dim": 32, **ENC_ARGS},
    "image_encoder": {"__module_spec__": "mnist_image", "hidden_dim": 32, **ENC_ARGS},
    "hidden_dim": 32, "dropout": 0.0, "fusion_fn": "concat"}


def _port_model():
    return build_module("avmnist", **specs_from_dicts(AVMNIST_KWARGS))


def _to_port(params, batch_stats):
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, params),
                              jax.tree_util.tree_map(np.asarray, batch_stats) or None,
                              target=_port_model())


def _mmtpu(batch) -> dict:
    """mmtpu on one device from its seeded weights: two SGD steps, the eval
    step and its accuracy; two Adam steps; the initial weights."""
    state, task = build_avmnist_state_and_task()
    initial = _to_port(state.params, state.batch_stats)
    rng = jax.random.PRNGKey(7)
    step = jax_make_train_step(task, donate=False)
    tx, _ = jax_build_optimizer(JaxOptimizerConfig(
        name="Adam", default_kwargs={"lr": 5e-4, "weight_decay": 1e-4}), state.params)
    adam = JaxTrainState.create(apply_fn=state.apply_fn, params=state.params,
                                batch_stats=state.batch_stats, tx=tx)
    out = {"initial": initial}
    for name, st in (("sgd", state), ("adam", adam)):
        losses, preds = [], []
        for k in range(2):
            st, res = step(st, jax.device_put(batch), jax.random.fold_in(rng, k))
            losses.append(float(res["loss"]))
            preds.append(np.asarray(res["preds"]))
        out[name] = {"losses": losses, "preds": preds,
                     "state": _to_port(st.params, st.batch_stats)}
        if name == "sgd":
            ev = jax_make_eval_step(task)(st, jax.device_put(batch))
            preds = np.asarray(ev["preds"])
            out[name]["eval"] = {"preds": preds,
                                 "accuracy_AI": float(np.mean(preds == batch["labels"]))}
    return out


def _loop_weights():
    torch.manual_seed(3)
    model = AVMNIST(FcEncoder(3008, [16], dropout=0.0), FcEncoder(784, [16], dropout=0.0),
                    hidden_dim=16, dropout=0.0)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def axis(tmp_path_factory):
    work = tmp_path_factory.mktemp("model_axis")
    batch = make_avmnist_batch(16)
    want = _mmtpu(batch)
    loop_sd = _loop_weights()
    torch.save({"spec": {"name": "avmnist", "kwargs": AVMNIST_KWARGS,
                         "state_dict": want["initial"]},
                "batch": batch, "loop": loop_sd}, work / "model_axis.pt")
    mesh = create_mesh(MeshConfig(data_parallel=DP, model_parallel=MP), devices=[CPU] * 4)
    assert launch(mesh, _mesh_ranks.run_cases, (str(work), ["model_axis"]), timeout=300) == 0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)["model_axis"]
             for r in range(4)]
    single = _mesh_ranks.model_axis_case(work, None)
    lp = _mesh_ranks.loop("off", loop_sd)
    lp.run()
    return {"work": work, "batch": batch, "want": want, "ranks": ranks, "single": single,
            "loop": lp.epoch_metrics}


def _assert_state(got: dict, want: dict, rtol: float, atol: float,
                  tracked: Optional[int] = None) -> None:
    """`got` against `want` key for key; BatchNorm's batch counts, which
    mmtpu does not keep, against `tracked` (against `want`'s without it)."""
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert got[key].shape == ref.shape, key
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == (int(ref) if tracked is None else tracked), key
            continue
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)


def test_sgd_steps_match_mmtpu_on_one_device(axis):
    want = axis["want"]["sgd"]
    for r, rank in enumerate(axis["ranks"]):
        got = rank["sgd"]
        for k, (a, b) in enumerate(zip(got["losses"], want["losses"])):
            assert a == pytest.approx(b, rel=LOSS_RTOL), (r, k)
        for a, b in zip(got["preds"], want["preds"]):
            np.testing.assert_array_equal(a, b)
        _assert_state(got["state"], want["state"], PARAM_RTOL, PARAM_ATOL, tracked=2)


def test_adam_steps_match_mmtpu_on_one_device(axis):
    want = axis["want"]["adam"]
    for rank in axis["ranks"]:
        for a, b in zip(rank["adam"]["losses"], want["losses"]):
            assert a == pytest.approx(b, rel=LOSS_RTOL)
        np.testing.assert_array_equal(rank["adam"]["preds"][0], want["preds"][0])


def test_eval_and_recorder_match_mmtpu(axis):
    want = axis["want"]["sgd"]["eval"]
    for rank in axis["ranks"]:
        ev = rank["sgd"]["eval"]
        np.testing.assert_array_equal(ev["preds"], want["preds"])
        assert ev["metrics"]["accuracy_AI"] == want["accuracy_AI"]
        np.testing.assert_allclose(ev["logits"], axis["single"]["sgd"]["eval"]["logits"],
                                   rtol=1e-5, atol=1e-6)
        # the shard pair, then the one-layer tail (one call whole)
        assert ev["kernel_calls"] == 2
    assert axis["single"]["sgd"]["eval"]["kernel_calls"] == 1


def test_clipped_step_matches_one_process(axis):
    want = axis["single"]["clip"]
    for rank in axis["ranks"]:
        assert rank["clip"]["losses"][0] == pytest.approx(want["losses"][0], rel=CLIP_TOL)
        _assert_state(rank["clip"]["state"], want["state"], CLIP_TOL, CLIP_TOL)
    # the clip binds: the clipped update is not the unclipped step's
    unclipped = _sgd_one_step(axis)["fc_out.weight"]
    initial = axis["want"]["initial"]["fc_out.weight"]
    clipped = want["state"]["fc_out.weight"]
    assert float((clipped - initial).norm()) < 0.5 * float((unclipped - initial).norm())


def _sgd_one_step(axis) -> dict:
    """The port's one unclipped SGD step in one process."""
    from mmtpu_torch.config.optim import OptimizerConfig
    from mmtpu_torch.train.losses import LossFunctionGroup
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.state import TrainState
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    model = _port_model()
    model.load_state_dict(axis["want"]["initial"])
    opt, _ = build_optimizer(OptimizerConfig(name="SGD", default_kwargs={"lr": 1e-2}), model)
    task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}), input_keys=("audio", "image"))
    make_train_step(task, TrainState(model=model, optimizer=opt), CPU)(axis["batch"])
    return model.state_dict()


def test_dropout_draws_one_mask_over_the_whole_activation(axis):
    """Each rank keeps its columns of one mask over the whole fusion
    activation: the sharded training forward equals one process's from the
    same seed, and the two shards' masks differ (unit i and unit i + 32 are
    not dropped together)."""
    want = axis["single"]["dropout"]
    for rank in axis["ranks"]:
        np.testing.assert_allclose(rank["dropout"].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    torch.manual_seed(_mesh_ranks.MODEL_AXIS_DROPOUT_SEED)
    n = AVMNIST_KWARGS["hidden_dim"]
    keep = torch.nn.functional.dropout(torch.ones(16, n), _mesh_ranks.MODEL_AXIS_DROPOUT)
    assert not torch.equal(keep[:, :n // MP], keep[:, n // MP:])
    # the mask drops units: the forward is not the one without dropout
    model = _port_model()
    model.load_state_dict(axis["want"]["initial"])
    model.train()
    model.audio_encoder.eval()
    model.image_encoder.eval()
    with torch.no_grad():
        plain = model(*(torch.from_numpy(axis["batch"][k]) for k in ("audio", "image")))
    assert not np.allclose(want.numpy(), plain.numpy(), atol=1e-3)


def test_model_groups_hold_bit_identical_replicated_leaves(axis):
    ranks = axis["ranks"]
    sharded = {"fc_fusion.weight", "fc_fusion.bias", "fc_intermediate.weight"}
    for name in _mesh_ranks.MODEL_AXIS_OPTIMIZERS:
        for d in range(DP):
            a, b = ranks[d * MP][name]["local"], ranks[d * MP + 1][name]["local"]
            for key in a:
                if key in sharded:  # each rank holds its half
                    assert a[key].numel() * MP == axis["want"]["initial"][key].numel(), key
                    assert not torch.equal(a[key], b[key]), key
                else:
                    assert torch.equal(a[key], b[key]), (name, d, key)
        # a data group's ranks hold the same shards
        for m in range(MP):
            for key, v in ranks[m][name]["local"].items():
                assert torch.equal(v, ranks[MP + m][name]["local"][key]), (name, m, key)


def test_checkpoint_rank0_writes_the_whole_model_and_ranks_restore_shards(axis):
    ranks = axis["ranks"]
    # each written to a temporary name, then renamed
    assert [Path(p).name for p in ranks[0]["sgd"]["saved"]] == ["epoch_1.pth.tmp",
                                                               "best.pth.tmp"]
    assert all(r["sgd"]["saved"] == [] for r in ranks[1:])
    tree = torch.load(axis["work"] / "ckpt" / "best.pth", weights_only=True)
    model = _port_model()
    model.load_state_dict(tree["model"], strict=True)
    _assert_state(dict(model.state_dict()), ranks[0]["sgd"]["state"], 0, 0)
    # the optimizer's tree is the one-process tree's, key for key and shape for shape
    single = torch.load(axis["work"] / "ckpt_single" / "best.pth", weights_only=True)
    assert tree["optimizer"]["param_groups"] == single["optimizer"]["param_groups"]
    for r in ranks:
        for key, v in r["sgd"]["local"].items():
            assert torch.equal(r["sgd"]["restored"][key], v), key


def test_streaming_loop_with_a_sharded_head_matches_one_process(axis):
    want = axis["loop"]
    for rank in axis["ranks"]:
        got = rank["loop"]
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for split in ("train", "validation"):
                assert a[split]["loss"] == pytest.approx(b[split]["loss"], rel=LOOP_TOL)
            assert a["validation"]["metrics"] == b["validation"]["metrics"]


# -- outside the launch ----------------------------------------------------------------


def test_create_mesh_layout_and_errors():
    mesh = create_mesh(MeshConfig(data_parallel=2, model_parallel=2), devices=[CPU] * 4)
    assert (mesh.world_size, mesh.data_size, mesh.model_size) == (4, 2, 2)
    # rank r = d·mp + m, mmtpu's reshape(dp, mp)
    assert [(dataclasses.replace(mesh, rank=r).data_rank,
             dataclasses.replace(mesh, rank=r).model_rank) for r in range(4)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert create_mesh(MeshConfig(model_parallel=2), devices=[CPU] * 4).data_size == 2
    with pytest.raises(ValueError, match=r"mesh 2x2 != 3 devices"):
        create_mesh(MeshConfig(data_parallel=2, model_parallel=2), devices=[CPU] * 3)
    rank = dataclasses.replace(mesh, rank=3)
    assert shard_batch({"x": np.arange(8)}, rank)["x"].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="batch dim 15 not divisible by data_parallel=2"):
        shard_batch({"x": np.arange(15)}, rank)


@pytest.mark.parametrize("mp", [1, 2])
def test_joined_shards_are_the_whole_model(mp):
    torch.manual_seed(0)
    whole = _port_model()
    want = {k: v.clone() for k, v in whole.state_dict().items()}
    mesh = create_mesh(MeshConfig(data_parallel=1, model_parallel=mp), devices=[CPU] * mp)
    shards = []
    for m in range(mp):
        model = _port_model()
        model.load_state_dict(want)
        shard_module(model, dataclasses.replace(mesh, rank=m), AVMNIST.TENSOR_PARALLEL_RULE)
        for p in model.parameters():
            assert p.is_contiguous()
        shards.append(model.state_dict())
    dims = shard_dims(model)
    assert dims == {"fc_fusion.weight": 0, "fc_fusion.bias": 0, "fc_intermediate.weight": 1}
    joined = {**shards[0], **join_shards(shards, dims)}
    assert list(joined) == list(want)
    for key, v in want.items():
        assert torch.equal(joined[key], v), key


def test_a_model_without_a_tensor_parallel_forward_is_refused():
    mesh = dataclasses.replace(create_mesh(MeshConfig(1, 2), devices=[CPU] * 2), rank=0)
    with pytest.raises(ValueError, match="no tensor-parallel forward"):
        shard_module(FcEncoder(8, [4]), mesh, AVMNIST.TENSOR_PARALLEL_RULE)
    with pytest.raises(ValueError, match="no tensor-parallel forward"):
        shard_module(_port_model(), mesh, {"fc_fusion": "row"})


def test_paths_mmtpu_never_runs_on_a_model_axis_raise(monkeypatch):
    from mmtpu_torch.cli import common
    from mmtpu_torch.parallel import mesh as mesh_mod

    rank = dataclasses.replace(create_mesh(MeshConfig(2, 2), devices=[CPU] * 4), rank=0)
    match = r"model axis.*ROADMAP\.md §1"
    with pytest.raises(NotImplementedError, match="device-resident epoch.*" + match):
        _mesh_ranks.loop("on", _loop_weights(), rank)
    monkeypatch.setattr(mesh_mod, "_default_mesh", rank)
    with pytest.raises(NotImplementedError, match="training CLI.*" + match):
        common.rank_mesh()
