"""The port's training path on the card against the same code on the CPU:
the pad-aware BatchNorm in train mode, one train step of a small AVMNIST
(padded tail, missing modalities, dropout 0, TF32 off), and one train step
of UttFusion at its published widths, whose LSTM forward is the `lstm`
kernel on the card and the plain scan on the CPU; both kernels under
`torch.func.vmap` over stacked members, one launch for all members. These need an NVIDIA GPU
and skip without one. The module imports neither JAX nor
mmtpu, so on the card's machine run

    python -m pytest tests/test_torch_port_train_card.py -m cuda --noconftest

Tolerances: BatchNorm 1e-5 (fp32, the card sums in another order); the
AVMNIST train step's loss 1e-4 relative and each gradient within 1e-3 of
its norm; the UttFusion step's loss 1e-5 relative and each gradient within
1e-4 of its norm (no BatchNorm on that path).
(`chip_smoke.py` checks the full-width model, whose float32 gradients miss
a float64 step by more than that on either device, against that float64
step.)"""

import numpy as np
import pytest
import torch

from mmtpu_torch.models import AVMNIST, ResNetEncoder
from mmtpu_torch.models.norm import BatchNorm, batch_mask


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compares the card's training path with the CPU's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run_bn(x, mask, cot, device, state):
    bn = BatchNorm(x.shape[1]).to(device)
    bn.load_state_dict(state)
    bn.train()
    xt = x.clone().to(device).requires_grad_()
    with batch_mask(None if mask is None else mask.to(device)):
        y = bn(xt)
    (y * cot.to(device)).sum().backward()
    return y.detach().cpu(), xt.grad.cpu(), bn.running_mean.cpu(), bn.running_var.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("padded", [True, False])
def test_masked_batchnorm_on_card_matches_cpu(cuda_device, rank, padded):
    g = torch.Generator().manual_seed(rank * 10 + padded)
    shape = (12, 6) if rank == 2 else (12, 6, 5, 4)
    x = torch.randn(shape, generator=g) * 2 + 0.5
    mask = None
    if padded:
        mask = torch.ones(12)
        mask[9:] = 0
        x[9:] = 0
    cot = torch.randn(shape, generator=g)
    state = BatchNorm(6).state_dict()
    state["weight"] = 1 + 0.1 * torch.randn(6, generator=g)
    state["bias"] = 0.1 * torch.randn(6, generator=g)
    state["running_var"] = 0.5 + torch.rand(6, generator=g)
    got = _run_bn(x, mask, cot, cuda_device, state)
    want = _run_bn(x, mask, cot, torch.device("cpu"), state)
    for a, b, what in zip(got, want, ("output", "input gradient", "mean", "var")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=what)


def _batch(B=16, padded_from=12, seed=3):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 10, size=B).astype(np.int64)
    batch = {
        "audio": (g.normal(size=(B, 32, 94)) + 0.3 * labels[:, None, None]).astype(np.float32),
        "image": (g.normal(size=(B, 28, 28, 1)) + 0.3 * labels[:, None, None, None]
                  ).astype(np.float32),
        "audio_mask": np.ones(B, np.float32), "image_mask": np.ones(B, np.float32),
        "labels": labels, "pattern_id": np.zeros(B, np.int32),
        "sample_mask": np.ones(B, np.float32),
    }
    batch["audio_mask"][1::4] = 0.0
    batch["image_mask"][2::4] = 0.0
    for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
        batch[k][padded_from:] = 0
    return batch


def _step_on(device, batch):
    from mmtpu_torch.cli import common
    from mmtpu_torch.config.training import TrainingConfig
    from mmtpu_torch.train import losses
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    model = AVMNIST(ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=16),
                    ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24), hidden_dim=32,
                    dropout=0.0)
    model = common.init_model(model, 7, device)
    training = TrainingConfig.from_dict({
        "epochs": 1, "num_modalities": 2,
        "optimizer": {"name": "Adam", "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4}},
        "loss_functions": {"ce": {"loss_name": "cross_entropy"}}})
    state = common.make_state(model, training)
    task = ClassificationTask(model=model, loss_group=losses.LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy"}}), input_keys=["audio", "image"])
    out = make_train_step(task, state, device)(batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
    return float(out["loss"]), grads, stats


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    batch = _batch()
    loss, grads, stats = _step_on(cuda_device, batch)
    want_loss, want_grads, want_stats = _step_on(torch.device("cpu"), batch)
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for n, w in want_grads.items():
        err = (grads[n] - w).abs().max().item()
        assert err <= 1e-3 * max(w.norm().item(), 1e-12), (n, err)
    for k, w in want_stats.items():
        torch.testing.assert_close(stats[k], w, rtol=1e-4, atol=1e-5, msg=k)


def _utt_batch(B=16, T=12, padded_from=12, seed=5):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 3, size=B).astype(np.int64)
    batch = {k: (g.normal(size=(B, T, w)) + 0.3 * labels[:, None, None]).astype(np.float32)
             for k, w in (("audio", 5), ("video", 20), ("text", 768))}
    for k in ("audio", "video", "text"):
        batch[f"{k}_mask"] = np.ones(B, np.float32)
    batch["audio_mask"][1::4] = 0.0
    batch["video_mask"][2::4] = 0.0
    batch["text_mask"][3::4] = 0.0
    batch.update(labels=labels, pattern_id=np.zeros(B, np.int32),
                 sample_mask=np.ones(B, np.float32))
    for k in batch:
        if k != "pattern_id":
            batch[k][padded_from:] = 0
    return batch


def _utt_step_on(device, batch):
    from mmtpu_torch.cli import common
    from mmtpu_torch.config.training import TrainingConfig
    from mmtpu_torch.models import build_module
    from mmtpu_torch.ops import lstm_sequence_stacked
    from mmtpu_torch.train import losses
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    model = build_module(
        "utt-fusion",
        netA=build_module("lstmencoder", input_size=5, hidden_size=64),
        netV=build_module("lstmencoder", input_size=20, hidden_size=64),
        netT=build_module("textcnn", input_size=768, embd_size=64, out_channels=128,
                          dropout=0.0),
        netC=build_module("fcclassifier", input_dim=192, layers=[192, 64, 32], output_dim=3,
                          dropout=0.0),
        clip=0.5)
    model = common.init_model(model, 7, device)
    training = TrainingConfig.from_dict({
        "epochs": 1, "num_modalities": 3,
        "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-4}},
        "loss_functions": {"ce": {"loss_name": "cross_entropy"}}})
    state = common.make_state(model, training, clip=model.clip)
    task = ClassificationTask(model=model, loss_group=losses.LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy"}}), input_keys=["audio", "video", "text"])
    before = lstm_sequence_stacked.launches
    out = make_train_step(task, state, device)(batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return float(out["loss"]), grads, lstm_sequence_stacked.launches - before


@pytest.mark.cuda
def test_utt_fusion_train_step_on_card_matches_cpu(cuda_device):
    """One step launches the kernel once (G = 2) on the card; loss and
    per-parameter gradients (after the clip) as on the CPU."""
    batch = _utt_batch()
    loss, grads, launches = _utt_step_on(cuda_device, batch)
    want_loss, want_grads, cpu_launches = _utt_step_on(torch.device("cpu"), batch)
    assert (launches, cpu_launches) == (1, 0)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for n, w in want_grads.items():
        err = (grads[n] - w).abs().max().item()
        assert err <= 1e-4 * max(w.norm().item(), 1e-12), (n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("embd_method", ["last", "maxpool"])
def test_rnn_backend_encoder_on_card_matches_cpu(cuda_device, embd_method):
    """LSTMEncoder(backend='rnn') runs the same kernel on its concatenated
    per-gate weights; with lengths (0 and past T among them) its output and
    the gradients of every per-gate weight as on the CPU."""
    from mmtpu_torch.models import LSTMEncoder, seeded_init

    g = torch.Generator().manual_seed(9)
    x = torch.randn(8, 12, 5, generator=g)
    lengths = torch.tensor([0, 1, 4, 12, 13, 7, 2, 9])
    cot = torch.randn(8, 64, generator=g)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        enc = seeded_init(LSTMEncoder(5, 64, embd_method, backend="rnn"), 3).to(device)
        out = enc(x.to(device), lengths.to(device))
        keep = torch.isfinite(out)
        loss = (torch.where(keep, out, 0.0) * cot.to(device)).sum()
        grads = torch.autograd.grad(loss, list(enc.parameters()))
        results.append((out.detach().cpu(), [gr.cpu() for gr in grads]))
    (out, grads), (want, want_grads) = results
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for got, w in zip(grads, want_grads):
        assert (got - w).abs().max().item() <= 1e-4 * max(w.norm().item(), 1e-12)


def _write_reader_files(root, counts, seed=8):
    """`.pt` spectrograms and images that depend on the class, and one CSV
    per split, in the real AVMNIST reader's format."""
    rng = np.random.default_rng(seed)
    csvs = {}
    for split, n in counts.items():
        lines = ["audio,image,label"]
        for i, label in enumerate(rng.integers(0, 10, size=n)):
            sp, ip = root / f"{split}_spec_{i}.pt", root / f"{split}_img_{i}.pt"
            torch.save(torch.from_numpy((rng.normal(size=(32, 94)) + 0.3 * label)
                                        .astype(np.float32)), sp)
            torch.save(np.clip(rng.normal(20.0 * label + 30, 40, size=(28, 28)), 0, 255)
                       .astype(np.uint8), ip)
            lines.append(f"{sp},{ip},{label}")
        csvs[split] = root / f"{split}.csv"
        csvs[split].write_text("\n".join(lines) + "\n")
    return csvs


@pytest.mark.cuda
def test_reader_fed_full_width_fine_tune_on_card(cuda_device, tmp_path):
    """`train_avmnist` for one epoch at the paper's widths (ResNet18 audio,
    hidden 64; ResNet34 image, hidden 128; head 192→128→64→10), fed by the
    AVMNIST reader from `.pt` files: `fused_mlp` runs once per fused eval
    step of the device-resident path (128 × ai/a/i = 384 rows, factor 3:
    one step per validation and test pass) and in no train forward."""
    import json

    from mmtpu_torch.cli import train_avmnist
    from mmtpu_torch.ops import fused_mlp

    counts = {"train": 256, "validation": 128, "test": 128}
    csvs = _write_reader_files(tmp_path, counts)
    patterns = {"modalities": {"audio": {"missing_rate": 0.0}, "image": {"missing_rate": 0.0}}}

    def split(name, selected):
        return {"dataset": "AVMNIST", "data_fp": str(csvs[name]),
                "split": {"validation": "valid"}.get(name, name), "batch_size": 128,
                "shuffle": name == "train",
                "missing_patterns": {**patterns, "selected_patterns": selected}}

    out = tmp_path / "out"
    cfg = {
        "experiment": {"name": "Reader_Card", "seed": 42},
        "model": {"name": "AVMNIST_Resnet", "model_type": "AVMNIST",
                  "audio_encoder": {"__module_spec__": "resnet18", "hidden_dim": 64},
                  "image_encoder": {"__module_spec__": "resnet34", "hidden_dim": 128},
                  "hidden_dim": 128, "dropout": 0.5},
        "training": {"epochs": 1, "num_modalities": 2,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.0005}},
                     "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy"}}},
        "data": {"datasets": {"train": split("train", ["ai"]),
                              "validation": split("validation", ["ai", "a", "i"]),
                              "test": split("test", ["ai", "a", "i"])}},
        "metrics": {"metrics": {"accuracy": {"function": "sklearn.metrics.accuracy_score"}},
                    "groups": {"classification": ["accuracy"]}},
        "logging": {"log_path": f"{out}/logs", "model_output_path": f"{out}/models",
                    "metrics_path": f"{out}/metrics"},
    }
    path = tmp_path / "reader_card.json"
    path.write_text(json.dumps(cfg))
    fused_mlp.launches = 0
    assert train_avmnist.main(["--config", str(path), "--run_id", "1"]) == 0
    assert fused_mlp.launches == 1 + 1  # 1 epoch × 1 validation + 1 test fused step
    test = json.loads((out / "metrics/test_metrics.json").read_text())[0]
    assert all(np.isfinite(test[k]) for k in ("loss", "accuracy_AI", "accuracy_A", "accuracy_I"))


@pytest.mark.cuda
def test_stacked_kernels_launch_once_per_call_on_card(cuda_device):
    """On the card a stacked UttFusion forward launches `lstm` once for the
    K·G groups (K = 5, G = 2: ten groups, beyond the old limit of eight) and
    a stacked AVMNIST head `fused_mlp` once for both members, each against
    the members run one by one."""
    import importlib

    from mmtpu_torch.ops import fused_mlp, lstm_sequence_stacked

    ops_lstm = importlib.import_module("mmtpu_torch.ops.lstm")
    ops_mlp = importlib.import_module("mmtpu_torch.ops.fused_mlp")

    g = torch.Generator().manual_seed(0)
    Km, B, T, H = 5, 32, 50, 64
    xw = [torch.randn(Km, B, T, 4 * H, generator=g).to(cuda_device) for _ in range(2)]
    wh = [(0.1 * torch.randn(Km, H, 4 * H, generator=g)).to(cuda_device) for _ in range(2)]
    before = lstm_sequence_stacked.launches
    with torch.no_grad():
        out, (h, _) = torch.func.vmap(lambda a, b, c, d: lstm_sequence_stacked([a, b], [c, d]))(
            *xw, *wh)
    assert lstm_sequence_stacked.launches == before + 1
    for k in range(Km):
        want, _ = ops_lstm.lstm_stacked_reference([t[k] for t in xw], [t[k] for t in wh])
        torch.testing.assert_close(out[k], want, rtol=1e-5, atol=1e-5)
    dims = (192, 128, 64, 10)
    x = torch.randn(2, 1024, 192, generator=g).to(cuda_device)
    ws = [(torch.randn(2, o, i, generator=g) / i ** 0.5).to(cuda_device)
          for i, o in zip(dims, dims[1:])]
    bs = [(0.1 * torch.randn(2, o, generator=g)).to(cuda_device) for o in dims[1:]]
    before = fused_mlp.launches
    with torch.no_grad():
        got = torch.func.vmap(lambda x, *p: fused_mlp(x, p[:3], p[3:]))(x, *ws, *bs)
    assert fused_mlp.launches == before + 1
    want = ops_mlp.fused_mlp_members_reference(x, ws, bs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
